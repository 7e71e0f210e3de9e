"""Time the train forwards of kernels K2, K4 and K5 on a CUDA card, per
train step at the flagship widths over 64 scenes x 2000 points (K5: the
flagship with latent_in (0, 2) on materialized rows): each forward's device
time (CUDA events over a few calls; a forward call launches its kernel and
nothing else), beside its split-TF32 and float32 bounds, and the time of
the pack that precedes it every step (pack_trunk / pack_pixel_trunks /
pack_generic_trunk: the padded copies and the weight tiles split and
tiled).  With --probes, the same for copies of the kernels built without
parts of the forward (csrc/train_fwd_tc.cuh's FW_PROBE: the products, the
gate, the residuals' stores, K4's gather and K5's head rows), to time its
phases apart, and for a copy that clocks each block's phases on its thread
0 (FW_PROBE 32): each phase's share of the blocks' cycles.

    python3 tools/time_train_fwd.py [--repo DIR] [--probes] [--steps N] [--scenes 64]
    python3 tools/time_train_fwd.py --bf16 [--repo DIR] [--probes] [--scenes 64]

--bf16 times the three forwards on bf16 packs instead (the specs with
ComputeDtype bfloat16, as cli.train --bf16 trains them): K2's on its own
design (csrc/train_fwd_bf16_tc.cuh; an older package's TcBf16 route of
csrc/train_fwd_tc.cuh), K4's and K5's on train_fwd_tc.cuh's TcBf16 route,
beside K2's bf16 bounds (its bytes, k2_work's with 2-byte residuals, at
3.35 TB/s and its FLOPs at bf16's dense 989.4 TFLOP/s) and, where the
package plans it (train_fwd_bf16_plan), the tile bytes its clusters read
from L2 (modelled, not measured).  With --probes it builds copies of
train_decoder.cu: one with clusters of 4 (-DFB_CLUSTER=4, each tile read
from L2 for 256 points), timed in turn with the package's clusters of 2
(2, 4, 4, 2); copies without parts of K2's bf16 forward (the FW_PROBE bits
of BF16_PROBES); and one with FW_PROBE 32, to print each phase's share of warpgroup 0's cycles in K2's bf16 forward
(set-up, products with their ring waits, epilogue slices, waits for a
group to be ready, waits for rows to drain, final rows), and the first
producer's waits for a free slot and the store thread's waits for the
stores' reads against the same cycles.

--repo times the package of another checkout (for example a parent commit
unpacked with git archive into a directory .gitignore lists) inside this
script, so a parent's and this checkout's forwards are timed in one call
by running the script once for each.  --steps N also times N train
steps of the flagship, of --pa_feat and of latent_in (0, 2)
(tools/time_train_chain.py's
train_steps: the host clock a step, the device's busy time and idle share
over 2 profiled steps).  Operands are chip_smoke.py's (K2: seeded latents
and embeddings on the flagship's trunks; K4: the encoder's HeadNet map and
projection of a synthetic batch; K5: rows of seeded latents and
embeddings), on weights from seed 0.  Each line is
printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF32_PEAK_FLOPS, FP32_PEAK_FLOPS = 494.7e12, 67e12  # H100 SXM dense TF32, float32 (data sheet)
HBM_BYTES, BF16_PEAK_FLOPS = 3.35e12, 989.4e12  # H100 SXM (data sheet)
BF16_PHASES = ("set-up", "products", "epilogue slices", "ready waits", "drain waits",
               "final rows")
BF16_WAITS = ("producer's slot waits", "store thread's read waits")
BF16_PROBES = {1: "no products' wgmma", 2: "no gate", 8: "no bias / final-weight loads",
               64: "no buffer writes", 128: "no epilogue slices",
               129: "neither products nor slices"}
# K2's bf16 forward built with clusters of 4 (each tile read from L2 for
# 256 points) instead of the package's 2, timed beside it
BF16_CLUSTER4 = ("-DFB_CLUSTER=4",)
PROBES = {1: "no products", 2: "no gate", 4: "no residual stores",
          8: "no gather / head loads", 15: "none of those"}
CLOCKS = 32  # the FW_PROBE bit that clocks each block's phases
PHASES = ("ring set-up", "latent / head rows", "products", "epilogue", "stores", "final rows")
LIBS = {"K2": "train_decoder", "K4": "pixel_train_decoder", "K5": "generic_train_decoder"}
CLOCKED = 3  # forward calls the phase clocks sum


def bounds(flops: float) -> str:
    return (f"split-TF32 bound {3 * flops / TF32_PEAK_FLOPS * 1e3:.2f} ms, float32 bound "
            f"{flops / FP32_PEAK_FLOPS * 1e3:.2f} ms")


def setups(cs, scenes: int, dev, bf16: bool = False):
    """{"K2": (one step's forwards, its packs, FLOPs), "K4": ..., "K5": ...}:
    FLOPs 2 a multiply-add at the true widths (K4: and the 16 taps x C of
    each point in the image); with ``bf16``, on bf16 packs, and K2's entry
    also carries (its bytes, k2_work's with 2-byte residuals; its plan's
    tile bytes from L2, or None where the package has no
    train_fwd_bf16_plan)."""
    import dataclasses

    import torch

    from alignsdf_torch.kernels.generic_train_decoder import (
        generic_train_decode_forward, pack_generic_trunk)
    from alignsdf_torch.kernels.pixel_train_decoder import (
        pack_pixel_trunks, pixel_train_decode_forward)
    from alignsdf_torch.kernels.train_decoder import pack_trunk, train_decode_forward
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder
    from alignsdf_torch.ops.train_plan import make_train_decoder

    bf = ((lambda sp: dataclasses.replace(sp, compute_dtype="bfloat16")) if bf16
          else (lambda sp: sp))
    gen = torch.Generator().manual_seed(cs.SEED)
    specs = cs.flagship_specs()
    model = build_model(specs, device=dev, seed=cs.SEED)
    st = make_train_decoder(bf(specs)).statics
    m = scenes * specs.samples_per_scene
    latent = (torch.randn(scenes, specs.latent_size, generator=gen) * 0.5).to(dev)
    emb = (torch.randn(m, specs.point_feat_size, generator=gen) * 0.5).to(dev)
    trunks = cs.k2_operands(model, bf(specs), latent, emb)
    packs = [pack_trunk(e, ws, xs, bs, st) for _, _, e, ws, xs, bs in trunks]
    k2_flops = sum(2 * m * t.numel() for *_, ws, xs, _ in trunks for t in [*ws, *xs]
                   if t is not None)
    k2_extra = ()
    if bf16:
        import alignsdf_torch.kernels.train_decoder as td

        k2_bytes = sum(cs.k2_work(ws, xs, bs, m, e.shape[1], p.out_pads, 2)[2]
                       for (_, _, e, ws, xs, bs), p in zip(trunks, packs))
        l2 = (sum(td.train_fwd_bf16_plan(p.out_pads, e.shape[1], m, st.n_per_scene,
                                         st.scene_bias, [x is not None for x in p.x])
                  ["l2_tile_bytes"] for (_, _, e, *_), p in zip(trunks, packs))
              if hasattr(td, "train_fwd_bf16_plan") else None)
        k2_extra = (k2_bytes, l2)

    def k2_fwd():
        for p, t in zip(packs, trunks):
            train_decode_forward(p, t[1], st)

    def k2_pack():
        for _, _, e, ws, xs, bs in trunks:
            pack_trunk(e, ws, xs, bs, st)

    pspecs = bf(cs.flagship_specs(pixel=True))
    pmodel = build_model(pspecs, device=dev, seed=cs.SEED)
    inputs, ptrunks, pst, _ = cs.k4_operands(pmodel, pspecs, dev, scenes)
    packed = pack_pixel_trunks(*inputs, ptrunks, pst)
    c, mask = inputs[0].shape[2], inputs[4]
    k4_flops = (sum(2 * m * t.numel() for ws, lats, xs, _ in ptrunks for t in [*ws, *lats, *xs]
                    if t is not None) + 2 * 16 * c * int(mask.sum()))

    def k4_fwd():
        pixel_train_decode_forward(packed, 7, pst)

    def k4_pack():
        pack_pixel_trunks(*inputs, ptrunks, pst)

    gspecs = bf(cs.latent_in_0_specs())
    gmodel = build_model(gspecs, device=dev, seed=cs.SEED)
    gst = make_generic_train_decoder(gspecs).statics
    gtrunks = cs.k5_operands(gmodel, gspecs, cs.k5_rows(gspecs, dev, gen, scenes))
    gpacks = [pack_generic_trunk(x0, ws, xs, bs, gst) for _, _, x0, ws, xs, bs in gtrunks]
    k5_flops = sum(2 * m * t.numel() for *_, ws, xs, _ in gtrunks for t in [*ws, *xs]
                   if t is not None)

    def k5_fwd():
        for p, t in zip(gpacks, gtrunks):
            generic_train_decode_forward(p, t[1], gst)

    def k5_pack():
        for _, _, x0, ws, xs, bs in gtrunks:
            pack_generic_trunk(x0, ws, xs, bs, gst)

    return {"K2": (k2_fwd, k2_pack, k2_flops, *k2_extra), "K4": (k4_fwd, k4_pack, k4_flops),
            "K5": (k5_fwd, k5_pack, k5_flops)}


def build_probes(masks, names=tuple(LIBS.values()), variants=None):
    """Build the train decoders' sources ``names`` with -DFW_PROBE=mask for
    each mask, and with the flags of each entry of ``variants`` ({key:
    flags}), concurrently: {mask or key: {name: library path}}."""
    from alignsdf_torch.kernels import build

    out_dir = os.path.join(build.BUILD_DIR, "fw_probes")
    os.makedirs(out_dir, exist_ok=True)
    procs, paths = [], {}
    builds = {mask: (f"-DFW_PROBE={mask}",) for mask in masks}
    builds.update(variants or {})
    for key, flags in builds.items():
        for name in names:
            path = os.path.join(out_dir, f"lib{name}-fwprobe{key}.so")
            paths.setdefault(key, {})[name] = path
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", path,
                   os.path.join(build.CSRC, f"{name}.cu")]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), cmd))
    for proc, cmd in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    return paths


def use_libs(paths) -> dict:
    """Load the libraries at ``paths`` ({name: path}) in place of the
    package's: the wrappers' next launches run them."""
    from alignsdf_torch.kernels import build

    libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
    for name, lib in libs.items():
        build._loaded[name] = lib
    return libs


def phase_shares(runs, paths) -> None:
    """Each forward's phases as shares of its blocks' clocked cycles, from
    the FW_PROBE 32 copies."""
    import torch

    libs = use_libs(paths)
    for lib in libs.values():
        lib.fw_read_cycles.restype = ctypes.c_int
        lib.fw_read_cycles.argtypes = [ctypes.c_void_p]
    for name, (fwd, *_) in runs.items():
        lib = libs[LIBS[name]]
        fwd()
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * len(PHASES))()
        lib.fw_read_cycles(cycles)  # drops the warm-up's
        for _ in range(CLOCKED):
            fwd()
        torch.cuda.synchronize()
        if lib.fw_read_cycles(cycles) != 0:
            raise RuntimeError("reading the phase clocks failed")
        total = sum(cycles)
        print(f"{name} forward phases (shares of the blocks' cycles on thread 0): "
              + ", ".join(f"{ph} {c / total:.3f}" for ph, c in zip(PHASES, cycles) if c),
              flush=True)


def bf16_phase_shares(cs, runs, card: str, label: str) -> None:
    """K2's bf16 forward's phases from a copy of train_decoder.cu built with
    FW_PROBE 32: each phase's share of warpgroup 0's clocked cycles (thread
    0 of every block), and the producer's and store thread's waits against
    the same cycles."""
    import torch

    from alignsdf_torch.kernels import build

    paths = build_probes([*BF16_PROBES, CLOCKS], names=(LIBS["K2"],),
                         variants={"cluster4": BF16_CLUSTER4})
    fwd = runs["K2"][0]
    own = build.load(LIBS["K2"])
    cluster4 = ctypes.CDLL(paths["cluster4"][LIBS["K2"]])
    for what, lib in (("clusters of 2", own), ("clusters of 4", cluster4),
                      ("clusters of 4", cluster4), ("clusters of 2", own)):
        build._loaded[LIBS["K2"]] = lib
        ms = [cs.cuda_ms(fwd, 5) for _ in range(2)]
        print(f"[{card}] {label} {what} K2 bf16: forward {ms[0]:.3f} / {ms[1]:.3f} ms a step",
              flush=True)
    for mask, what in BF16_PROBES.items():
        build._loaded[LIBS["K2"]] = ctypes.CDLL(paths[mask][LIBS["K2"]])
        ms = [cs.cuda_ms(fwd, 5) for _ in range(2)]
        print(f"[{card}] {label} probe {mask} ({what}) K2 bf16: forward {ms[0]:.3f} / {ms[1]:.3f} "
              "ms a step", flush=True)
    path = paths[CLOCKS][LIBS["K2"]]
    lib = ctypes.CDLL(path)
    build._loaded[LIBS["K2"]] = lib
    lib.fb_read_cycles.restype = ctypes.c_int
    lib.fb_read_cycles.argtypes = [ctypes.c_void_p]
    cycles = (ctypes.c_ulonglong * (len(BF16_PHASES) + len(BF16_WAITS)))()
    fwd()
    torch.cuda.synchronize()
    lib.fb_read_cycles(cycles)  # drops the warm-up's
    for _ in range(CLOCKED):
        fwd()
    torch.cuda.synchronize()
    if lib.fb_read_cycles(cycles) != 0:
        raise RuntimeError("reading the phase clocks failed")
    total = sum(cycles[:len(BF16_PHASES)])
    clocked = cs.cuda_ms(fwd, 3)
    print(f"[{card}] {label} K2 bf16 forward phases (shares of warpgroup 0's cycles on thread 0 "
          f"of every block; the clocked copy's forward {clocked:.3f} ms): "
          + ", ".join(f"{ph} {c / total:.3f}" for ph, c in zip(BF16_PHASES, cycles))
          + "; against the same cycles: "
          + ", ".join(f"{ph} {c / total:.3f}"
                      for ph, c in zip(BF16_WAITS, cycles[len(BF16_PHASES):])), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=REPO, help="the checkout whose package to time")
    parser.add_argument("--probes", action="store_true", help="also time the FW_PROBE copies")
    parser.add_argument("--steps", type=int, default=0, help="also time this many train steps")
    parser.add_argument("--scenes", type=int, default=64)
    parser.add_argument("--bf16", action="store_true",
                        help="the forwards on bf16 packs (K2's own bf16 design)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from alignsdf_torch import use_float32_precision

    use_float32_precision()
    card = cs.card_line()
    label = os.path.relpath(os.path.abspath(args.repo), REPO)
    print(f"card: {card}; package: {label}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    runs = setups(cs, args.scenes, dev, args.bf16)
    print(f"operands and packs: {time.perf_counter() - t0:.1f} s", flush=True)

    def report(tag, packs=True):
        for name, (fwd, pack, flops, *extra) in runs.items():
            ms = [cs.cuda_ms(fwd, 5) for _ in range(2)]
            pack_ms = f", pack {cs.cuda_ms(pack, 5):.3f} ms" if packs else ""
            if not args.bf16:
                bound = bounds(flops)
            elif extra:
                nbytes, l2 = extra
                bound = (f"bf16 bounds: bytes {nbytes / 1e9:.3f} GB {nbytes / HBM_BYTES * 1e3:.3f} "
                         f"ms, FLOPs {flops / BF16_PEAK_FLOPS * 1e3:.3f} ms; tiles from L2 "
                         + ("not planned" if l2 is None else f"{l2 / 1e9:.3f} GB by the plan"))
            else:
                bound = f"bf16 FLOPs bound {flops / BF16_PEAK_FLOPS * 1e3:.3f} ms"
            dt = " bf16" if args.bf16 else ""
            print(f"[{card}] {label} {tag} {name}{dt}: forward {ms[0]:.3f} / {ms[1]:.3f} ms a step "
                  f"({flops / 1e12:.3f} TFLOP, {flops / min(ms) / 1e9:.1f} TFLOP/s; "
                  f"{bound}){pack_ms}", flush=True)

    report("full")
    if args.bf16:
        if args.probes:
            bf16_phase_shares(cs, runs, card, label)
        return
    if args.steps:
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from time_train_chain import train_steps

        del runs
        torch.cuda.empty_cache()
        train_steps(cs, dev, args.steps, card, label)
        return
    if args.probes:
        paths = build_probes([*PROBES, CLOCKS])
        for mask, what in PROBES.items():
            use_libs(paths[mask])
            report(f"probe {mask} ({what})", packs=False)
        phase_shares(runs, paths[CLOCKS])


if __name__ == "__main__":
    main()
