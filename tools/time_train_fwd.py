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
PROBES = {1: "no products", 2: "no gate", 4: "no residual stores",
          8: "no gather / head loads", 15: "none of those"}
CLOCKS = 32  # the FW_PROBE bit that clocks each block's phases
PHASES = ("ring set-up", "latent / head rows", "products", "epilogue", "stores", "final rows")
LIBS = {"K2": "train_decoder", "K4": "pixel_train_decoder", "K5": "generic_train_decoder"}
CLOCKED = 3  # forward calls the phase clocks sum


def bounds(flops: float) -> str:
    return (f"split-TF32 bound {3 * flops / TF32_PEAK_FLOPS * 1e3:.2f} ms, float32 bound "
            f"{flops / FP32_PEAK_FLOPS * 1e3:.2f} ms")


def setups(cs, scenes: int, dev):
    """{"K2": (one step's forwards, its packs, FLOPs), "K4": ..., "K5": ...}:
    FLOPs 2 a multiply-add at the true widths (K4: and the 16 taps x C of
    each point in the image)."""
    import torch

    from alignsdf_torch.kernels.generic_train_decoder import (
        generic_train_decode_forward, pack_generic_trunk)
    from alignsdf_torch.kernels.pixel_train_decoder import (
        pack_pixel_trunks, pixel_train_decode_forward)
    from alignsdf_torch.kernels.train_decoder import pack_trunk, train_decode_forward
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder
    from alignsdf_torch.ops.train_plan import make_train_decoder

    gen = torch.Generator().manual_seed(cs.SEED)
    specs = cs.flagship_specs()
    model = build_model(specs, device=dev, seed=cs.SEED)
    st = make_train_decoder(specs).statics
    m = scenes * specs.samples_per_scene
    latent = (torch.randn(scenes, specs.latent_size, generator=gen) * 0.5).to(dev)
    emb = (torch.randn(m, specs.point_feat_size, generator=gen) * 0.5).to(dev)
    trunks = cs.k2_operands(model, specs, latent, emb)
    packs = [pack_trunk(e, ws, xs, bs, st) for _, _, e, ws, xs, bs in trunks]
    k2_flops = sum(2 * m * t.numel() for *_, ws, xs, _ in trunks for t in [*ws, *xs]
                   if t is not None)

    def k2_fwd():
        for p, t in zip(packs, trunks):
            train_decode_forward(p, t[1], st)

    def k2_pack():
        for _, _, e, ws, xs, bs in trunks:
            pack_trunk(e, ws, xs, bs, st)

    pspecs = cs.flagship_specs(pixel=True)
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

    gspecs = cs.latent_in_0_specs()
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

    return {"K2": (k2_fwd, k2_pack, k2_flops), "K4": (k4_fwd, k4_pack, k4_flops),
            "K5": (k5_fwd, k5_pack, k5_flops)}


def build_probes(masks):
    """Build the train decoders' sources (LIBS) with -DFW_PROBE=mask for
    each mask, concurrently: {mask: {name: library path}}."""
    from alignsdf_torch.kernels import build

    out_dir = os.path.join(build.BUILD_DIR, "fw_probes")
    os.makedirs(out_dir, exist_ok=True)
    procs, paths = [], {}
    for mask in masks:
        for name in LIBS.values():
            path = os.path.join(out_dir, f"lib{name}-fwprobe{mask}.so")
            paths.setdefault(mask, {})[name] = path
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DFW_PROBE={mask}", "-o", path,
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
    for name, (fwd, _, _) in runs.items():
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=REPO, help="the checkout whose package to time")
    parser.add_argument("--probes", action="store_true", help="also time the FW_PROBE copies")
    parser.add_argument("--steps", type=int, default=0, help="also time this many train steps")
    parser.add_argument("--scenes", type=int, default=64)
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
    runs = setups(cs, args.scenes, dev)
    print(f"operands and packs: {time.perf_counter() - t0:.1f} s", flush=True)

    def report(tag, packs=True):
        for name, (fwd, pack, flops) in runs.items():
            ms = [cs.cuda_ms(fwd, 5) for _ in range(2)]
            pack_ms = f", pack {cs.cuda_ms(pack, 5):.3f} ms" if packs else ""
            print(f"[{card}] {label} {tag} {name}: forward {ms[0]:.3f} / {ms[1]:.3f} ms a step "
                  f"({flops / 1e12:.3f} TFLOP, {flops / min(ms) / 1e9:.1f} TFLOP/s; "
                  f"{bounds(flops)}){pack_ms}", flush=True)

    report("full")
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
