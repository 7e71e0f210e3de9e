"""Time the train backwards' reverse chains of kernels K2, K4 and K5 on a
CUDA card, per train step at the flagship widths over 64 scenes x 2000
points (K5: the flagship with latent_in (0, 2) on materialized rows): each
chain kernel's device time (torch.profiler over a few backward calls) and
the whole backward's (CUDA events), beside the chain's split-TF32 and
float32 bounds.  With --probes, the same for copies of the kernels built
without parts of the chain (csrc/chain_tc.cuh's CH_PROBE: the products,
the gate and dlat passes (K5: its head's d(x0) rows), d(emb) (K5: the
tail's), K4's tap stage), to time its phases apart, and for a copy that
clocks each block's phases on its thread 0 (CH_PROBE 32): each phase's
share of the blocks' cycles.

    python3 tools/time_train_chain.py [--repo DIR] [--probes] [--steps N] [--scenes 64]
    python3 tools/time_train_chain.py --band [--probes] [--scenes 64]

--band times K4's backward three ways, in float32 and bf16 (the --pa_feat
flagship, the band cli.train --pixel_band gives it): the unsorted batch and
the batch sorted by feature row on the host (data/pixel_sort.py, as the
loader sorts it) on the per-tap route, and the sorted batch on the banded
tap stage; with --probes also each way's tap stage alone: the chain without
it (CH_PROBE 8) and the taps' share of the clocked copy's cycles (CH_PROBE
32) times the chain's time.

--steps N also times N train steps of the flagship, of --pa_feat and of
latent_in (0, 2) through cli/train.make_trainer (after 2 warm-up steps, on one synthetic
batch, as chip_smoke.py's train phases run them): the host clock a step,
and the device's busy time and idle share over 2 steps under the profiler.

--repo times the package of another checkout (for example a parent commit
unpacked with git archive into a directory .gitignore lists) inside this
script: the kernel names it profiles are prefixes that every version of the
chains shares.  Operands are chip_smoke.py's (K2: seeded latents and
embeddings on the flagship's trunks; K4: the encoder's HeadNet map and
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
PROBES = {1: "no products", 2: "no gate / dlat passes", 4: "no d(emb)", 8: "no tap stage",
          15: "none of those", 64: "gates without loads", 128: "gates without stores"}
CLOCKS = 32  # the CH_PROBE bit that clocks each block's phases
PHASES = ("ring set-up", "final rows", "gates", "products", "d(emb)", "stores", "dlat", "taps")
LIBS = {"K2": "train_decoder", "K4": "pixel_train_decoder", "K5": "generic_train_decoder"}
PROFILED = 3


def bounds(flops: float) -> str:
    return (f"split-TF32 bound {3 * flops / TF32_PEAK_FLOPS * 1e3:.2f} ms, float32 bound "
            f"{flops / FP32_PEAK_FLOPS * 1e3:.2f} ms")


def chain_ms(bwd, prefix: str) -> float:
    """Device ms per call of the kernels whose names start with prefix."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            bwd()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and e.name.removeprefix("void ").startswith(prefix))  # a template's return type
    return us / 1e3 / PROFILED


def setups(cs, scenes: int, dev):
    """{"K2": (backward of one step, chain kernel prefix, chain FLOPs), "K4": ...,
    "K5": ...}."""
    import torch

    from alignsdf_torch.kernels.generic_train_decoder import (
        generic_train_decode_backward, generic_train_decode_forward, pack_generic_trunk)
    from alignsdf_torch.kernels.pixel_train_decoder import (
        pack_pixel_trunks, pixel_train_decode_backward, pixel_train_decode_forward)
    from alignsdf_torch.kernels.train_decoder import (
        pack_trunk, train_decode_backward, train_decode_forward)
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
    outs = [train_decode_forward(p, t[1], st) for p, t in zip(packs, trunks)]
    dys = [torch.randn(tuple(y.shape), generator=gen).to(dev) for y, _ in outs]
    k2_flops = sum(2 * m * t.numel() for *_, ws, xs, _ in trunks for t in [*ws, *xs]
                   if t is not None)

    def k2_bwd():
        for p, (y, acts), dy in zip(packs, outs, dys):
            train_decode_backward(p, st, y, acts, dy)

    pspecs = cs.flagship_specs(pixel=True)
    pmodel = build_model(pspecs, device=dev, seed=cs.SEED)
    inputs, ptrunks, pst, _ = cs.k4_operands(pmodel, pspecs, dev, scenes)
    packed = pack_pixel_trunks(*inputs, ptrunks, pst)
    y, acts, lat = pixel_train_decode_forward(packed, 7, pst)
    dy = torch.randn(tuple(y.shape), generator=gen).to(dev)
    c, mask = inputs[0].shape[2], inputs[4]
    k4_flops = (sum(2 * m * t.numel() for ws, lats, xs, _ in ptrunks for t in [*ws, *lats, *xs]
                    if t is not None) + 2 * 2 * 16 * c * int(mask.sum()))

    def k4_bwd():
        pixel_train_decode_backward(packed, pst, y, acts, lat, dy)

    gspecs = cs.latent_in_0_specs()
    gmodel = build_model(gspecs, device=dev, seed=cs.SEED)
    gst = make_generic_train_decoder(gspecs).statics
    gtrunks = cs.k5_operands(gmodel, gspecs, cs.k5_rows(gspecs, dev, gen, scenes))
    gpacks = [pack_generic_trunk(x0, ws, xs, bs, gst) for _, _, x0, ws, xs, bs in gtrunks]
    gouts = [generic_train_decode_forward(p, t[1], gst) for p, t in zip(gpacks, gtrunks)]
    gdys = [torch.randn(tuple(gy.shape), generator=gen).to(dev) for gy, _ in gouts]
    k5_flops = sum(2 * m * t.numel() for *_, ws, xs, _ in gtrunks for t in [*ws, *xs]
                   if t is not None)

    def k5_bwd():
        for p, (gy, gacts), gdy in zip(gpacks, gouts, gdys):
            generic_train_decode_backward(p, gst, gy, gacts, gdy)

    return {"K2": (k2_bwd, "train_bwd_chain", k2_flops),
            "K4": (k4_bwd, "pixel_train_bwd_chain", k4_flops),
            "K5": (k5_bwd, "generic_train_bwd_chain", k5_flops)}


def band_setups(cs, scenes: int, dev):
    """{"K4 <dtype>, <way>": (backward of one step, chain kernel prefix,
    chain FLOPs)}: K4's backward on the --pa_feat flagship's operands (the
    HeadNet map and projection of a synthetic batch), the batch unsorted or
    sorted on the host, the tap stage per tap or banded (cli.train
    --pixel_band's band), in float32 and bf16; and the host-sorted batch's
    share of tiles that fit, printed."""
    import dataclasses

    import torch

    from alignsdf_torch.kernels.pixel_train_decoder import (
        pack_pixel_trunks, pixel_train_decode_backward, pixel_train_decode_forward)
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.ops.pixel_train_plan import default_band

    gen = torch.Generator().manual_seed(cs.SEED)
    pix = cs.flagship_specs(pixel=True)
    runs = {}
    for sp in (pix, dataclasses.replace(pix, compute_dtype="bfloat16")):
        model = build_model(sp, device=dev, seed=cs.SEED)
        band = default_band(sp)
        plain_in, trunks, st, _ = cs.k4_operands(model, sp, dev, scenes)
        sorted_in, _, _, _ = cs.k4_operands(model, sp, dev, scenes, host_sort=True)
        fits = cs.fit_share(sorted_in, sp.samples_per_scene, sp.image_size[0] // 4, band)
        print(f"K4 {sp.compute_dtype}: band {band}; the host-sorted batch at the predicted root: "
              f"{fits['tile_share']:.4f} of {fits['tiles']} tiles fit, "
              f"{fits['segment_share']:.4f} of their live segments", flush=True)
        c, mask = sorted_in[0].shape[2], sorted_in[4]
        flops = (sum(2 * mask.numel() * t.numel() for ws, lats, xs, _ in trunks
                     for t in [*ws, *lats, *xs] if t is not None)
                 + 2 * 2 * 16 * c * int(mask.sum()))
        for way, ops, b in (("unsorted, per-tap", plain_in, None),
                            ("host-sorted, per-tap", sorted_in, None),
                            ("host-sorted, banded", sorted_in, band)):
            packed = pack_pixel_trunks(*ops, trunks, st)
            y, acts, lat = pixel_train_decode_forward(packed, 7, st)
            dy = torch.randn(tuple(y.shape), generator=gen).to(dev)
            runs[f"K4 {sp.compute_dtype}, {way}"] = (
                lambda p=packed, y=y, a=acts, la=lat, d=dy, s=st._replace(band=b):
                pixel_train_decode_backward(p, s, y, a, la, d),
                "pixel_train_bwd_chain", flops)
        del model
    return runs


def train_steps(cs, dev, steps: int, card: str, label: str) -> None:
    """The flagship's, --pa_feat's and latent_in (0, 2)'s train step: host ms
    a step over ``steps`` steps, device busy ms and idle share over 2
    profiled steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignsdf_torch.cli.train import make_trainer
    from alignsdf_torch.data.synthetic import synthetic_train_batch
    from alignsdf_torch.training.train_step import batch_to_device, draw_seed

    for name, specs in (("flagship", cs.flagship_specs()),
                        ("--pa_feat", cs.flagship_specs(pixel=True)),
                        ("latent_in (0, 2)", cs.latent_in_0_specs())):
        state, step = make_trainer(specs, dev, seed=cs.SEED, init_guard=True)
        batch = batch_to_device(synthetic_train_batch(specs, cs.TRAIN_SCENES, seed=cs.SEED), dev)
        gen = torch.Generator().manual_seed(cs.SEED)
        for _ in range(2):
            step(state, batch, draw_seed(gen))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, draw_seed(gen))
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                step(state, batch, draw_seed(gen))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, share, _ = cs.profile_summary(prof, wall)
        print(f"[{card}] {label} {name} train step: "
              f"{host_ms:.2f} ms on the host clock over {steps} steps; profiled: device busy "
              f"{busy / 2:.2f} ms a step, idle share {1 - share:.3f}", flush=True)
        del state, step, batch


def build_probes(masks, libs=tuple(LIBS.values())):
    """Build the train decoders' sources (``libs``, LIBS' by default) with
    -DCH_PROBE=mask for each mask, concurrently: {mask: {name: library
    path}}."""
    from alignsdf_torch.kernels import build

    out_dir = os.path.join(build.BUILD_DIR, "probes")
    os.makedirs(out_dir, exist_ok=True)
    procs, paths = [], {}
    for mask in masks:
        for name in libs:
            path = os.path.join(out_dir, f"lib{name}-probe{mask}.so")
            paths.setdefault(mask, {})[name] = path
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DCH_PROBE={mask}", "-o", path,
                   os.path.join(build.CSRC, f"{name}.cu")]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), cmd))
    for proc, cmd in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    return paths


def phase_shares(runs, paths) -> dict:
    """Each chain's phases as shares of its blocks' clocked cycles, from the
    CH_PROBE 32 copies (the library of each kernel in ``paths``; a run's
    kernel is its name's first word): {run: {phase: share}}."""
    import torch

    from alignsdf_torch.kernels import build

    libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
    for name, lib in libs.items():
        build._loaded[name] = lib
        lib.ch_read_cycles.restype = ctypes.c_int
        lib.ch_read_cycles.argtypes = [ctypes.c_void_p]
    shares = {}
    for name, (bwd, _, _) in runs.items():
        lib = libs[LIBS[name.split()[0].rstrip(",")]]
        bwd()
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * len(PHASES))()
        lib.ch_read_cycles(cycles)  # drops the warm-up's
        for _ in range(PROFILED):
            bwd()
        torch.cuda.synchronize()
        if lib.ch_read_cycles(cycles) != 0:
            raise RuntimeError("reading the phase clocks failed")
        total = sum(cycles)
        shares[name] = {ph: c / total for ph, c in zip(PHASES, cycles)}
        print(f"{name} phases (shares of the blocks' cycles on thread 0): "
              + ", ".join(f"{ph} {c / total:.3f}" for ph, c in zip(PHASES, cycles) if c),
              flush=True)
    return shares


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=REPO, help="the checkout whose package to time")
    parser.add_argument("--probes", action="store_true", help="also time the CH_PROBE copies")
    parser.add_argument("--steps", type=int, default=0, help="also time this many train steps")
    parser.add_argument("--scenes", type=int, default=64)
    parser.add_argument("--band", action="store_true",
                        help="K4's backward three ways (unsorted / host-sorted, per-tap / banded)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from alignsdf_torch import use_float32_precision
    from alignsdf_torch.kernels import build

    use_float32_precision()
    card = cs.card_line()
    label = os.path.relpath(os.path.abspath(args.repo), REPO)
    print(f"card: {card}; package: {label}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    runs = (band_setups if args.band else setups)(cs, args.scenes, dev)
    print(f"operands and forwards: {time.perf_counter() - t0:.1f} s", flush=True)

    def report(tag):
        out = {}
        for name, (bwd, prefix, flops) in runs.items():
            ms = out[name] = chain_ms(bwd, prefix)
            bwd_ms = cs.cuda_ms(bwd, 5)
            print(f"[{card}] {label} {tag} {name}: chain {ms:.3f} ms a step "
                  f"({flops / 1e12:.3f} TFLOP, {flops / ms / 1e9:.1f} TFLOP/s; {bounds(flops)}), "
                  f"backward {bwd_ms:.3f} ms", flush=True)
        return out

    full = report("full")
    if args.band:
        if args.probes:
            paths = build_probes([8, CLOCKS], libs=(LIBS["K4"],))
            build._loaded[LIBS["K4"]] = ctypes.CDLL(paths[8][LIBS["K4"]])
            bare = report("probe 8 (no tap stage)")
            shares = phase_shares(runs, paths[CLOCKS])
            for name in runs:
                print(f"[{card}] {label} {name}: tap stage {shares[name]['taps'] * full[name]:.3f} "
                      f"ms a step (its share of the clocked copy's cycles x the chain's "
                      f"{full[name]:.3f} ms); the chain without it {bare[name]:.3f} ms "
                      f"(difference {full[name] - bare[name]:.3f})", flush=True)
        return
    if args.steps:
        del runs
        torch.cuda.empty_cache()
        train_steps(cs, dev, args.steps, card, label)
        return
    if args.probes:
        paths = build_probes([*PROBES, CLOCKS])
        for mask, what in PROBES.items():
            for name, path in paths[mask].items():
                build._loaded[name] = ctypes.CDLL(path)
            report(f"probe {mask} ({what})")
        phase_shares(runs, paths[CLOCKS])


if __name__ == "__main__":
    main()
