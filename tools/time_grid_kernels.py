"""Time kernels K1 and K3 (the grid decoders) per 128^3 pass at the flagship
width on a CUDA card, beside their error on the pass's first 2^20 points:
the kernel against its plain version, and each against the plain version
run in float64 (xyz still float32, as the kernels make it).

    python3 tools/time_grid_kernels.py [--n 128] [--reps 3]
    python3 tools/time_grid_kernels.py --bf16 [--repo DIR] [--probes] [--n 128] [--reps 3]
    python3 tools/time_grid_kernels.py --generic [--bf16] [--repo DIR] [--probes] [--n 128]

Seeded random weights (the flagship's SeparateDecoder: hidden 512 -> 250 ->
512 -> 512, latent 256), both trunks, 2 output rows; K3 samples a 256 x 64 x
64 map.  Each pass runs in the 2^20-point launches of the reconstruction
path; the best of ``--reps`` timed passes (CUDA events) after one warm-up is
printed with the card's name and power limit.  The smoke (chip_smoke.py)
times the same kernels on its own seeded scenes, whose fields are a tenth
as large; this script is the quick look, and its unit-variance latents
show the kernels' rounding at larger activations.

--bf16 times K1 on bf16 plans instead, at 2 rows and at 2 + 6 (a classifier
head of 6 classes on the hand trunk), beside the bf16 bound (the FLOPs at
989.4 TFLOP/s dense bf16) and, where the package plans it
(the launcher's ``grid_bf16_card_plan``: csrc/grid_trunk_bf16_tc.cuh), the
tile bytes its clusters read from L2 a pass (a tile's stream once a
cluster's tile of points: modelled, not measured); the error is against
the plain bf16 version (the largest, and the share beyond 1e-5).  --repo
times the package of another checkout (a parent commit unpacked with git
archive into a directory .gitignore lists), so that running the script for
parent, change, change, parent in one command compares them on one card.
--probes (with --bf16) also builds copies of grid_decoder.cu: with clusters
of 1 and of 4 (-DGB_CLUSTER; each tile read from L2 for 128 or 512 points),
timed in turn with the package's clusters of 2; without parts of the kernel
(GB_PROBE 1 the products' wgmma, 2 the epilogues, 8 the ring, 10 both);
and with GB_PROBE 32, which prints each phase's share of warpgroup 0's
cycles (products with their ring waits, epilogues, final rows, set-up, the
epilogues' waits for their item and their barriers and reloads, the
input-row fills) and the producer's waits for a free slot against the same
cycles.

--generic times K6 instead (bf16 plans with --bf16, else float32), the
generic path of --point_size 63 --pallas: the flagship's twin trunks on
[latent 256, NeRF PE 63] rows (seeded weights; seeded N(0, 0.25) rows made
on the card, which the kernels' work does not depend on), a 128^3 pass in
the generic evaluator's runs of 2^18 rows, beside the bf16 bound and, for
the bf16 kernel, the launcher's plan (generic_bf16_card_plan; L2 tile bytes
modelled); the error against the plain version on the first run.
--probes builds the same copies of generic_decoder.cu (and GB_PROBE 16,
the input-row fills left out).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = 1 << 20  # points a launch, as the reconstruction path runs them
BF16_PEAK_FLOPS = 989.4e12  # H100 SXM dense bf16 (data sheet)
BF16_TIGHT = 1e-5
CLASSES = 6
PROBES = {1: "no products' wgmma", 2: "no epilogues", 8: "no ring", 10: "no epilogues, no ring"}
GENERIC_PROBES = {**PROBES, 16: "no input-row fills",
                  26: "no epilogues, no ring, no input-row fills"}
GENERIC_RUN = 1 << 18  # rows a K6 launch, as the generic evaluator runs them
CLOCKS = 32  # the GB_PROBE bit that clocks warpgroup 0's phases
CLUSTERS = (1, 4)  # the cluster sizes the probes compare with the package's
PHASES = ("products", "epilogues", "final rows", "set-up", "epilogue item waits",
          "epilogue barriers and reloads", "input-row fills")


def rigid(gen, count: int):
    """(1, count, 4, 4) random rotations with small translations."""
    import torch

    tf = torch.eye(4).repeat(1, count, 1, 1)
    q, _ = torch.linalg.qr(torch.randn(1, count, 3, 3, generator=gen))
    tf[..., :3, :3] = q * torch.linalg.det(q)[..., None, None]
    tf[..., :3, 3] = torch.randn(1, count, 3, generator=gen) * 0.05
    return tf


def flagship(pixel: bool, classes: int = 0):
    from alignsdf_torch.config import NetworkSpecs, Specs

    return Specs(encode_style="both", point_feat_size=9, latent_size=256, mano_branch=True,
                 object_pose_branch=True, sdf_scale_factor=7.0, pixel_align=pixel,
                 classifier_branch=classes > 0,
                 network_specs=NetworkSpecs(num_class=max(classes, 1)))


def plan_for(pixel: bool, n: int, gen, dtype=None, classes: int = 0):
    import torch

    from alignsdf_torch.models.decoder import make_decoder
    from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
    from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn

    specs = flagship(pixel, classes)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        decoder = make_decoder("1encoder2decoder", 256, 9, "both", specs.network_specs,
                               use_classifier=classes > 0).cuda()
    ctx = {"decoder": decoder, "rot_center": (torch.randn(1, 1, 3, generator=gen) * 0.05).cuda(),
           "global_trans": rigid(gen, 16).cuda(), "obj_trans": rigid(gen, 1)[:, 0].cuda()}
    if pixel:
        ctx.update(latent=torch.randn(1, 256, 64, 64, generator=gen).cuda(),
                   cam_intr=torch.tensor([[[480.0, 0, 128, 0], [0, 480.0, 128, 0],
                                           [0, 0, 1, 0]]]).cuda(),
                   pred_root=torch.tensor([[[0.01, -0.02, 0.6]]]).cuda())
        return make_pixel_grid_decode_fn(specs, n)(ctx).plan, specs
    ctx["latent"] = torch.randn(1, 256, generator=gen).cuda()
    args = () if dtype is None else (dtype,)
    return make_grid_decode_fn(specs, n, *args)(ctx).plan, specs


def in_float64(plan):
    """The plan with its float tensors in float64 (the plain versions then
    run in float64)."""
    import torch

    return type(plan)(**{f.name: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                                  else v)
                         for f in dataclasses.fields(plan) for v in [getattr(plan, f.name)]})


def pass_ms(kernel, plan, n: int, origin, voxel, reps: int) -> float:
    """The best of ``reps`` timed n^3 passes (CUDA events) after a warm-up."""
    import torch

    total = n ** 3

    def one_pass():
        for start in range(0, total, RUN):
            kernel(plan, start, min(RUN, total - start), origin, voxel)

    one_pass()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        one_pass()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def float32_kernels(args, card: str) -> None:
    import torch

    from alignsdf_torch.kernels.grid_decoder import grid_decode, grid_decode_reference
    from alignsdf_torch.kernels.pixel_grid_decoder import (pixel_grid_decode,
                                                           pixel_grid_decode_reference)

    n, total = args.n, args.n ** 3
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    gen = torch.Generator().manual_seed(0)
    for name, pixel, kernel, plain in (("K1", False, grid_decode, grid_decode_reference),
                                       ("K3", True, pixel_grid_decode,
                                        pixel_grid_decode_reference)):
        plan, _ = plan_for(pixel, n, gen)
        m = min(RUN, total - 5)
        out, ref = kernel(plan, 5, m, origin, voxel), plain(plan, 5, m, origin, voxel)
        exact = plain(in_float64(plan), 5, m, origin.double(), voxel.double())
        err = float((out - ref).abs().max())
        err64 = float((out.double() - exact).abs().max())
        plain64 = float((ref.double() - exact).abs().max())
        del out, ref, exact
        best = pass_ms(kernel, plan, n, origin, voxel, args.reps)
        print(f"[{card}] {name}: {n}^3 pass {best:.2f} ms (best of {args.reps}); max abs err "
              f"vs plain {err:.3e}; vs float64: kernel {err64:.3e}, plain {plain64:.3e}",
              flush=True)


def build_copies(flag_sets: dict, source: str = "grid_decoder") -> dict:
    """csrc/<source>.cu built with each entry's flags ({key: flags}),
    concurrently: {key: library path}."""
    from alignsdf_torch.kernels import build

    out_dir = os.path.join(build.BUILD_DIR, "gb_probes")
    os.makedirs(out_dir, exist_ok=True)
    procs, paths = [], {}
    for key, flags in flag_sets.items():
        paths[key] = os.path.join(out_dir, f"lib{source}-{key}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", paths[key],
               os.path.join(build.CSRC, f"{source}.cu")]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), cmd))
    for proc, cmd in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    return paths


def bf16_kernel(args, card: str, label: str) -> None:
    import torch

    from alignsdf_torch.kernels import grid_decoder as gd

    n, total = args.n, args.n ** 3
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    runs = {}
    for classes in (0, CLASSES):
        gen = torch.Generator().manual_seed(0)
        plan, specs = plan_for(False, n, gen, torch.bfloat16, classes)
        flops = chip_flops(specs) * total
        m = min(RUN, total - 5)
        out = gd.grid_decode(plan, 5, m, origin, voxel)
        ref = gd.grid_decode_reference(plan, 5, m, origin, voxel)
        scale = torch.ones(plan.n_rows, 1, device="cuda")
        scale[2:] = max(1.0, float(ref[2:].abs().max())) if classes else 1.0
        err = (out - ref).abs() / scale
        beyond = float((err > BF16_TIGHT).float().mean())
        del out, ref
        best = pass_ms(gd.grid_decode, plan, n, origin, voxel, args.reps)
        l2 = ""
        if hasattr(gd, "grid_bf16_card_plan"):
            p = gd.grid_bf16_card_plan(plan, 0, min(RUN, total))
            tile = p["cluster"] * p["points_a_block"]
            tiles = sum(p["stream_bytes"] * -(-min(RUN, total - s) // tile)
                        for s in range(0, total, RUN))
            l2 = (f"; {p['points_a_block']} points a block, clusters of {p['cluster']}, "
                  f"{p['stream_bytes'] / 1e6:.3f} MB a tile's stream, tile bytes from L2 "
                  f"{tiles / 1e9:.2f} GB a pass (modelled, not measured)")
        print(f"[{card}] {label} K1 bf16 at {plan.n_rows} rows: {n}^3 pass {best:.2f} ms (best of "
              f"{args.reps}; {flops / 1e12:.3f} TFLOP, {flops / best / 1e9:.1f} TFLOP/s; bf16 "
              f"bound {flops / BF16_PEAK_FLOPS * 1e3:.2f} ms); vs plain bf16: max abs err "
              f"{float(err.max()):.3e} (logits over their largest), share beyond "
              f"{BF16_TIGHT:g} {beyond:.5f}{l2}", flush=True)
        runs[classes] = plan
    if args.probes:
        run_probes(card, label, "grid_decoder", "K1 bf16 at 2 rows", PROBES,
                   lambda: pass_ms(gd.grid_decode, runs[0], n, origin, voxel, args.reps),
                   lambda: gd.grid_decode(runs[0], 0, RUN, origin, voxel),
                   lambda: pass_ms(gd.grid_decode, runs[0], n, origin, voxel, 1))


def run_probes(card: str, label: str, source: str, what: str, probes: dict, timed, one_run,
               clocked) -> None:
    """The --probes copies of csrc/<source>.cu: clusters of 1 and 4 timed in
    turn with the package's clusters of 2 (``timed()``: a pass's ms), each
    GB_PROBE copy of ``probes``, then the clocked copy (``one_run()`` warms
    it up, ``clocked()`` times a pass whose phase cycles it prints)."""
    import torch

    from alignsdf_torch.kernels import build

    own = build.load(source)
    paths = build_copies({**{f"cluster{c}": (f"-DGB_CLUSTER={c}",) for c in CLUSTERS},
                          **{f"probe{mask}": (f"-DGB_PROBE={mask}",)
                             for mask in [*probes, CLOCKS]}}, source)
    copies = {c: ctypes.CDLL(paths[f"cluster{c}"]) for c in CLUSTERS}
    order = [(2, own), *[(c, copies[c]) for c in CLUSTERS],
             *[(c, copies[c]) for c in reversed(CLUSTERS)], (2, own)]
    for cs, lib in order:
        build._loaded[source] = lib
        print(f"[{card}] {label} clusters of {cs} {what}: pass {timed():.2f} ms", flush=True)
    for mask, part in probes.items():
        build._loaded[source] = ctypes.CDLL(paths[f"probe{mask}"])
        print(f"[{card}] {label} probe {mask} ({part}) {what}: pass {timed():.2f} ms", flush=True)
    lib = ctypes.CDLL(paths[f"probe{CLOCKS}"])
    build._loaded[source] = lib
    lib.gb_read_cycles.restype = ctypes.c_int
    lib.gb_read_cycles.argtypes = [ctypes.c_void_p]
    cycles = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    one_run()
    torch.cuda.synchronize()
    lib.gb_read_cycles(cycles)  # drops the warm-up's
    ms = clocked()  # a warm-up pass and one timed
    if lib.gb_read_cycles(cycles) != 0:
        raise RuntimeError("reading the phase clocks failed")
    total_cycles = sum(cycles[:len(PHASES)])
    print(f"[{card}] {label} {what} phases (shares of warpgroup 0's cycles on thread 0 of every "
          f"block; the clocked copy's pass {ms:.2f} ms): "
          + ", ".join(f"{ph} {c / total_cycles:.3f}" for ph, c in zip(PHASES, cycles))
          + f"; against the same cycles: the producer's slot waits "
          f"{cycles[len(PHASES)] / total_cycles:.3f}", flush=True)
    build._loaded[source] = own


def generic_kernel(args, card: str, label: str) -> None:
    """K6 at --point_size 63 per 128^3 pass in runs of GENERIC_RUN rows."""
    import torch

    from alignsdf_torch.config import NetworkSpecs, Specs
    from alignsdf_torch.kernels import generic_decoder as gk
    from alignsdf_torch.models.decoder import make_decoder
    from alignsdf_torch.ops.decoder_plan import make_generic_plan

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    specs = Specs(encode_style="nerf", point_feat_size=63, latent_size=256, mano_branch=True,
                  object_pose_branch=True, sdf_scale_factor=7.0, network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        decoder = make_decoder("1encoder2decoder", 256, 63, "nerf", specs.network_specs).cuda()
    plan = make_generic_plan(decoder, specs, dtype)
    total = args.n ** 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = (torch.randn(total, 256 + 63, generator=gen, device="cuda") * 0.5).to(dtype)
    runs = [rows[s:s + GENERIC_RUN] for s in range(0, total, GENERIC_RUN)]
    out = gk.generic_decode(plan, runs[0], runs[0])
    ref = gk.generic_decode_reference(plan, runs[0], runs[0])
    err = torch.cat([(o - r).abs() for o, r in zip(out[:2], ref[:2])])
    beyond = float((err > BF16_TIGHT).float().mean())
    del out, ref

    def one_pass():
        for r in runs:
            gk.generic_decode(plan, r, r)

    def timed(reps: int) -> float:
        one_pass()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            one_pass()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b))
        return best

    flops = 2 * generic_macs(specs) * total
    best = timed(args.reps)
    l2 = ""
    if args.bf16 and hasattr(gk, "generic_bf16_card_plan"):
        p = gk.generic_bf16_card_plan(plan, GENERIC_RUN)
        tile = p["cluster"] * p["points_a_block"]
        tiles = sum(p["stream_bytes"] * -(-min(GENERIC_RUN, total - s) // tile)
                    for s in range(0, total, GENERIC_RUN))
        l2 = (f"; {p['points_a_block']} points a block, clusters of {p['cluster']}, "
              f"{p['stream_bytes'] / 1e6:.3f} MB a tile's stream, tile bytes from L2 "
              f"{tiles / 1e9:.2f} GB a pass (modelled, not measured)")
    what = f"K6 {'bf16' if args.bf16 else 'float32'} at --point_size 63"
    print(f"[{card}] {label} {what}: {args.n}^3 pass {best:.2f} ms (best of {args.reps} in runs "
          f"of {GENERIC_RUN}; {flops / 1e12:.3f} TFLOP, {flops / best / 1e9:.1f} TFLOP/s; bf16 "
          f"bound {flops / BF16_PEAK_FLOPS * 1e3:.2f} ms); vs plain: max abs err "
          f"{float(err.max()):.3e}, share beyond {BF16_TIGHT:g} {beyond:.5f}{l2}", flush=True)
    if args.probes and args.bf16:
        run_probes(card, label, "generic_decoder", what, GENERIC_PROBES,
                   lambda: timed(args.reps), lambda: gk.generic_decode(plan, runs[0], runs[0]),
                   lambda: timed(1))


def chip_flops(specs) -> int:
    """K1's FLOPs a point (chip_smoke.k1_flops_per_point: the true widths,
    both trunks, the class rows)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke.k1_flops_per_point(specs)


def generic_macs(specs) -> int:
    """K6's multiply-adds a point (chip_smoke.generic_macs_per_point)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke.generic_macs_per_point(specs)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=128)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--bf16", action="store_true", help="K1 on bf16 plans")
    parser.add_argument("--repo", default=REPO, help="the checkout whose package to time")
    parser.add_argument("--probes", action="store_true",
                        help="with --bf16: also the cluster and GB_PROBE copies")
    parser.add_argument("--generic", action="store_true",
                        help="K6 at --point_size 63 (with --bf16: on bf16 plans)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from alignsdf_torch import use_float32_precision

    use_float32_precision()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    label = os.path.relpath(os.path.abspath(args.repo), REPO)
    if args.generic:
        generic_kernel(args, card, label)
    elif args.bf16:
        bf16_kernel(args, card, label)
    else:
        float32_kernels(args, card)


if __name__ == "__main__":
    main()
