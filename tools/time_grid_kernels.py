"""Time kernels K1 and K3 (the grid decoders) per 128^3 pass at the flagship
width on a CUDA card, beside their error on the pass's first 2^20 points:
the kernel against its plain version, and each against the plain version
run in float64 (xyz still float32, as the kernels make it).

    python3 tools/time_grid_kernels.py [--n 128] [--reps 3]

Seeded random weights (the flagship's SeparateDecoder: hidden 512 -> 250 ->
512 -> 512, latent 256), both trunks, 2 output rows; K3 samples a 256 x 64 x
64 map.  Each pass runs in the 2^20-point launches of the reconstruction
path; the best of ``--reps`` timed passes (CUDA events) after one warm-up is
printed with the card's name and power limit.  The smoke (chip_smoke.py)
times the same kernels on its own seeded scenes, whose fields are a tenth
as large; this script is the quick look, and its unit-variance latents
show the kernels' rounding at larger activations.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alignsdf_torch import use_float32_precision  # noqa: E402
from alignsdf_torch.config import NetworkSpecs, Specs  # noqa: E402
from alignsdf_torch.kernels.grid_decoder import grid_decode, grid_decode_reference  # noqa: E402
from alignsdf_torch.kernels.pixel_grid_decoder import (  # noqa: E402
    pixel_grid_decode,
    pixel_grid_decode_reference,
)
from alignsdf_torch.models.decoder import SeparateDecoder  # noqa: E402
from alignsdf_torch.ops.grid_plan import make_grid_decode_fn  # noqa: E402
from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn  # noqa: E402

RUN = 1 << 20  # points a launch, as the reconstruction path runs them


def rigid(gen: torch.Generator, count: int) -> torch.Tensor:
    """(1, count, 4, 4) random rotations with small translations."""
    tf = torch.eye(4).repeat(1, count, 1, 1)
    q, _ = torch.linalg.qr(torch.randn(1, count, 3, 3, generator=gen))
    tf[..., :3, :3] = q * torch.linalg.det(q)[..., None, None]
    tf[..., :3, 3] = torch.randn(1, count, 3, generator=gen) * 0.05
    return tf


def plan_for(pixel: bool, n: int, gen: torch.Generator):
    specs = Specs(encode_style="both", point_feat_size=9, latent_size=256, mano_branch=True,
                  object_pose_branch=True, sdf_scale_factor=7.0, pixel_align=pixel,
                  network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        decoder = SeparateDecoder(256, 9, "both", specs.network_specs).cuda()
    ctx = {"decoder": decoder, "rot_center": (torch.randn(1, 1, 3, generator=gen) * 0.05).cuda(),
           "global_trans": rigid(gen, 16).cuda(), "obj_trans": rigid(gen, 1)[:, 0].cuda()}
    if pixel:
        ctx.update(latent=torch.randn(1, 256, 64, 64, generator=gen).cuda(),
                   cam_intr=torch.tensor([[[480.0, 0, 128, 0], [0, 480.0, 128, 0],
                                           [0, 0, 1, 0]]]).cuda(),
                   pred_root=torch.tensor([[[0.01, -0.02, 0.6]]]).cuda())
        return make_pixel_grid_decode_fn(specs, n)(ctx).plan
    ctx["latent"] = torch.randn(1, 256, generator=gen).cuda()
    return make_grid_decode_fn(specs, n)(ctx).plan


def in_float64(plan):
    """The plan with its float tensors in float64 (the plain versions then
    run in float64)."""
    return type(plan)(**{f.name: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                                  else v)
                         for f in dataclasses.fields(plan) for v in [getattr(plan, f.name)]})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=128)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    use_float32_precision()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    n, total = args.n, args.n ** 3
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    gen = torch.Generator().manual_seed(0)
    for name, pixel, kernel, plain in (("K1", False, grid_decode, grid_decode_reference),
                                       ("K3", True, pixel_grid_decode,
                                        pixel_grid_decode_reference)):
        plan = plan_for(pixel, n, gen)
        m = min(RUN, total - 5)
        out, ref = kernel(plan, 5, m, origin, voxel), plain(plan, 5, m, origin, voxel)
        exact = plain(in_float64(plan), 5, m, origin.double(), voxel.double())
        err = float((out - ref).abs().max())
        err64 = float((out.double() - exact).abs().max())
        plain64 = float((ref.double() - exact).abs().max())
        del out, ref, exact

        def one_pass():
            for start in range(0, total, RUN):
                kernel(plan, start, min(RUN, total - start), origin, voxel)

        one_pass()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(args.reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            one_pass()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b))
        print(f"[{card}] {name}: {n}^3 pass {best:.2f} ms (best of {args.reps}); max abs err "
              f"vs plain {err:.3e}; vs float64: kernel {err64:.3e}, plain {plain64:.3e}",
              flush=True)


if __name__ == "__main__":
    main()
