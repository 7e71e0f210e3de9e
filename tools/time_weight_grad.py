"""Time the train backwards' weight-gradient reduction (csrc/wgrad_tc.cuh,
split TF32 on the tensor cores) on a CUDA card: the calls one train step of
K2, K4 and K5 makes at the flagship widths over 64 scenes x 2000 points, and
one 512 x 512 layer alone, each beside torch.matmul(A, B.T) with TF32 off
on the same operands and the split-TF32 and float32 bounds; then the
error of that layer's reduction against float64 (A a ReLU activation, B a
small gradient, m points), the kernel's and torch.matmul's, of the largest
entry.

    python3 tools/time_weight_grad.py [--scenes 64]

The calls' shapes come from the kernels' own packing of the flagship's
trunks (K2: experiments/obman_30k.json --mano --obj_pose --encode both
--point_size 9; K4: the same with --pa_feat; K5: with latent_in (0, 2)),
built on the CPU from seed 0; the operands are seeded random tensors on the
card.  The timing is chip_smoke.reduction_timing's (CUDA events, kernel /
library / kernel in turns), printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from alignsdf_torch import use_float32_precision  # noqa: E402
from alignsdf_torch.kernels.pixel_train_decoder import pack_pixel_trunks  # noqa: E402
from alignsdf_torch.kernels.weight_grad import weight_grad  # noqa: E402
from alignsdf_torch.models.alignsdf import build_model  # noqa: E402
from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder  # noqa: E402
from alignsdf_torch.ops.train_plan import make_train_decoder  # noqa: E402


def step_shapes():
    """{kernel: [(K, N) of each reduction of one train step]} at the
    flagship widths (the shapes do not depend on the point count)."""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(cs.SEED)
    specs = cs.flagship_specs()
    model = build_model(specs, device=cpu, seed=cs.SEED)
    st = make_train_decoder(specs).statics
    n = specs.samples_per_scene
    trunks = cs.k2_operands(model, specs, torch.randn(2, specs.latent_size, generator=gen),
                            torch.randn(2 * n, specs.point_feat_size, generator=gen))
    k2 = cs.k2_kernel()
    shapes = {"K2": [s for _, _, e, ws, xs, bs in trunks
                     for s in cs.wgrad_shapes(k2.pack(e, ws, xs, bs, st))]}
    pspecs = cs.flagship_specs(pixel=True)
    inputs, ptrunks, pst, _ = cs.k4_operands(build_model(pspecs, device=cpu, seed=cs.SEED),
                                             pspecs, cpu, 2)
    shapes["K4"] = cs.wgrad_shapes(pack_pixel_trunks(*inputs, ptrunks, pst))
    gspecs = cs.latent_in_0_specs()
    gst = make_generic_train_decoder(gspecs).statics
    gtrunks = cs.k5_operands(build_model(gspecs, device=cpu, seed=cs.SEED), gspecs,
                             cs.k5_rows(gspecs, cpu, gen, 2))
    k5 = cs.k5_kernel()
    shapes["K5"] = [s for _, _, e, ws, xs, bs in gtrunks
                    for s in cs.wgrad_shapes(k5.pack(e, ws, xs, bs, gst))]
    return shapes


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenes", type=int, default=cs.TRAIN_SCENES)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    use_float32_precision()
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    m = args.scenes * cs.flagship_specs().samples_per_scene
    for name, shapes in step_shapes().items():
        cs.reduction_timing(name, shapes, m, dev, card)
    cs.reduction_timing("one 512 x 512 layer:", [(512, 512)], m, dev, card)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    a = torch.relu(torch.randn(512, m, generator=gen, device=dev))
    b = torch.randn(512, m, generator=gen, device=dev) * 1e-3
    exact = a.double() @ b.double().T
    largest = float(exact.abs().max())
    errs = [float((c.double() - exact).abs().max()) / largest
            for c in (weight_grad(a, b), torch.matmul(a, b.T))]
    print(f"[{card}] one 512 x 512 layer over {m} points against float64, of the largest "
          f"entry: kernel {errs[0]:.3e}, torch.matmul {errs[1]:.3e}", flush=True)


if __name__ == "__main__":
    main()
