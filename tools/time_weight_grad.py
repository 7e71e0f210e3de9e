"""Time the train backwards' weight-gradient reduction on a CUDA card: the
calls one train step of K2, K4 and K5 makes at the flagship widths over 64
scenes x 2000 points, and one 512 x 512 layer alone, each beside
torch.matmul(A, B.T) on the same operands and the kernel's bounds; then the
error of that layer's reduction against float64 (A a ReLU activation, B a
small gradient, m points), the kernel's and torch.matmul's, of the largest
entry.  float32 operands run split TF32 (csrc/wgrad_tc.cuh; torch.matmul
with TF32 off); with --bf16, bf16 operands run csrc/wgrad_bf16_tc.cuh
(torch.matmul on bf16), each shape first held against float64 and printed
with its launcher's plan: the cluster, the chunk, the loads, and from them
the L2 reads and the atomics its plan makes; then every step's calls and
one 512 x 512 layer in turns three ways: as a backward launches them
(weight_grads), one by one (weight_grad), and torch.matmul on bf16 (the
median and range of 5 turns).

    python3 tools/time_weight_grad.py [--scenes 64] [--bf16]

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
import statistics
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from alignsdf_torch import use_float32_precision  # noqa: E402
from alignsdf_torch.kernels.pixel_train_decoder import pack_pixel_trunks  # noqa: E402
from alignsdf_torch.kernels.weight_grad import weight_grad, weight_grads  # noqa: E402
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


def launch_ways(sets: dict, m: int, dev, card: str, turns: int = 5) -> None:
    """Each set of bf16 (K, N) calls over m points three ways, in turns:
    as a backward launches them (weight_grads: each after the first
    overlaps the one before), one by one (weight_grad), and torch.matmul on
    bf16; CUDA events over 20 runs a turn, the median and range of the
    turns printed."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    calls = {s for shapes in sets.values() for s in shapes}
    a_of = {k: torch.randn(k, m, generator=gen, device=dev).to(torch.bfloat16)
            for k in {k for k, _ in calls}}
    b_of = {n: torch.randn(n, m, generator=gen, device=dev).to(torch.bfloat16)
            for n in {n for _, n in calls}}
    for label, shapes in sets.items():
        pairs = [(a_of[k], b_of[n]) for k, n in shapes]
        outs = [torch.zeros(k, n, device=dev) for k, n in shapes]
        ways = {"run": lambda: weight_grads(pairs, outs),
                "one by one": lambda: [weight_grad(a, b, out=c) for (a, b), c in zip(pairs, outs)],
                "torch.matmul": lambda: [torch.matmul(a, b.T) for a, b in pairs]}
        times = {w: [] for w in ways}
        for _ in range(turns):
            for w, fn in ways.items():
                times[w].append(cs.cuda_ms(fn, 20))
        print(f"[{card}] {label} ({len(shapes)} calls over {m} points, bf16), ms over {turns} "
              "turns, median (range): "
              + ", ".join(f"{w} {statistics.median(t):.4f} ({min(t):.4f}-{max(t):.4f})"
                          for w, t in times.items()), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenes", type=int, default=cs.TRAIN_SCENES)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 operands: the bf16 backwards' route")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    use_float32_precision()
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    m = args.scenes * cs.flagship_specs().samples_per_scene
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    shapes = step_shapes()
    for name, calls in shapes.items():
        cs.reduction_timing(name, calls, m, dev, card, dtype)
    if args.bf16:
        launch_ways({**shapes, "one 512 x 512 layer": [(512, 512)]}, m, dev, card)
    cs.reduction_timing("one 512 x 512 layer:", [(512, 512)], m, dev, card, dtype)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    a = torch.relu(torch.randn(512, m, generator=gen, device=dev)).to(dtype)
    b = (torch.randn(512, m, generator=gen, device=dev) * 1e-3).to(dtype)
    exact = a.double() @ b.double().T
    largest = float(exact.abs().max())
    errs = [float((c.double() - exact).abs().max()) / largest
            for c in (weight_grad(a, b), torch.matmul(a, b.T))]
    print(f"[{card}] one 512 x 512 layer over {m} points{' in bf16' if args.bf16 else ''} "
          f"against float64, of the largest "
          f"entry: kernel {errs[0]:.3e}, torch.matmul {errs[1]:.3e}", flush=True)


if __name__ == "__main__":
    main()
