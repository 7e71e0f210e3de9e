"""Time kernel K7, the stem max pool 3x3 / stride 2 / pad 1 (forward and
backward), on a CUDA card at the train shape (64, 64, 128, 128) and
serving's (1, 64, 128, 128), channels last (the encoder's stem layout) and
NCHW, on chip_smoke.py's tied post-ReLU input.  Each time is the median
and range over rounds of launches timed with CUDA events, printed beside:

- the bytes bound: each input read once and each output written once, over
  the H100's 3.35 TB/s, and the rate achieved;
- one PyTorch call on the same inputs, as information: ``F.max_pool2d``
  for the forward, ``max_pool2d_with_indices_backward`` for the backward
  (it routes a tied window's gradient to its first maximum, another
  function than K7's);
- a device copy that moves the same bytes (half of them read, half written),
  the card's practical streaming rate: information, not a target.

The backward is also checked bit for bit against the plain version.

    python3 tools/time_maxpool.py [--repo DIR] [--bands 4,8,16] [--rounds 9]

--repo times the package of another checkout (for example a parent commit
unpacked with git archive into a directory .gitignore lists), so a
parent's and this checkout's kernels are timed in one call by running the
script once for each.  --bands also times the backward with each thread
walking that many output rows: copies of ``csrc/maxpool.cu`` built with
-DK7_BAND_ROWS=n, one nvcc each, all at once (a package whose source has no
such switch is timed at its own design only).  The serving shape's inputs
fit the 50 MB L2, so its times are those of a warm cache.  Each line is
printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"train": (64, 64, 128, 128), "serving": (1, 64, 128, 128)}
REPS = {"train": 20, "serving": 200}  # launches a round


def event_ms(fn, rounds: int, reps: int):
    """(median, min, max) over ``rounds`` of the mean device time of fn()
    over ``reps`` launches, after one warm-up launch."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out), min(out), max(out)


def build_bands(bands):
    """Build csrc/maxpool.cu with -DK7_BAND_ROWS=b for each band height b,
    concurrently: {b: library path}."""
    from alignsdf_torch.kernels import build

    out_dir = os.path.join(build.BUILD_DIR, "k7_bands")
    os.makedirs(out_dir, exist_ok=True)
    procs, paths = [], {}
    for b in bands:
        paths[b] = os.path.join(out_dir, f"libmaxpool-rows{b}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DK7_BAND_ROWS={b}", "-o", paths[b],
               os.path.join(build.CSRC, "maxpool.cu")]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), cmd))
    for proc, cmd in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    return paths


def use_lib(path) -> None:
    """Load the K7 library at ``path`` in place of the package's: the
    wrappers' next launches run it."""
    from alignsdf_torch.kernels import build

    build._loaded["maxpool"] = ctypes.CDLL(path)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=REPO, help="the checkout whose package to time")
    parser.add_argument("--bands", default="", help="comma-separated band heights to time")
    parser.add_argument("--rounds", type=int, default=9)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    from torch.nn import functional as F

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from alignsdf_torch.kernels import build
    from alignsdf_torch.kernels import maxpool as k7

    card = cs.card_line()
    label = os.path.relpath(os.path.abspath(args.repo), REPO)
    print(f"card: {card}; package: {label}", flush=True)
    bands = [int(b) for b in args.bands.split(",") if b]
    if any(b < 1 for b in bands):
        sys.exit("--bands takes band heights of 1 or more")
    if bands:
        with open(os.path.join(build.CSRC, "maxpool.cu")) as f:
            if "K7_BAND_ROWS" not in f.read():
                print(f"{label}'s maxpool.cu has no K7_BAND_ROWS: --bands skipped", flush=True)
                bands = []
    band_libs = build_bands(bands)
    own_lib = k7._lib()
    dev = torch.device("cuda")
    rate = cs.HBM_BYTES_PER_S

    def report(what, nbytes, times, library, copy):
        med, lo, hi = times
        print(f"[{card}] {label} {what}: {med:.4f} ms (range {lo:.4f}-{hi:.4f}), "
              f"{nbytes / med / 1e6:.0f} GB/s, bound {nbytes / rate * 1e3:.4f} ms "
              f"({nbytes / rate * 1e3 / med:.1%}); {library[0]} {library[1][0]:.4f} ms; "
              f"copy of the same bytes {copy[0]:.4f} ms ({nbytes / copy[0] / 1e6:.0f} GB/s)",
              flush=True)

    for shape_label, shape in SHAPES.items():
        reps = REPS[shape_label]
        for fmt in (torch.channels_last, torch.contiguous_format):
            layout = "channels last" if fmt == torch.channels_last else "NCHW"
            x = cs.k7_input(shape, dev, cs.SEED, fmt)
            y = k7.maxpool_forward(x)
            dy = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(
                cs.SEED + 1), device=dev).contiguous(memory_format=fmt)
            _, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
            equal = bool(torch.equal(k7.maxpool_backward(x, y, dy),
                                     k7.maxpool_backward_reference(x, y, dy)))
            where = f"{shape_label} {shape}, {layout}"
            print(f"{label} K7 backward at {where} equal to the plain version: {equal}",
                  flush=True)
            fwd_bytes = 4 * (x.numel() + y.numel())
            src, dst = (torch.empty(fwd_bytes // 8, device=dev) for _ in range(2))
            report(f"K7 fwd at {where}", fwd_bytes,
                   event_ms(lambda: k7.maxpool_forward(x), args.rounds, reps),
                   ("F.max_pool2d", event_ms(lambda: F.max_pool2d(x, 3, 2, 1), args.rounds,
                                             reps)),
                   event_ms(lambda: dst.copy_(src), args.rounds, reps))
            # x, y and dy read once, dx written once
            bwd_bytes = 2 * fwd_bytes
            src, dst = (torch.empty(bwd_bytes // 8, device=dev) for _ in range(2))

            def lib_bwd():
                return torch.ops.aten.max_pool2d_with_indices_backward(
                    dy, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)

            lib = ("max_pool2d_with_indices_backward", event_ms(lib_bwd, args.rounds, reps))
            copy = event_ms(lambda: dst.copy_(src), args.rounds, reps)
            report(f"K7 bwd at {where}", bwd_bytes,
                   event_ms(lambda: k7.maxpool_backward(x, y, dy), args.rounds, reps), lib, copy)
            for b in bands:
                use_lib(band_libs[b])
                equal = bool(torch.equal(k7.maxpool_backward(x, y, dy),
                                         k7.maxpool_backward_reference(x, y, dy)))
                report(f"K7 bwd band_rows {b} at {where} (equal to the plain version: {equal})",
                       bwd_bytes, event_ms(lambda: k7.maxpool_backward(x, y, dy), args.rounds,
                                           reps), lib, copy)
            build._loaded["maxpool"] = own_lib
            del x, y, dy, idx, src, dst
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
