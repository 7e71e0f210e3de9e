"""Time the PyTorch port's training loader on the host, over a synthetic
dataset at the flagship's shapes (experiments/obman_30k.json: 256x256
images, batches of 64 scenes of 2000 points, DataLoaderThreads 5): the
five-LMDB layout (``data/synthetic.py:write_synthetic_lmdb``) or, with
--files, the per-file layout (``write_synthetic_dataset``) or, with
--packed, that layout packed by ``tools/pack_dataset_torch.py`` into an
ASDF-pack, whose batches the native reader builds whole; with thread
workers or, with --loader_mode process, forked ones.  It prints one JSON
line: for each epoch its time over its batches and the wait for its first
batch, the median time of an item built alone (over the first 64 scenes),
the host's CPU count and, where ``nvidia-smi`` answers, the card's name
and power limit.

    python3 tools/time_loader.py [--repo DIR] [--scenes 512] [--epochs 3] \
        [--files | --packed] [--loader_mode thread|process]

--repo times the package of another checkout (for example a parent commit
unpacked with git archive into a directory .gitignore lists), so a
parent's and this checkout's loaders are timed in one call by running the
script once for each; the package timed writes its own dataset.  A
package without ``write_synthetic_dataset`` cannot take --files, one
without ``tools/pack_dataset_torch.py`` and ``--loader_mode`` neither
--packed nor --loader_mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no card"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=REPO, help="checkout whose alignsdf_torch is timed")
    parser.add_argument("--scenes", type=int, default=512)
    parser.add_argument("--epochs", type=int, default=3)
    layout = parser.add_mutually_exclusive_group()
    layout.add_argument("--files", action="store_true", help="the per-file layout")
    layout.add_argument("--packed", action="store_true", help="the per-file layout, packed")
    parser.add_argument("--loader_mode", default=None, choices=["thread", "process"])
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    sys.path.insert(0, os.path.join(os.path.abspath(args.repo), "tools"))

    from alignsdf_torch.config import load_specs
    from alignsdf_torch.data import make_train_dataset, synthetic
    from alignsdf_torch.data.dataset import to_train_batch
    from alignsdf_torch.data.loader import DataLoader

    specs = dataclasses.replace(load_specs(os.path.join(REPO, "experiments", "obman_30k.json")),
                                lmdb=not (args.files or args.packed))
    mode = {} if args.loader_mode is None else {"worker_mode": args.loader_mode}
    if args.scenes < specs.scenes_per_batch:
        parser.error(f"--scenes: at least a batch, {specs.scenes_per_batch}")
    keys = [f"{i:08d}" for i in range(args.scenes)]
    write = (synthetic.write_synthetic_lmdb if specs.lmdb
             else synthetic.write_synthetic_dataset)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = write(tmp, keys, image_hw=specs.image_size[0])
        write_s = time.perf_counter() - t0
        pack = {}
        if args.packed:
            import pack_dataset_torch

            pack = {"pack_path": os.path.join(tmp, "train.pack")}
            pack_dataset_torch.pack(root, pack["pack_path"], keys, specs.dataset)
        dataset = make_train_dataset(specs, root, keys, raw_image=True, **pack)
        item_ms = []
        for i in range(min(64, len(keys))):
            t0 = time.perf_counter()
            dataset.__getitem__(i, seed=i)
            item_ms.append((time.perf_counter() - t0) * 1e3)
        loader = DataLoader(dataset, batch_size=specs.scenes_per_batch,
                            num_workers=specs.data_loader_threads, seed=0,
                            to_batch=lambda stacked: to_train_batch(specs, stacked), **mode)
        batch_ms, first_ms = [], []
        for epoch in range(1, args.epochs + 1):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            ends = [time.perf_counter() for _ in loader]
            first_ms.append((ends[0] - t0) * 1e3)
            batch_ms.append((ends[-1] - t0) / len(ends) * 1e3)
    print(json.dumps({
        "repo": os.path.abspath(args.repo),
        "layout": "packed" if args.packed else "files" if args.files else "lmdb",
        "loader_mode": args.loader_mode or "thread",
        "card": card_line(), "cpus": os.cpu_count(), "scenes": args.scenes,
        "batch": specs.scenes_per_batch, "threads": specs.data_loader_threads,
        "write_s": write_s, "item_ms_median": statistics.median(item_ms),
        "epoch_ms_per_batch": batch_ms, "first_batch_ms": first_ms}), flush=True)


if __name__ == "__main__":
    main()
