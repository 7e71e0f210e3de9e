"""Host-side data loading: a deterministic per-epoch order and a threaded
prefetch pipeline (the JAX package's ``data/loader.py``, thread workers,
one process; the reference's torch DataLoader + DistributedSampler +
PrefetchLoader, utils/loader.py:11-73).

``num_workers`` threads run the numpy sample pipeline concurrently, a batch
each (its large array operations release the GIL), and hand the batches
over in epoch order.  Every sample's augmentation is seeded by (loader seed, epoch,
position in the epoch), as in the JAX package, so a run is reproducible for
any worker count and the two packages draw the same items.  Batches come
out as numpy; ``training/train_step.py:batch_to_device`` moves them.  The
JAX package's forked process workers are not ported (ROADMAP.md §1 item 2).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from alignsdf_torch.data.dataset import collate


def epoch_indices(num_items: int, epoch: int, seed: int = 0) -> np.ndarray:
    """The epoch's order: a permutation seeded by seed + epoch, as the JAX
    package's (one shard) and DistributedSampler's ``set_epoch`` give."""
    return np.random.default_rng(seed + epoch).permutation(num_items)


class DataLoader:
    """Multi-threaded loader of shuffled batches, the last partial batch
    dropped, with ordered prefetch: up to ``num_workers + PREFETCH``
    batches in flight.  ``dataset.__getitem__(i, seed=...)`` builds an
    item; ``to_batch`` maps the collated items to a batch."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, seed: int = 0,
                 to_batch: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.to_batch = to_batch
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _batches(self) -> List[List[int]]:
        idx = epoch_indices(len(self.dataset), self._epoch, self.seed)
        return [list(idx[i:i + self.batch_size])
                for i in range(0, len(self) * self.batch_size, self.batch_size)]

    def _sample_seed(self, epoch: int, position: int) -> int:
        """Seed of the sample at ``position`` of ``epoch``: stable across
        worker counts and restarts."""
        mix = (self.seed * 1_000_003 + epoch) * 0x9E3779B1 + position
        return mix & 0x7FFFFFFF

    def _build_batch(self, batch_idx: List[int], epoch: int, base_pos: int):
        stacked = collate([self.dataset.__getitem__(i, seed=self._sample_seed(epoch, base_pos + j))
                           for j, i in enumerate(batch_idx)])
        return self.to_batch(stacked) if self.to_batch is not None else stacked

    def __iter__(self) -> Iterator:
        batches = self._batches()
        epoch = self._epoch
        n_batches = len(batches)
        if n_batches == 0:
            return
        task_q: "queue.Queue" = queue.Queue()
        results: Dict[int, object] = {}
        lock = threading.Condition()
        stop_flag = threading.Event()

        def worker():
            while not stop_flag.is_set():
                try:
                    job = task_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if job is None:
                    return
                bi, batch_idx = job
                try:
                    out = self._build_batch(batch_idx, epoch, bi * self.batch_size)
                except BaseException as e:  # surfaced to the consumer
                    out = e
                with lock:
                    results[bi] = out
                    lock.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        submitted = 0
        try:
            while submitted < min(self.num_workers + self.PREFETCH, n_batches):
                task_q.put((submitted, batches[submitted]))
                submitted += 1
            for bi in range(n_batches):
                with lock:
                    while bi not in results:
                        lock.wait()
                    out = results.pop(bi)
                if isinstance(out, BaseException):
                    raise out
                if submitted < n_batches:
                    task_q.put((submitted, batches[submitted]))
                    submitted += 1
                yield out
        finally:
            stop_flag.set()
            for _ in threads:
                task_q.put(None)
            for t in threads:
                t.join(timeout=5)
