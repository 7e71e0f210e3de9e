"""Host-side data loading: a deterministic per-epoch order and an ordered
prefetch pipeline over worker threads or forked worker processes (the JAX
package's ``data/loader.py``, one shard; the reference's torch DataLoader
+ DistributedSampler + PrefetchLoader, utils/loader.py:11-73).

Each worker builds a whole batch and the batches are handed over in epoch
order, up to ``num_workers + PREFETCH`` in flight.  Where the dataset has a
whole-batch native path (``SDFDataset.build_batch`` over an ASDF-pack,
``data/packed.py``), a batch is one call that releases the GIL; otherwise
it is built item by item in numpy, which holds the GIL for much of the
work, so that ``worker_mode="process"`` forks ``num_workers`` children an
epoch instead of starting threads.  They are forked, as the JAX package's
and torch's DataLoader's are on Linux, so that they inherit the dataset
(its mmap'd LMDBs or pack and the loaded native reader) without pickling
it; they run numpy and the native reader only, never torch, whose CUDA
state does not survive a fork.  A batch comes back pickled through a
pipe.  A pack's native batch starts a thread a core in each child, as in
a thread worker (the JAX package's default), so processes over a pack run
workers x cores threads (``chip_smoke.py`` phase 18 times it).  The
parent watches its children: one that dies raises ``LoaderWorkerDied``
instead of leaving the parent waiting, and an exception raised in a child
is raised again in the parent.

Every sample's augmentation is seeded by (loader seed, epoch, position in
the epoch), as in the JAX package, so a run is reproducible for any worker
count and mode and the two packages draw the same items.  Batches come out
as numpy; ``training/train_step.py:batch_to_device`` moves them.

``post_batch``, where given, maps every batch in its worker, whichever
path built it: ``cli.train --pixel_band`` sorts each scene's points by
feature row there (``data/pixel_sort.py``).  The JAX package's loader hands
it only to the item path (its ``to_batch``), so there a pack's native
batches (its default path, ``data/loader.py:106-110``, :148-153) reach its
banded kernel unsorted and without ``point_is_hand``; here they are sorted
too.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import traceback
from multiprocessing.connection import wait
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from alignsdf_torch.data.dataset import collate

WORKER_MODES = ("thread", "process")


class LoaderWorkerDied(RuntimeError):
    """A loader worker process ended before its epoch did."""


def epoch_indices(num_items: int, epoch: int, seed: int = 0) -> np.ndarray:
    """The epoch's order: a permutation seeded by seed + epoch, as the JAX
    package's (one shard) and DistributedSampler's ``set_epoch`` give."""
    return np.random.default_rng(seed + epoch).permutation(num_items)


def _mp_worker(loader: "DataLoader", conn, epoch: int, parent_pid: int) -> None:
    """A forked worker: builds the batches its pipe names until it reads
    None (or its parent is gone), and sends each back, or the exception
    that stopped it."""
    while True:
        while not conn.poll(1.0):
            if os.getppid() != parent_pid:
                return
        job = conn.recv()
        if job is None:
            return
        bi, batch_idx = job
        try:
            out = loader._build_batch(batch_idx, epoch, bi * loader.batch_size)
        except Exception as e:  # raised again in the parent
            tb = traceback.format_exc()
            try:
                conn.send((bi, None, (e, tb)))
            except Exception:  # the exception does not pickle
                conn.send((bi, None, (RuntimeError(tb), tb)))
            continue
        conn.send((bi, out, None))


class DataLoader:
    """Loader of shuffled batches, the last partial batch dropped, with
    ordered prefetch.  ``dataset.build_batch(idx, seeds)`` builds a whole
    batch where the dataset has it and it returns one (it is then already
    in ``to_batch``'s layout); otherwise ``dataset.__getitem__(i, seed=...)``
    builds each item and ``to_batch`` maps the collated items to a batch.
    ``post_batch`` then maps the batch from either path.  ``worker_mode`` is
    "thread" or "process" (forked children, one pool an epoch)."""

    PREFETCH = 2
    POLL_S = 1.0  # the parent's wait on a child's pipe between liveness checks

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, seed: int = 0,
                 to_batch: Optional[Callable] = None, worker_mode: str = "thread",
                 post_batch: Optional[Callable] = None):
        if worker_mode not in WORKER_MODES:
            raise ValueError(f"worker_mode {worker_mode!r}: one of {WORKER_MODES}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.to_batch = to_batch
        self.post_batch = post_batch
        self.worker_mode = worker_mode
        self.native_batches = callable(getattr(dataset, "build_batch", None))
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
        out = self._assemble(batch_idx, epoch, base_pos)
        return self.post_batch(out) if self.post_batch is not None else out

    def _assemble(self, batch_idx: List[int], epoch: int, base_pos: int):
        seeds = [self._sample_seed(epoch, base_pos + j) for j in range(len(batch_idx))]
        if self.native_batches:
            out = self.dataset.build_batch(batch_idx, seeds)
            if out is not None:
                return out
        stacked = collate([self.dataset.__getitem__(i, seed=s) for i, s in zip(batch_idx, seeds)])
        return self.to_batch(stacked) if self.to_batch is not None else stacked

    def __iter__(self) -> Iterator:
        batches = self._batches()
        if not batches:
            return
        if self.worker_mode == "process":
            yield from self._iter_processes(batches, self._epoch)
        else:
            yield from self._iter_threads(batches, self._epoch)

    def _iter_threads(self, batches: List[List[int]], epoch: int) -> Iterator:
        n_batches = len(batches)
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

    def _iter_processes(self, batches: List[List[int]], epoch: int) -> Iterator:
        """A forked pool for the epoch: batch ``bi`` goes to worker ``bi %
        num_workers`` through that worker's own pipe, and comes back on it.
        Each pipe's child end is closed in the parent (and forked into no
        other child) right after its worker starts, so a worker that dies
        ends its pipe, and the parent, which waits on the pipes and on the
        workers' sentinels, raises LoaderWorkerDied."""
        ctx = mp.get_context("fork")
        procs, conns, finished = [], [], False
        try:
            for _ in range(self.num_workers):
                parent_end, child_end = ctx.Pipe()
                p = ctx.Process(target=_mp_worker, args=(self, child_end, epoch, os.getpid()),
                                daemon=True)
                p.start()
                child_end.close()
                procs.append(p)
                conns.append(parent_end)
            yield from self._deliver(batches, procs, conns)
            finished = True
        finally:
            for c in conns:
                try:
                    c.send(None)
                except OSError:  # the worker is gone
                    pass
            for p in procs:  # idle after a whole epoch; else perhaps blocked in a send
                p.join(timeout=5 if finished else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            for c in conns:
                c.close()

    def _deliver(self, batches: List[List[int]], procs, conns) -> Iterator:
        n_batches, workers = len(batches), len(procs)
        submitted = 0

        def submit() -> None:
            nonlocal submitted
            conns[submitted % workers].send((submitted, batches[submitted]))
            submitted += 1

        def died(w: int) -> LoaderWorkerDied:
            p = procs[w]
            p.join(timeout=self.POLL_S)
            return LoaderWorkerDied(f"loader worker {w} (pid {p.pid}) ended with exit code "
                                    f"{p.exitcode} before its batches were built")

        while submitted < min(workers + self.PREFETCH, n_batches):
            submit()
        for bi in range(n_batches):
            w = bi % workers
            while True:
                ready = wait([conns[w], procs[w].sentinel], timeout=self.POLL_S)
                if conns[w] in ready:
                    break
                if ready or not procs[w].is_alive():
                    raise died(w)
            try:
                got, out, err = conns[w].recv()
            except (EOFError, OSError):
                raise died(w) from None
            if got != bi:
                raise RuntimeError(f"loader worker {w} returned batch {got}, not {bi}")
            if err is not None:
                exc, tb = err
                exc.add_note(f"raised in loader worker {w} (pid {procs[w].pid}):\n{tb}")
                raise exc
            if submitted < n_batches:
                submit()
            yield out
