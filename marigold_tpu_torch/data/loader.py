"""Batching data loader (torch-free) with resumable iteration.

Copy of `marigold_tpu/data/loader.py` for the PyTorch port: the same
batches, per-batch augmentation seeds, `skip_first_batches`, prefetch
thread, forked workers and `shard_count`/`shard_index` striding, so one
seed gives both packages the same batches. One difference: at the end of
an epoch the worker pool is closed and joined, and terminated only when
the consumer stops early or an error propagates; its workers restore
SIGTERM's default action at start.

Role parity: torch DataLoader + the reference's `skip_first_batches`
mid-epoch-resume helper (src/util/data_loader.py:54-140). A background
thread (or a pool of forked workers) assembles batches while the device
computes.

Torch-free on purpose. The training CLI forks the workers after CUDA is
initialised in the parent, and a forked child may not touch the CUDA
runtime it inherited. So the worker body (`_assemble_batch_worker`, the
dataset's `__getitem__`, the collate function) uses numpy and the standard
library only and returns numpy batches; the trainer moves them to the
card in the parent. Do not import torch in a dataset's `__getitem__`.

Determinism contract: when constructed with a seed, every batch carries a
per-batch augmentation seed drawn from the loader's rng for the FULL epoch
(before any `skip_first_batches`), and that seed is restored into the
thread-local augmentation RNG (`data/rng.py`) before the batch's samples
are assembled — in both the 0-worker thread path and the forked-worker
path. So seeded runs reproduce their augmentations exactly, a resumed run
replays the same seeds the uninterrupted run would have used for the
remaining batches, and 0-worker and N-worker runs see the same
augmentation stream. The contract covers datasets drawing from
`data/rng.py` (all in-repo datasets do); forked workers additionally
reseed the process-global `random`/`np.random` as an escape hatch for
user datasets that still consume them, but the 0-worker thread path
deliberately does NOT (mutating process globals from the prefetch thread
races with concurrent main-thread consumers, e.g. validation) — such
datasets are reproducible only with `num_workers > 0`.
"""

from __future__ import annotations

import queue
import random
import signal
import threading
from typing import Iterable, Optional, Sequence

import numpy as np


_WORKER_DATASET_COLLATE = None  # set before fork; inherited by workers
_WORKER_HANDLES_RESET = False  # per-forked-process flag


def _reset_inherited_io(dataset) -> None:
    """Close tar handles inherited through fork that read through tarfile,
    so that each worker reopens its own: tarfile seeks a file offset that a
    fork shares between the processes, and two processes interleaving
    seek+read corrupt member bytes. The native reader (`data/tario.py`,
    pread on its own offsets) is kept with its index. Walks
    ConcatDataset-style wrappers."""
    for ds in getattr(dataset, "datasets", [dataset]):
        tar = getattr(ds, "tar_obj", None)
        if tar is not None and not getattr(tar, "native", False):
            try:
                tar.close()
            except Exception:
                pass
            ds.tar_obj = None


def _worker_init() -> None:
    """Pool worker start: SIGTERM with its default action and unblocked,
    whatever the parent process had set, so that Pool.terminate() ends the
    worker (a worker that survived it would hang the join that follows)."""
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGTERM})


def _assemble_batch_worker(args):
    batch_idx, seed = args
    global _WORKER_HANDLES_RESET
    dataset, collate_fn = _WORKER_DATASET_COLLATE
    if not _WORKER_HANDLES_RESET:
        _reset_inherited_io(dataset)
        _WORKER_HANDLES_RESET = True
    # deterministic augmentations: restore the per-batch seed into the
    # thread-local augmentation RNG (the torch-DataLoader worker-seeding
    # role). Forked children also reseed the process globals for any
    # user dataset that still consumes them — safe here because the
    # worker process is single-threaded.
    from . import rng as data_rng

    data_rng.seed(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return collate_fn([dataset[i] for i in batch_idx])


def default_collate(samples: Sequence[dict]) -> dict:
    """Stack numpy leaves along a new batch dim; pass through non-arrays as
    lists."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[k] = np.stack(vals, 0)
        elif isinstance(first, (int, float, np.integer, np.floating, bool)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        batch_sampler=None,
        drop_last: bool = False,
        seed: Optional[int] = None,
        collate_fn=default_collate,
        prefetch: int = 2,
        num_workers: int = 0,
        shard_count: int = 1,
        shard_index: int = 0,
    ):
        """num_workers > 0 assembles batches in forked worker processes
        (reference DataLoader num_workers, config train_*.yaml) — decode +
        augmentation scale with host cores; 0 keeps the single background
        prefetch thread.

        shard_count/shard_index: multi-host data parallelism. All
        processes construct the loader with the SAME seed (so the global
        batch/seed stream is identical everywhere), and process p yields
        only global batches p, p+N, p+2N, ... — each step's global batch
        (mesh.global_batch_from_local concatenation) is then N *distinct*
        consecutive batches of the stream, not N copies of one. The
        stream is truncated to floor(len/N) per process so every process
        runs the same number of steps per epoch (unequal counts would
        desync the training collectives at the epoch boundary).
        skip_first_batches counts LOCAL batches, matching the trainer's
        per-process n_batch_in_epoch bookkeeping."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.batch_sampler = batch_sampler
        self.drop_last = drop_last
        self.rng = random.Random(seed)
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.num_workers = int(num_workers)
        if not (0 <= int(shard_index) < int(shard_count)):
            raise ValueError(
                f"shard_index {shard_index} out of range for "
                f"shard_count {shard_count}"
            )
        self.shard_count = int(shard_count)
        self.shard_index = int(shard_index)
        self._skip = 0

    def _batches(self) -> Iterable[list]:
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            batch = idx[s : s + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                return
            yield batch

    def skip_first_batches(self, n: int) -> "DataLoader":
        """Resume mid-epoch: the next iteration skips its first n batches
        (contract of reference skip_first_batches, data_loader.py:54-97)."""
        self._skip = n
        return self

    def __len__(self):
        if self.batch_sampler is not None:
            n_batches = len(self.batch_sampler)
        else:
            n = len(self.dataset)
            n_batches = (
                n // self.batch_size if self.drop_last
                else -(-n // self.batch_size)
            )
        if self.shard_count > 1:
            return n_batches // self.shard_count
        return n_batches

    def __iter__(self):
        skip = self._skip
        self._skip = 0
        all_batches = list(self._batches())
        # seeds drawn for the FULL epoch, then skipped alongside batches:
        # a resumed epoch replays the seeds the uninterrupted run would
        # have used for the remaining batches, and the rng leaves the
        # epoch in the same state either way
        all_seeds = [self.rng.randrange(2**31) for _ in all_batches]
        if self.shard_count > 1:
            # every process drew the identical stream above (same seed);
            # take this process's stride so global batches are disjoint,
            # truncated to a common per-process count (see __init__)
            n_local = len(all_batches) // self.shard_count
            sel = [
                i * self.shard_count + self.shard_index
                for i in range(n_local)
            ]
            all_batches = [all_batches[i] for i in sel]
            all_seeds = [all_seeds[i] for i in sel]
        batch_lists = all_batches[skip:]
        seeds = all_seeds[skip:]

        if self.num_workers > 0:
            yield from self._iter_workers(batch_lists, seeds)
            return

        stop = threading.Event()

        def put_or_abandon(q, item) -> bool:
            """Bounded put that notices an abandoned consumer — a plain
            q.put would block forever and leak this thread (plus its
            queued batches) when the consumer breaks out early."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(q: queue.Queue):
            from . import rng as data_rng

            try:
                for batch_idx, seed in zip(batch_lists, seeds):
                    # same per-batch seeding as the worker path, but into
                    # the THREAD-LOCAL augmentation RNG only: mutating the
                    # process-global random/np.random from this daemon
                    # thread would race with any concurrent main-thread
                    # consumer (e.g. validation while prefetch continues)
                    data_rng.seed(seed)
                    samples = [self.dataset[i] for i in batch_idx]
                    if not put_or_abandon(q, ("item", self.collate_fn(samples))):
                        return
            except Exception as e:  # propagate to consumer
                if not put_or_abandon(q, ("error", e)):
                    return
            finally:
                put_or_abandon(q, ("end", None))

        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "item":
                    yield payload
                elif kind == "error":
                    raise payload
                else:
                    return
        finally:
            stop.set()

    def _iter_workers(self, batch_lists, seeds):
        """Forked worker pool assembling whole batches in order, with a
        bounded submission window (num_workers + prefetch outstanding) so
        finished batches cannot pile up in host RAM when the consumer
        pauses (e.g. during a multi-minute validation pass).

        Caveat (shared with torch's fork-based workers): fork after CUDA
        initialization can inherit locks held by runtime threads, and a
        child may not use the CUDA runtime; the workers run no torch (see
        the module docstring), and the training CLI iterates the loader
        only from the host thread between device steps."""
        import itertools
        import multiprocessing as mp
        from collections import deque

        ctx = mp.get_context("fork")
        global _WORKER_DATASET_COLLATE
        _WORKER_DATASET_COLLATE = (self.dataset, self.collate_fn)
        window = self.num_workers + max(self.prefetch, 1)
        pool = ctx.Pool(self.num_workers, initializer=_worker_init)
        joined = False
        try:
            work = iter(zip(batch_lists, seeds))
            pending = deque(
                pool.apply_async(_assemble_batch_worker, (a,))
                for a in itertools.islice(work, window)
            )
            while pending:
                batch = pending.popleft().get()
                nxt = next(work, None)
                if nxt is not None:
                    pending.append(
                        pool.apply_async(_assemble_batch_worker, (nxt,))
                    )
                yield batch
            # the epoch is done: the workers exit on the pool's sentinels
            # (the JAX copy terminates them; a join needs no signal)
            pool.close()
            pool.join()
            joined = True
        finally:
            if not joined:  # the consumer stopped early, or an error
                pool.terminate()
            # release the dataset reference (tar handles, caches) once the
            # pool is gone — workers only needed it at fork time
            _WORKER_DATASET_COLLATE = None
