"""Thread-local augmentation RNG.

The loader's determinism contract (loader.py docstring) requires restoring
a per-batch seed before a batch's samples are assembled. Doing that by
mutating the process-global `random`/`np.random` state is racy in the
0-worker path: the background producer thread would reseed globals that a
concurrent main-thread consumer (e.g. validation running while prefetch
continues) may also be using. Instead, augmentation code draws from this
module's *thread-local* `random.Random`, which the loader seeds per batch
in whichever thread (or forked worker process) assembles the batch — the
process-global RNG is never touched.
"""

from __future__ import annotations

import random as _random
import threading

import numpy as np

_tls = threading.local()


def seed(s: int) -> None:
    """Install a freshly-seeded RNG for the current thread."""
    _tls.rng = _random.Random(s)
    _tls.np_rng = np.random.default_rng(s % (2**32))


def get() -> _random.Random:
    rng = getattr(_tls, "rng", None)
    if rng is None:
        rng = _tls.rng = _random.Random()
    return rng


def get_numpy() -> np.random.Generator:
    rng = getattr(_tls, "np_rng", None)
    if rng is None:
        rng = _tls.np_rng = np.random.default_rng()
    return rng


def random() -> float:
    return get().random()


def uniform(a: float, b: float) -> float:
    return get().uniform(a, b)


def choice(seq):
    return get().choice(seq)
