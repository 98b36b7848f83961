"""Tracing and per-phase timing for the port.

Counterpart of `marigold_tpu/utils/profiling.py`: a profiler trace of host
and device (`trace`), an accumulating per-phase wall timer that waits for
the device at each phase's edges (`PhaseTimer`, the same report format),
and named ranges (`annotate`). Set MARIGOLD_TPU_TRACE_DIR (read at import,
as in the JAX package) or pass `trace` a directory to record.

  * `trace` is a `torch.profiler` session over the CPU and, where there is
    one, the CUDA device, exported as a Chrome trace
    (`<dir>/trace_<pid>_<n>.json`, viewable in Perfetto or chrome://tracing),
    where the JAX package writes a `jax.profiler` trace for TensorBoard.
  * `PhaseTimer` synchronizes the CUDA device where the JAX package calls
    `jax.effects_barrier` / `block_until_ready`: before a phase starts and
    when it ends, so a phase's time includes the device work it queued.
  * `annotate` is `torch.profiler.record_function` (a range in the
    profiler's trace) plus an NVTX range on the card (`torch.cuda.nvtx`),
    where the JAX package opens a `jax.named_scope`.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

_TRACE_DIR = os.environ.get("MARIGOLD_TPU_TRACE_DIR")
_TRACE_COUNT = itertools.count()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a `torch.profiler` trace (CPU ops, and the CUDA device's
    kernels where there is one) of the block into `log_dir` (default
    MARIGOLD_TPU_TRACE_DIR; neither: no trace). Yields the profiler, or
    None when not recording."""
    log_dir = log_dir or _TRACE_DIR
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{next(_TRACE_COUNT)}.json")
        prof.export_chrome_trace(path)
        logger.info(f"profiler trace written to {path}")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulating wall-clock phase timer with device synchronization.

    with timer.phase("denoise"): out = fn(...)   # waits for the device on exit
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        """Time the block as phase `name`. `result` (or a "result" set in
        the yielded dict) is accepted for the JAX signature's sake: the
        whole device is synchronized either way."""
        if self.sync:
            _sync()
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            if self.sync:
                _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        lines = ["phase                     total_s   calls   share"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:24s} {t:8.3f} {self.counts[name]:7d} {t/total:6.1%}"
            )
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the profiler's trace and, on the card, in NVTX."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
