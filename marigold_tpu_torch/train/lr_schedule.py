"""Learning-rate schedules as plain functions of the step.

Counterpart of `marigold_tpu/train/lr_schedule.py:iter_exponential`, the
reference's IterExponential: linear warmup from 0 to 1 over
`warmup_steps`, then exponential decay reaching `final_ratio` at
`total_iter`, constant afterwards. The value is a factor on the base LR,
computed in fp32 as the JAX schedule is.
"""

from __future__ import annotations

import math

import numpy as np


def iter_exponential(total_iter: int, final_ratio: float, warmup_steps: int = 0):
    total_iter = int(total_iter)
    warmup_steps = int(warmup_steps)
    log_ratio = np.float32(math.log(float(final_ratio)))

    def schedule(step) -> float:
        step = np.float32(step)
        if step < warmup_steps:
            return float(step / np.float32(max(warmup_steps, 1)))
        denom = np.float32(max(total_iter - warmup_steps, 1))
        frac = np.clip((step - np.float32(warmup_steps)) / denom,
                       np.float32(0.0), np.float32(1.0))
        return float(np.exp(log_ratio * frac))

    return schedule
