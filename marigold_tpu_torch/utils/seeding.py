"""Seeding and deterministic-resume seed streams.

Counterpart of `marigold_tpu/utils/seeding.py`: a per-step seed list is
generated from a global seed with Python's `random` (so both packages give
the same list) and one seed is popped per training micro-step. Here a seed
becomes a `torch.Generator` instead of a JAX PRNG key; the two give
different random numbers from the same seed.
"""

from __future__ import annotations

import random

import torch


def generate_seed_sequence(initial_seed: int, length: int,
                           min_val=-0x8000_0000_0000_0000,
                           max_val=0xFFFF_FFFF_FFFF_FFFF) -> list[int]:
    """Deterministic per-step seed list derived from a global seed."""
    if initial_seed is None:
        raise ValueError("initial_seed must not be None")
    gen = random.Random(initial_seed)
    return [gen.randint(min_val, max_val) for _ in range(length)]


def generator_from_seed(seed: int, device="cpu") -> torch.Generator:
    """An arbitrary (possibly negative or 64-bit) seed -> a torch.Generator
    on `device`, seeded with seed mod 2**31 as the JAX package's
    `key_from_seed` folds it."""
    return torch.Generator(device=device).manual_seed(seed % (2**31))
