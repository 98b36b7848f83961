"""Multi-resolution (pyramid) noise for diffusion training, NCHW.

Counterpart of `marigold_tpu/train/multi_res_noise.py`: the sum of bilinear
upsampled Gaussian noise levels weighted by strength**(i * octave_pow),
renormalised by the std over the whole tensor. Every level has a static
power-of-two shape (h >> i, w >> i); the reference's random downscale
factor r ~ U[2, 4) (one per call) sets the per-octave amplitude exponent
log(2)/log(r) ("original", "random_step"), and the power-of-two strategies
use exponent 1.

The function is split into `draw_multi_res` (the random numbers, from an
explicit torch.Generator) and `combine_multi_res` (the arithmetic), so that
a test can feed the JAX package's draws to the combination. The upsampling
is `F.interpolate(bilinear, align_corners=False)`, which for upsampling
equals `jax.image.resize(..., "bilinear")`: half-pixel centres, and at the
borders the weight of an out-of-range neighbour goes to the edge pixel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

STRATEGIES = ("original", "random_step", "every_layer", "power_of_two")


def num_levels(h: int, w: int, cap: int = 10) -> int:
    return min(cap, int(math.log2(max(min(h, w), 2))) + 1)


def draw_multi_res(shape, generator: Optional[torch.Generator], device,
                   downscale_strategy: str = "original") -> dict:
    """The draws for noise of NCHW `shape`: {"base": N(0,1) of `shape`,
    "levels": [N(0,1) of [B, C, h >> i, w >> i] for i >= 1], "r": U[2, 4)
    as a 0-d fp32 tensor, or None for the power-of-two strategies}."""
    if downscale_strategy not in STRATEGIES:
        raise ValueError(f"unknown downscale strategy: {downscale_strategy}")
    b, c, h, w = shape
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    base = torch.randn(shape, **kw)
    levels = [torch.randn((b, c, max(1, h >> i), max(1, w >> i)), **kw)
              for i in range(1, num_levels(h, w))]
    r = None
    if downscale_strategy in ("original", "random_step"):
        r = torch.rand((), **kw) * 2.0 + 2.0
    return {"base": base, "levels": levels, "r": r}


def combine_multi_res(draws: dict, strength) -> torch.Tensor:
    """fp32 noise of the base draw's shape, std 1 over the whole tensor.
    `strength` is a scalar or a per-sample [B] tensor (the annealed
    variant passes strength * t / T)."""
    base = draws["base"]
    strength = torch.as_tensor(strength, dtype=torch.float32, device=base.device)
    if strength.ndim == 1:
        strength = strength.reshape(-1, 1, 1, 1)
    r = draws["r"]
    octave_pow = (torch.log(torch.tensor(2.0, device=base.device)) / torch.log(r)
                  if r is not None else torch.tensor(1.0, device=base.device))
    noise = base
    for i, lvl in enumerate(draws["levels"], start=1):
        up = F.interpolate(lvl, size=base.shape[2:], mode="bilinear",
                           align_corners=False)
        noise = noise + up * strength ** (i * octave_pow)
    return noise / noise.std(unbiased=False).clamp(min=1e-8)


def multi_res_noise_like(x: torch.Tensor, strength, downscale_strategy: str =
                         "original", generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Noise with the NCHW shape and dtype of `x`, approximately unit std."""
    draws = draw_multi_res(x.shape, generator, x.device, downscale_strategy)
    return combine_multi_res(draws, strength).to(x.dtype)
