"""Building blocks of the port's UNet, VAE and CLIP text tower (NCHW).

Counterpart of `marigold_tpu/models/layers.py`. Parameters carry the
diffusers module names (`weight`, `bias`) in torch layout, so checkpoints
load without renaming or transposes. Precision policy as in the JAX
package: matmuls and convs run in the parameters' dtype (bf16 on the GPU);
GroupNorm/LayerNorm statistics, softmax and GELU run in fp32 and return the
storage dtype.

Convolutions are `nn.Conv2d` (F.conv2d): the JAX default is the XLA conv,
outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, act: Optional[str] = None
               ) -> torch.Tensor:
    """GroupNorm over channel groups of x [B, C, ...] with fp32 statistics
    and affine, optional fused SiLU, output in x's dtype
    (`marigold_tpu/models/layers.py:group_norm`)."""
    b, c = x.shape[:2]
    xf = x.float()
    var, mean = torch.var_mean(xf.reshape(b, num_groups, -1), dim=-1,
                               unbiased=False)
    inv = torch.rsqrt(var + eps).repeat_interleave(c // num_groups, dim=1)
    scale = inv * weight.float()
    shift = bias.float() - mean.repeat_interleave(c // num_groups, dim=1) * scale
    bshape = (b, c) + (1,) * (x.ndim - 2)
    y = xf * scale.reshape(bshape) + shift.reshape(bshape)
    if act == "silu":
        y = F.silu(y)
    elif act is not None:
        raise ValueError(f"unknown activation: {act!r}")
    return y.to(x.dtype)


class GroupNorm(nn.Module):
    """diffusers-named GroupNorm (weight, bias) with fp32 statistics."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, act)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim, fp32 math, output in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, SD2 time_proj semantics. t: [B] ->
    [B, dim] fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GEGLU(nn.Module):
    """diffusers FeedForward net.0: project to 2*inner, value * gelu(gate)
    with the exact (erf) GELU in fp32."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate.float(), approximate="none").to(x.dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W] nearest (diffusers Upsample2D)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")

