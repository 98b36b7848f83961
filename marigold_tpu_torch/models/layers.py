"""Building blocks of the port's UNet, VAE and CLIP text tower (NCHW).

Counterpart of `marigold_tpu/models/layers.py`. Parameters carry the
diffusers module names (`weight`, `bias`) in torch layout, so checkpoints
load without renaming or transposes. Precision policy as in the JAX
package: matmuls and convs run in the parameters' dtype (bf16 on the GPU);
GroupNorm/LayerNorm statistics, softmax and GELU run in fp32 and return the
storage dtype.

Convolutions: the models' 3x3 convs are `Conv2d`, an nn.Conv2d whose
forward goes through the conv dispatch of the JAX package's `conv2d`
(`marigold_tpu/models/layers.py:67-150`). MARIGOLD_TPU_CONV, read at import
with the JAX package's values, picks the implementation:
  * "xla" (default): F.conv2d (cuDNN on the card), as the JAX default is
    XLA's conv outside any Pallas kernel;
  * "pallas": the nine-tap kernel, `ops/conv.py` (`csrc/conv3x3.cu`);
  * "winograd": the F(2x2, 3x3) kernel, `ops/winograd.py`
    (`csrc/winograd.cu`).
A kernel takes exactly the convs that the JAX `supports()` gates admit
(3x3, stride 1, padding 1, C and K at least 128 and multiples of 128; even
H and W and MARIGOLD_TPU_WINO_MAX_HW for Winograd), without the TPU VMEM
plan, which has no counterpart on the card; the others run F.conv2d. On a
CPU tensor a kernel mode runs the kernel's plain version, so CPU runs
exercise the dispatch (the JAX package instead drops to XLA off the TPU
unless MARIGOLD_TPU_CONV_INTERPRET=1). With grad enabled a kernel conv runs
through `ops.conv.KernelConvFunction`, whose backward is the plain conv
gradient. Without grad, on the card, the kernel takes its rearranged weight
from `Conv2d.prepared_weight`, a cache that follows every change of the
weight. Tests switch the mode by setting `_CONV_IMPL`.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from marigold_tpu_torch.ops import conv as conv_ops
from marigold_tpu_torch.ops import winograd as winograd_ops

CONV_IMPLS = ("xla", "pallas", "winograd")
_PREPARE_LOCK = threading.Lock()  # Conv2d.prepared_weight's cache fill
_CONV_IMPL = os.environ.get("MARIGOLD_TPU_CONV", "xla")
if _CONV_IMPL not in CONV_IMPLS:
    raise ValueError(f"MARIGOLD_TPU_CONV must be one of {CONV_IMPLS}, "
                     f"got {_CONV_IMPL!r}")


def conv_impl_for(x_shape, w_shape, stride, padding, dtype) -> Optional[str]:
    """Which kernel takes this conv under the current mode: "pallas",
    "winograd" or None (F.conv2d). Shapes NCHW / OIHW."""
    if _CONV_IMPL == "winograd":
        if winograd_ops.supports(x_shape, w_shape, stride, padding, dtype):
            return "winograd"
    elif _CONV_IMPL == "pallas":
        if conv_ops.supports(x_shape, w_shape, stride, padding, dtype):
            return "pallas"
    return None


class Conv2d(nn.Conv2d):
    """nn.Conv2d (diffusers names `weight`, `bias`) through the conv
    dispatch."""

    def __getattr__(self, name: str):
        # A write through `conv.weight.data` does not bump the weight's
        # `_version`, so fetching `conv.weight` (the way to such a write)
        # drops the kernel's cached weight. The module itself reads
        # `_parameters["weight"]`.
        if name == "weight":
            self.__dict__.pop("_prepared", None)
        return super().__getattr__(name)

    def prepared_weight(self, impl: str) -> torch.Tensor:
        """The weight as kernel `impl` reads it (`ops.conv.prepare_weight`
        for "pallas", `ops.winograd.prepare_weight` for "winograd": the taps
        or the filter transform, split into tf32 parts for an fp32 weight),
        computed once and reused until the weight changes: the cache is
        keyed on the weight's `data_ptr()` and `_version`, which an in-place
        update, an optimizer step and a load change, and is dropped when
        `conv.weight` is fetched from outside (see `__getattr__`)."""
        w = self._parameters["weight"]
        key = (impl, w.data_ptr(), w._version, w.dtype, w.device)
        cached = self.__dict__.get("_prepared")
        if cached is None or cached[0] != key:
            # serving threads fill the cache under a lock, each on its own
            # CUDA stream: the weight is published only once its stream has
            # finished writing it, so another stream never reads it early
            with _PREPARE_LOCK:
                cached = self.__dict__.get("_prepared")
                if cached is None or cached[0] != key:
                    with torch.no_grad():
                        prep = (conv_ops.prepare_weight(w) if impl == "pallas"
                                else winograd_ops.prepare_weight(w))
                    if prep.is_cuda:
                        torch.cuda.current_stream(prep.device).synchronize()
                    cached = self.__dict__["_prepared"] = (key, prep)
        return cached[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self._parameters["weight"]
        impl = None
        if self.groups == 1 and tuple(self.dilation) == (1, 1):
            impl = conv_impl_for(x.shape, weight.shape, self.stride,
                                 self.padding, x.dtype)
        if impl is None:
            return self._conv_forward(x, weight, self.bias)
        fn = conv_ops.conv3x3 if impl == "pallas" else winograd_ops.winograd3x3
        bias = (self.bias if self.bias is not None
                else torch.zeros_like(weight[:, 0, 0, 0]))
        if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                        or bias.requires_grad):
            return conv_ops.KernelConvFunction.apply(x, weight, bias, fn)
        if x.device.type == "cpu":  # the plain version rearranges itself
            return fn(x, weight, bias)
        return fn(x, weight, bias, prepared=self.prepared_weight(impl))


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

