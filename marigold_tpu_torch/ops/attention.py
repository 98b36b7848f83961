"""Attention dispatch for the port's UNet and VAE.

Counterpart of `marigold_tpu/ops/attention.py`: unmasked self-attention on a
CUDA tensor with at least 1024 query and key tokens goes to the Hopper
flash kernel in the current softmax mode, bf16 or fp32 (`--full_precision`
reaches the fp32 kernel, as the JAX package sends fp32 to its Pallas
kernel); everything else (shorter
sequences, the length-2 empty-prompt cross-attention, masked attention and
every CPU tensor) goes to `xla_attention`, the plain fp32-softmax
attention. With grad enabled and an input that requires grad, the flash
path goes through `FlashAttentionFunction` (exact online forward with the
row logsumexp, backward kernels), as the JAX package differentiates through
its `flash_attention_dt` custom VJP; under `no_grad`/`inference_mode` the
serving kernel runs as before.

`self_attention_projected` is the TPU package's opt-in projected
self-attention (MARIGOLD_TPU_PROJECTED_ATTN=1, off by default): there its
projections are emitted in the kernel's transposed layout; here Q, K and V
come from one product with the stacked [3C, C] weight and the bf16 kernel
reads them in place at row stride 3C (`flash_attention_packed`).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from marigold_tpu_torch.ops import flash_attention as fa

FLASH_MIN_SEQ = 1024
# "shifted" (serving default) or "online" (the reference-exact pin); the
# environment variable sets the import-time mode, as in the JAX package, so
# that the parity pin reaches child processes
_FLASH_SOFTMAX = os.environ.get("MARIGOLD_TPU_FLASH_SOFTMAX", "shifted")
if _FLASH_SOFTMAX not in fa.SOFTMAX_MODES:
    raise ValueError("MARIGOLD_TPU_FLASH_SOFTMAX must be shifted|online, got "
                     f"{_FLASH_SOFTMAX!r}")


def get_flash_softmax() -> str:
    """Current flash-softmax mode ("shifted" or "online")."""
    return _FLASH_SOFTMAX


def set_flash_softmax(mode: str) -> None:
    """Pin the flash-softmax mode at runtime (the parity pin sets "online")."""
    if mode not in fa.SOFTMAX_MODES:
        raise ValueError(f"flash softmax mode must be shifted|online, got {mode!r}")
    global _FLASH_SOFTMAX
    _FLASH_SOFTMAX = mode


def use_flash(q: torch.Tensor, num_kv: int) -> bool:
    return q.is_cuda and q.shape[1] >= FLASH_MIN_SEQ and num_kv >= FLASH_MIN_SEQ


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int, mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """[B, Nq, C] x [B, Nk, C] -> [B, Nq, C]; fp32 logits and softmax, the
    probabilities meet V in the storage dtype. `mask` is added to the
    logits."""
    b, nq, c = q.shape
    nk = k.shape[1]
    hd = c // num_heads
    qh = q.reshape(b, nq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, nk, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, nk, num_heads, hd).transpose(1, 2)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(hd))
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2).reshape(b, nq, c)


def dispatch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int, mask: Optional[torch.Tensor] = None,
                       spatial=None) -> torch.Tensor:
    """Dispatching attention used by the UNet transformer blocks and the
    VAE mid block. spatial: the mesh over which the token axis is sharded
    (an image's H rows, H outermost, so each rank's tokens are one block
    in rank order); K and V are then gathered once, into one contiguous
    tensor each, and this rank's queries attend to all of them
    (`marigold_tpu/ops/attention.py:92-94`)."""
    if spatial is not None:
        kv = spatial.all_gather(torch.stack([k, v]), dim=2)
        k, v = kv[0], kv[1]
    if mask is None and use_flash(q, k.shape[1]):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad):
            return fa.FlashAttentionFunction.apply(q, k, v, num_heads,
                                                   _FLASH_SOFTMAX)
        return fa.flash_attention(q, k, v, num_heads, softmax=_FLASH_SOFTMAX)
    return xla_attention(q, k, v, num_heads, mask)


# Opt-in, read at import as in the JAX package
# (`marigold_tpu/ops/attention.py:139`), off by default.
_PROJECTED_ATTN = os.environ.get("MARIGOLD_TPU_PROJECTED_ATTN", "0") == "1"


def self_attention_projected(y: torch.Tensor, attn, num_heads: int,
                             spatial=None) -> torch.Tensor:
    """Self-attention including its four projections, the counterpart of
    `marigold_tpu/ops/attention.py:self_attention_projected`. y: [B, N, C];
    attn: the block's attention module (`models/unet.py:Attention`: to_q,
    to_k, to_v, to_out.0 and the stacked `qkv_weight()`).

    With MARIGOLD_TPU_PROJECTED_ATTN=1, where the flash kernel runs, Q, K
    and V come from one product y @ [W_q; W_k; W_v]^T, [B, N, 3C], which
    the kernel reads in place at row stride 3C (`fa.flash_attention_packed`:
    no per-head copies), then to_out. The same math as linear + attention +
    linear, which it runs instead wherever the port's dispatch would not
    launch the flash kernel (a CPU tensor, fewer than FLASH_MIN_SEQ tokens,
    `spatial`), where to_q/to_k/to_v carry a bias (as the JAX package
    falls back), and where the kernel needs contiguous operands: fp32 (the
    3xTF32 kernels read contiguous split copies) and autograd
    (`FlashAttentionFunction` saves its inputs for the backward kernels)."""
    mods = attn._modules
    qkv_mods = [mods[n] for n in ("to_q", "to_k", "to_v")]
    grad = torch.is_grad_enabled() and (y.requires_grad or any(
        m.weight.requires_grad for m in qkv_mods))
    use_projected = (
        _PROJECTED_ATTN and spatial is None and use_flash(y, y.shape[1])
        and (y.device.type == "cpu" or y.dtype in fa.PACKED_DTYPES)
        and not grad and all(m.bias is None for m in qkv_mods))
    if use_projected:
        qkv = F.linear(y, attn.qkv_weight())
        out = fa.flash_attention_packed(qkv, num_heads, _FLASH_SOFTMAX)
    else:
        q, k, v = (m(y) for m in qkv_mods)
        out = dispatch_attention(q, k, v, num_heads, spatial=spatial)
    return mods["to_out"][0](out)
