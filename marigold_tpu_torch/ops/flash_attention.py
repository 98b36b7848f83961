"""Flash-attention forward for long self-attention: a hand-written Hopper
kernel (`csrc/flash_attention.cu`) and its plain PyTorch version.

Replaces the TPU package's `marigold_tpu/ops/flash_attention.py:_flash_dt_impl`
and its three forward Pallas kernels: `_flash_kernel_dt_shifted` (64-wide UNet
heads), `_flash_kernel_dt_shifted_kblocked` (the 512-wide VAE mid head) and
`_flash_kernel_dt` (exact online softmax, the parity pin). The TPU kernels
take a `[BH, D, N]` layout that keeps the head dim in sublanes; that is a
TPU-lane artifact, so the port takes q/k/v as the `[B, N, C]` token tensors
the callers hold and the kernel reads each head by its channel offset.

Softmax modes (see the TPU module's notes for the numerical design):
  * "shifted": p = exp(min(s - shift_row, 75)) with shift_row = max of the
    row's logits over a strided K subsample (stride max(1, nk // 128)) + 40.
    The shift is a small product outside the kernel (`row_shift`).
  * "online": exact running-max softmax.

On the H100 the kernel is bound by tensor-core throughput (about N/2 FLOP
per byte at the serving shapes); the source note in the .cu file says what
this first design does about it and what it leaves to later work.

`flash_attention` launches the kernel for a CUDA tensor, or raises; it runs
the plain version only for a tensor on the CPU. `launches` counts kernel
launches by variant ("shifted_d64", "shifted_d512", "online_d64",
"online_d512").
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from marigold_tpu_torch.ops import cuda_build

SHIFT_MARGIN = 40.0  # marigold_tpu/ops/flash_attention.py:_SHIFT_MARGIN
SHIFT_SAMPLE_TARGET = 128  # ~128 sampled K columns per row
EXP_CLAMP = 75.0
SOFTMAX_MODES = ("shifted", "online")
HEAD_DIMS = (64, 512)  # instantiated in the CUDA source

SOURCES = ("flash_attention.cu",)

launches: collections.Counter = collections.Counter()


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, C/H]."""
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def row_shift(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-query-row softmax shift [B*H, Nq] fp32: max over a strided K
    subsample of the fp32 logits, plus the margin (TPU wrapper
    `_flash_dt_impl`, flash_attention.py:366-373; stride from the unpadded
    nk)."""
    b, nq, c = q.shape
    nk = k.shape[1]
    scale = 1.0 / math.sqrt(c // num_heads)
    stride = max(1, nk // SHIFT_SAMPLE_TARGET)
    qh = _heads(q, num_heads).float()
    kh = _heads(k[:, ::stride], num_heads).float()
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    return (s.amax(-1) + SHIFT_MARGIN).reshape(b * num_heads, nq).contiguous()


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    softmax: str = "shifted", shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch. q: [B, Nq, C], k/v: [B, Nk, C]
    -> [B, Nq, C] in q's dtype. fp32 logits, sums and accumulation; the
    probabilities meet V in the storage dtype, as in the kernels."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"unknown softmax mode: {softmax!r}")
    b, nq, c = q.shape
    scale = 1.0 / math.sqrt(c // num_heads)
    s = torch.matmul(
        _heads(q, num_heads).float(), _heads(k, num_heads).float().transpose(-1, -2)
    ) * scale
    if softmax == "shifted":
        if shift is None:
            shift = row_shift(q, k, num_heads)
        p = torch.exp(torch.clamp(s - shift.reshape(b, num_heads, nq, 1),
                                  max=EXP_CLAMP))
    else:
        p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), _heads(v, num_heads).float())
    o = o / torch.clamp(l, min=1e-30)
    return o.to(q.dtype).transpose(1, 2).reshape(b, nq, c)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("flash_attention", SOURCES)
    fn = lib.mt_flash_attention_fwd
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.mt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(q, k, v, num_heads, softmax):
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"unknown softmax mode: {softmax!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be [B, N, C], got {tuple(t.shape)}")
    b, nq, c = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != c:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if c % num_heads:
        raise ValueError(f"C={c} is not divisible by {num_heads} heads")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    softmax: str = "shifted",
) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d)) V per head. q: [B, Nq, C], k/v: [B, Nk, C]
    -> [B, Nq, C]. On a CUDA tensor this launches the Hopper kernel (bf16
    only; head dim 64 or 512; contiguous inputs) or raises; on a CPU tensor
    it runs `flash_attention_plain`."""
    _check_inputs(q, k, v, num_heads, softmax)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, softmax)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dtype == torch.float32:
        raise NotImplementedError(
            "flash attention on CUDA takes bf16; the fp32 kernel path is a "
            "ROADMAP item"
        )
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash attention on CUDA takes bf16, got {q.dtype}")
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if b * num_heads > 65535:
        raise ValueError(f"B*H={b * num_heads} exceeds the grid's y limit")

    shift = row_shift(q, k, num_heads) if softmax == "shifted" else None
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.mt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            shift.data_ptr() if shift is not None else None, out.data_ptr(),
            b, num_heads, nq, nk, d, c, c, c, 1.0 / math.sqrt(d),
            int(softmax == "online"), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash attention kernel launch failed: "
            f"{lib.mt_cuda_error_string(err).decode()} (cudaError {err})"
        )
    launches[f"{softmax}_d{d}"] += 1
    return out
