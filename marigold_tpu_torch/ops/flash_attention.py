"""Flash attention for long self-attention: hand-written Hopper kernels
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`) and their plain
PyTorch versions.

Replaces the TPU package's `marigold_tpu/ops/flash_attention.py` kernels:
  * serving forward, `_flash_dt_impl` and its three Pallas kernels:
    `_flash_kernel_dt_shifted` (64-wide UNet heads),
    `_flash_kernel_dt_shifted_kblocked` (the 512-wide VAE mid head) and
    `_flash_kernel_dt` (exact online softmax, the parity pin);
  * training, the `flash_attention_dt` custom VJP: `_flash_dt_impl_lse`
    (online forward that also returns the row logsumexp) and the two
    backward kernels of `_flash_dt_bwd_pallas` (dQ; dK and dV).
The TPU kernels take a `[BH, D, N]` layout that keeps the head dim in
sublanes; that is a TPU-lane artifact, so the port takes q/k/v as the
`[B, N, C]` token tensors the callers hold and the kernels read each head by
its channel offset.

Softmax modes (see the TPU module's notes for the numerical design):
  * "shifted": p = exp(min(s - shift_row, 75)) with shift_row = max of the
    row's logits over a strided K subsample (stride max(1, nk // 128)) + 40.
    The shift is a small product outside the kernel (`row_shift`).
  * "online": exact running-max softmax.

Under autograd (`FlashAttentionFunction`, which `ops/attention.py` calls
when an input requires grad) the forward is the exact online softmax with
the logsumexp whatever the serving mode, and the backward recomputes P from
it, as the TPU package's `_flash_dt_fwd`/`_flash_dt_bwd` do. The kernels
for that take 64-wide heads; other widths (the 512-wide VAE head) take the
serving forward and the plain backward `flash_attention_bwd_plain`.

On the H100 the kernels are bound by tensor-core throughput (about N/2 FLOP
per byte at the UNet shapes); the notes in the .cu files say what this
first design does about it and what it leaves to later work.

Each wrapper launches its kernel for a CUDA tensor, or raises; it runs the
plain version only for a tensor on the CPU. The raw kernel wrappers are not
differentiable and raise when called with grad enabled on an input that
requires grad. `launches` counts kernel launches by variant
("shifted_d64", "shifted_d512", "online_d64", "online_d512", "lse_d64",
"bwd_dq_d64", "bwd_dkv_d64").
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
TRAIN_HEAD_DIMS = (64,)  # the lse forward and the backward kernels
BWD_CHUNK = 1024  # query rows per chunk of the plain backward

SOURCES = ("flash_attention.cu",)
BWD_SOURCES = ("flash_attention_bwd.cu",)

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


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _accum_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for float64 inputs (so that gradcheck can hold the
    plain versions to float64 precision)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _plain_forward(q, k, v, num_heads, softmax, shift=None):
    """(out [B, Nq, C] in q's dtype, lse [B*H, Nq] fp32 or None)."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"unknown softmax mode: {softmax!r}")
    b, nq, c = q.shape
    scale = 1.0 / math.sqrt(c // num_heads)
    acc = _accum_dtype(q)
    s = torch.matmul(
        _heads(q, num_heads).to(acc), _heads(k, num_heads).to(acc).transpose(-1, -2)
    ) * scale
    m = None
    if softmax == "shifted":
        if shift is None:
            shift = row_shift(q, k, num_heads)
        p = torch.exp(torch.clamp(s - shift.reshape(b, num_heads, nq, 1),
                                  max=EXP_CLAMP))
    else:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.matmul(p.to(q.dtype).to(acc), _heads(v, num_heads).to(acc)) / l
    lse = None if m is None else (m + torch.log(l)).reshape(b * num_heads, nq)
    return _unheads(o.to(q.dtype)), lse


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    softmax: str = "shifted", shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch. q: [B, Nq, C], k/v: [B, Nk, C]
    -> [B, Nq, C] in q's dtype. fp32 logits, sums and accumulation; the
    probabilities meet V in the storage dtype, as in the kernels."""
    return _plain_forward(q, k, v, num_heads, softmax, shift)[0]


def flash_attention_lse_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward's function in plain PyTorch (TPU
    `_flash_dt_impl_lse`): the exact online-softmax output [B, Nq, C] and
    the row logsumexp of the scaled logits, m + log(max(l, 1e-30)),
    [B*H, Nq] fp32."""
    return _plain_forward(q, k, v, num_heads, "online")


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact attention gradients (dq, dk, dv) in the inputs' dtypes, in
    chunks of BWD_CHUNK query rows so the fp32 [chunk, Nk] logits are the
    largest temporary: the TPU package's `_flash_dt_bwd_xla`. With
    S = QK^T*s, P = softmax(S), O = PV:
      dV = P^T dO;  dP = dO V^T;  dS = P*(dP - rowsum(dP*P));
      dQ = dS K * s;  dK = dS^T Q * s,
    dS and P rounded to the storage dtype before their products."""
    c = q.shape[2]
    scale = 1.0 / math.sqrt(c // num_heads)
    acc = _accum_dtype(q)
    qh, gh = _heads(q, num_heads), _heads(dout, num_heads)
    kh, vh = _heads(k, num_heads).to(acc), _heads(v, num_heads).to(acc)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    dq = []
    for r0 in range(0, q.shape[1], BWD_CHUNK):
        q_c = qh[:, :, r0:r0 + BWD_CHUNK].to(acc)
        g_c = gh[:, :, r0:r0 + BWD_CHUNK].to(acc)
        p = torch.softmax(torch.matmul(q_c, kh.transpose(-1, -2)) * scale, -1)
        dp = torch.matmul(g_c, vh.transpose(-1, -2))
        r = (dp * p).sum(-1, keepdim=True)
        ds = (p * (dp - r)).to(k.dtype).to(acc)
        dq.append(torch.matmul(ds, kh) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), q_c) * scale
        dv += torch.matmul(p.to(dout.dtype).to(acc).transpose(-1, -2), g_c)
    return (_unheads(torch.cat(dq, dim=2)).to(q.dtype),
            _unheads(dk).to(k.dtype), _unheads(dv).to(v.dtype))


def _bind(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int) -> None:
    """argtypes of `name`: n_ptr pointers, n_int ints, the fp32 scale, the
    stream; returns int (a cudaError_t)."""
    fn = getattr(lib, name)
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.mt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mt_cuda_error_string.restype = ctypes.c_char_p


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
    _bind(lib, "mt_flash_attention_fwd_lse", 5, 8)
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("flash_attention_bwd", BWD_SOURCES)
    _bind(lib, "mt_flash_attention_bwd_dq", 7, 7)
    _bind(lib, "mt_flash_attention_bwd_dkv", 8, 7)
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.mt_cuda_error_string(err).decode()} (cudaError {err})"
        )


def _check_inputs(q, k, v, num_heads, softmax="online"):
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


def _check_cuda(tensors: dict, head_dim: int, head_dims: tuple,
                b_h: int) -> None:
    """What the CUDA kernels take: bf16, contiguous, 16-byte aligned, a
    head width they are instantiated for, no autograd."""
    q = next(iter(tensors.values()))
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dtype == torch.float32:
        raise NotImplementedError(
            "flash attention on CUDA takes bf16; the fp32 kernel path is a "
            "ROADMAP item"
        )
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash attention on CUDA takes bf16, got {q.dtype}")
    if head_dim not in head_dims:
        raise ValueError(f"head dim {head_dim} not in the kernel's {head_dims}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise RuntimeError(
            "the flash-attention kernels are not differentiable: with grad "
            "enabled call FlashAttentionFunction (ops/attention.py's "
            "dispatch_attention does)"
        )
    if b_h > 65535:
        raise ValueError(f"B*H={b_h} exceeds the grid's y limit")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    softmax: str = "shifted",
) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d)) V per head. q: [B, Nq, C], k/v: [B, Nk, C]
    -> [B, Nq, C]. On a CUDA tensor this launches the Hopper kernel (bf16
    only; head dim 64 or 512; contiguous inputs; no autograd) or raises; on
    a CPU tensor it runs `flash_attention_plain`."""
    _check_inputs(q, k, v, num_heads, softmax)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, softmax)
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    _check_cuda({"q": q, "k": k, "v": v}, d, HEAD_DIMS, b * num_heads)

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
    _raise_on(lib, err, "flash attention")
    launches[f"{softmax}_d{d}"] += 1
    return out


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (out [B, Nq, C], lse [B*H, Nq] fp32), exact
    online softmax. On a CUDA tensor this launches the Hopper kernel (bf16,
    head dim 64) or raises; on a CPU tensor it runs
    `flash_attention_lse_plain`."""
    _check_inputs(q, k, v, num_heads)
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, num_heads)
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    _check_cuda({"q": q, "k": k, "v": v}, d, TRAIN_HEAD_DIMS, b * num_heads)
    out = torch.empty_like(q)
    lse = torch.empty((b * num_heads, nq), device=q.device, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.mt_flash_attention_fwd_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, num_heads, nq, nk, d, c, c, c,
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "flash attention lse")
    launches[f"lse_d{d}"] += 1
    return out, lse


def row_delta(out: torch.Tensor, dout: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, [B*H, Nq] fp32: the plain op the
    TPU wrapper computes outside its backward kernels
    (`_flash_dt_bwd_pallas`)."""
    b, nq, c = out.shape
    prod = dout.float() * out.float()
    return (prod.reshape(b, nq, num_heads, c // num_heads).sum(-1)
            .transpose(1, 2).reshape(b * num_heads, nq).contiguous())


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention gradients (dq, dk, dv) from the training forward's out and
    lse. On a CUDA tensor this launches the dQ kernel and the dK/dV kernel
    (bf16, head dim 64) or raises; on a CPU tensor it runs
    `flash_attention_bwd_plain` (which recomputes the softmax itself)."""
    _check_inputs(q, k, v, num_heads)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, num_heads)
    b, nq, c = q.shape
    d = c // num_heads
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} / out {tuple(out.shape)} "
                         f"must match q {tuple(q.shape)}")
    if lse.shape != (b * num_heads, nq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 [{b * num_heads}, {nq}]")
    _check_cuda({"q": q, "k": k, "v": v, "dout": dout}, d, TRAIN_HEAD_DIMS,
                b * num_heads)
    delta = row_delta(out, dout, num_heads)
    return (flash_attention_bwd_dq(q, k, v, dout, lse, delta, num_heads),
            *flash_attention_bwd_dkv(q, k, v, dout, lse, delta, num_heads))


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, num_heads: int
                           ) -> torch.Tensor:
    """dQ [B, Nq, C] by the dQ kernel: lse and delta are [B*H, Nq] fp32
    (`flash_attention_lse`, `row_delta`). Unchecked: `flash_attention_bwd`
    checks the arguments before it calls this."""
    b, nq, c = q.shape
    d = c // num_heads
    dq = torch.empty_like(q)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.mt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, num_heads, nq, k.shape[1], d, c, c, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "flash attention dQ")
    launches[f"bwd_dq_d{d}"] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, num_heads: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, Nk, C] by the dK/dV kernel (CUDA bf16 only), arguments
    as for `flash_attention_bwd_dq`."""
    b, nq, c = q.shape
    d = c // num_heads
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.mt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, num_heads, nq, k.shape[1], d, c, c, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "flash attention dK/dV")
    launches[f"bwd_dkv_d{d}"] += 1
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: the port of the TPU package's
    `flash_attention_dt` custom VJP (`_flash_dt_fwd`, `_flash_dt_bwd`).

    apply(q, k, v, num_heads, softmax) with q: [B, Nq, C], k/v: [B, Nk, C].
    For 64-wide heads the forward is the exact online softmax with the row
    logsumexp (`flash_attention_lse`), whatever the serving `softmax` mode,
    and the backward runs the dQ and dK/dV kernels (`flash_attention_bwd`).
    Other widths (the 512-wide VAE head, whose rows the TPU package's
    `_use_pallas_bwd` also rejects) run the serving forward in `softmax`
    mode and the plain chunked backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, softmax: str = "shifted"):
        _check_inputs(q, k, v, num_heads, softmax)
        ctx.num_heads = num_heads
        ctx.kernel_bwd = q.shape[2] // num_heads in TRAIN_HEAD_DIMS
        if ctx.kernel_bwd:
            out, lse = flash_attention_lse(q, k, v, num_heads)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = flash_attention(q, k, v, num_heads, softmax)
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, dout):
        dout = dout.contiguous()
        if ctx.kernel_bwd:
            q, k, v, out, lse = ctx.saved_tensors
            grads = flash_attention_bwd(q, k, v, out, lse, dout, ctx.num_heads)
        else:
            q, k, v = ctx.saved_tensors
            grads = flash_attention_bwd_plain(q, k, v, dout, ctx.num_heads)
        return (*grads, None, None)
