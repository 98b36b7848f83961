"""Flash attention for long self-attention: hand-written Hopper kernels
(`csrc/flash_fwd_sm90.cu` for every 64-wide bf16 forward,
`csrc/flash_fwd_d512_sm90.cu` for the 512-wide one, `csrc/flash_attention.cu`
for their C entry points, `csrc/flash_bwd_sm90.cu` for the dQ and dK/dV
backward; in fp32 `csrc/flash_fwd_d64_f32_sm90.cu` for the 64-wide
forwards, `csrc/flash_fwd_d512_f32_sm90.cu` for the 512-wide one,
`csrc/flash_bwd_dq_f32_sm90.cu` for dQ, `csrc/flash_bwd_dkv_f32_sm90.cu` for
dK/dV and `csrc/tf32_split.cu` for the operand split they all read) and
their plain PyTorch versions.

Replaces the TPU package's `marigold_tpu/ops/flash_attention.py` kernels:
  * serving forward, `_flash_dt_impl` and its three Pallas kernels:
    `_flash_kernel_dt_shifted` (64-wide UNet heads),
    `_flash_kernel_dt_shifted_kblocked` (the 512-wide VAE mid head) and
    `_flash_kernel_dt` (exact online softmax, the parity pin);
  * training, the `flash_attention_dt` custom VJP: `_flash_dt_impl_lse`
    (online forward that also returns the row logsumexp) and the two
    backward kernels of `_flash_dt_bwd_pallas` (dQ; dK and dV);
  * the first version's folded entry point `flash_attention` / `_flash_kernel`
    (`[BH, N, D]`, D zero-padded to 128 on the TPU): `flash_attention_folded`
    launches the online kernel on the folded tensor as one head.
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

fp32 storage takes every kernel to an fp32-accurate design, as the Pallas
kernels take fp32 storage: the serving forwards in both softmax modes and
the folded entry (`--full_precision`), the training forward with the
logsumexp and the dQ and dK/dV backward (fine-tuning on fp32 weights,
`compute_dtype` fp32), P and dS in fp32. Every fp32 kernel runs 3xTF32
products on the tensor cores: each operand x is split into tf32 parts
hi + lo by one launch of `csrc/tf32_split.cu` (`split_tf32`; the plain
emulation is `split_tf32_plain`, `transpose_tf32_plain`,
`matmul_tf32x3_plain`) before each forward, and once per backward for both
backward kernels (`split_bwd_f32`); the dQ kernel also computes delta and
writes the padded statistics the dK/dV kernel reads. Their launches count
in `launches_f32`.

On the H100 the bf16 kernels are bound by tensor-core throughput (about N/2
FLOP per byte at the UNet shapes); the notes in the .cu files say what each
design does about it and, for the 512-wide forward, what was measured to
bind it. Every kernel reads q/k/v (the backward also dO) and writes its
outputs through TMA tensor maps, whose preconditions `check_tma` holds: a
16-byte aligned base, a row stride that is a multiple of 16 bytes and at
least one row (the fp32 kernels' float4 loads need the same). A tensor that
breaks them raises; it is never copied into shape.

Each wrapper launches its kernel for a CUDA tensor, or raises; it runs the
plain version only for a tensor on the CPU. The raw kernel wrappers are not
differentiable and raise when called with grad enabled on an input that
requires grad. `launches` counts kernel launches by variant
("shifted_d64", "shifted_d512", "online_d64", "online_d512", "lse_d64",
"bwd_dq_d64", "bwd_dkv_d64", "folded_d64", "folded_d512") for bf16, and
`launches_f32` those of the fp32 kernels by the same names, and the
operand split as "tf32_split".
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from marigold_tpu_torch.ops import cuda_build

SHIFT_MARGIN = 40.0  # marigold_tpu/ops/flash_attention.py:_SHIFT_MARGIN
SHIFT_SAMPLE_TARGET = 128  # ~128 sampled K columns per row
EXP_CLAMP = 75.0
SOFTMAX_MODES = ("shifted", "online")
HEAD_DIMS = (64, 512)  # instantiated in the CUDA sources
TRAIN_HEAD_DIMS = (64,)  # the lse forward and the backward kernels
BWD_CHUNK = 1024  # query rows per chunk of the plain backward
# The backward kernels read lse and delta as [B*H, Nq] rows padded to a
# multiple of STAT_PAD, lse with LSE_PAD (marigold_tpu/ops/flash_attention.py:
# _LSE_PAD: exp(s - 1e30) == 0 drops the padded query rows) and delta with 0.
STAT_PAD = 64
LSE_PAD = 1e30

SOURCES = ("flash_attention.cu", "flash_fwd_sm90.cu", "flash_fwd_d512_sm90.cu")
BWD_SOURCES = ("flash_bwd_sm90.cu",)
F32_SOURCES = ("flash_fwd_d64_f32_sm90.cu", "flash_fwd_d512_f32_sm90.cu")
F32_BWD_SOURCES = ("flash_bwd_dq_f32_sm90.cu", "flash_bwd_dkv_f32_sm90.cu")
SPLIT_SOURCES = ("tf32_split.cu",)
# The transposed tf32 copies permute each group of 8 columns so that an
# m64nN accumulator's registers are a tf32 A fragment (csrc/tf32x3.cuh):
# stored column 8g + i holds row 8g + TF32_PERM[i].
TF32_PERM = (0, 2, 4, 6, 1, 3, 5, 7)
TF32_PAD = 8  # the transposed copies' columns: N rounded up to this
KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # every kernel has both

launches = cuda_build.LaunchCounter()
launches_f32 = cuda_build.LaunchCounter()


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


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits, to nearest, ties away from
    zero) on the bits of its int32 view, as `cvt.rna.tf32.f32` rounds;
    infinities and NaNs pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an fp32 tensor as `csrc/tf32_split.cu` and the kernels
    split it: hi = rna_tf32(x), lo = rna_tf32(x - hi), both tf32 values
    stored as fp32; x - hi is exact, so hi + lo carries x to ~2^-22."""
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def transpose_tf32_plain(x: torch.Tensor) -> torch.Tensor:
    """[B, N, C] -> the transposed layout of the split's transposed copies:
    [B, C, NP], NP = N rounded up to TF32_PAD, rows past N taken as zeros,
    stored column 8g + i holding row 8g + TF32_PERM[i]."""
    b, n, c = x.shape
    npad = -(-n // TF32_PAD) * TF32_PAD
    xt = x.new_zeros((b, c, npad))
    xt[:, :, :n] = x.transpose(1, 2)
    pos = torch.arange(npad, device=x.device)
    perm = torch.tensor(TF32_PERM, device=x.device)
    return xt[:, :, pos - pos % TF32_PAD + perm[pos % TF32_PAD]]


def matmul_tf32x3_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 as the 3xTF32 kernels compute it: each operand split by
    `split_tf32_plain`, then lo.hi + hi.lo + hi.hi summed in fp32 (each
    product of two tf32 values is exact in fp32), lo.lo dropped. For the
    CPU tests; nothing on the main path calls it."""
    a_hi, a_lo = split_tf32_plain(a)
    b_hi, b_lo = split_tf32_plain(b)
    return a_hi @ b_hi + (a_lo @ b_hi + a_hi @ b_lo)


def _split_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("tf32_split", SPLIT_SOURCES)
    fn = lib.mt_tf32_split
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.mt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def split_tf32(rows: list, cols: list = ()) -> list:
    """The 3xTF32 kernels' operands: [(hi, lo)] of each fp32 [B, N, C]
    tensor in `rows` (in its own layout), then of each in `cols` transposed
    (`transpose_tf32_plain`'s layout), all with one B and C. On CUDA
    tensors this is one launch of `csrc/tf32_split.cu` (at most 8 tensors,
    C a multiple of 32), counted as "tf32_split" in `launches_f32`; on CPU
    tensors it runs the plain versions."""
    xs = [*rows, *cols]
    if xs[0].device.type == "cpu":
        return ([split_tf32_plain(x) for x in rows]
                + [split_tf32_plain(transpose_tf32_plain(x)) for x in cols])
    b, _, c = xs[0].shape
    for x in xs:
        if x.dtype != torch.float32 or x.ndim != 3 or x.shape[0] != b or \
                x.shape[2] != c or not x.is_contiguous() or x.device != xs[0].device:
            raise ValueError(f"split_tf32 takes contiguous fp32 [{b}, N, {c}] "
                             f"tensors on one device, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    outs = [(torch.empty_like(x), torch.empty_like(x)) for x in rows]
    for x in cols:
        npad = -(-x.shape[1] // TF32_PAD) * TF32_PAD
        outs.append(tuple(x.new_empty((b, c, npad)) for _ in range(2)))
    n = len(xs)
    ptrs = ctypes.c_void_p * n
    lib = _split_library()
    with torch.cuda.device(xs[0].device):
        err = lib.mt_tf32_split(
            ptrs(*(x.data_ptr() for x in xs)),
            ptrs(*(hi.data_ptr() for hi, _ in outs)),
            ptrs(*(lo.data_ptr() for _, lo in outs)),
            (ctypes.c_int * n)(*(x.shape[1] for x in xs)),
            (ctypes.c_int * n)(*([0] * len(rows) + [1] * len(cols))),
            n, b, c, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "tf32 split")
    launches_f32.add("tf32_split")
    return outs


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


def _f32_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("flash_attention_f32", F32_SOURCES)
    _bind(lib, "mt_flash_fwd_d64_f32", 8, 7)
    _bind(lib, "mt_flash_fwd_d512_f32", 8, 7)
    _bind(lib, "mt_flash_fwd_lse_f32", 8, 6)
    return lib


def _f32_bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("flash_attention_bwd_f32", F32_BWD_SOURCES)
    _bind(lib, "mt_flash_bwd_dq_f32", 16, 7)
    _bind(lib, "mt_flash_bwd_dkv_f32", 16, 7)
    return lib


def _split_fwd_f32(q, k, v) -> list:
    """An fp32 forward's operands after their split: q and k hi and lo in
    their layout, then v's transposed hi and lo."""
    return [t for pair in split_tf32([q, k], [v]) for t in pair]


def _launch_forward(q, k, v, shift, out, b: int, heads: int, d: int,
                    ld: int, online: bool, variant: str) -> None:
    """One serving forward on q's stream: the bf16 Hopper kernels or, in
    fp32, the operand split and then the 3xTF32 kernel of the head width,
    counted as `variant` in `launches` or `launches_f32`."""
    nq, nk, scale = q.shape[1], k.shape[1], 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream().cuda_stream
    shift_ptr = shift.data_ptr() if shift is not None else None
    if q.dtype == torch.float32:
        lib, counter = _f32_library(), launches_f32
        fn = lib.mt_flash_fwd_d512_f32 if d == 512 else lib.mt_flash_fwd_d64_f32
        operands = _split_fwd_f32(q, k, v)
        with torch.cuda.device(q.device):
            err = fn(*(t.data_ptr() for t in operands), shift_ptr,
                     out.data_ptr(), b, heads, nq, nk, ld, ld, int(online),
                     scale, stream)
    else:
        lib, counter = _library(), launches
        with torch.cuda.device(q.device):
            err = lib.mt_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), shift_ptr,
                out.data_ptr(), b, heads, nq, nk, d, ld, ld, ld, scale,
                int(online), stream,
            )
    _raise_on(lib, err, f"flash attention ({q.dtype})")
    counter.add(variant)


def _bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("flash_attention_bwd", BWD_SOURCES)
    _bind(lib, "mt_flash_attention_bwd_dq", 7, 8)
    _bind(lib, "mt_flash_attention_bwd_dkv", 8, 8)
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
    """What the CUDA kernels take: bf16 or fp32 (KERNEL_DTYPES; fp16 and
    others raise ValueError), contiguous, 16-byte aligned, a head width they
    are instantiated for, no autograd."""
    q = next(iter(tensors.values()))
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"flash attention on CUDA takes {KERNEL_DTYPES}, got {q.dtype}")
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


def check_tma(tensors: dict) -> None:
    """What the TMA maps of the kernels (`csrc/flash_fwd_sm90.cu`,
    `csrc/flash_fwd_d512_sm90.cu`, `csrc/flash_bwd_sm90.cu`) take of each
    [B, N, C] tensor: at least one row, a 16-byte aligned base and a row
    stride that is a multiple of 16 bytes. Raises ValueError."""
    for name, t in tensors.items():
        if t.shape[0] < 1 or t.shape[1] < 1:
            raise ValueError(f"{name} {tuple(t.shape)} has no rows")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for TMA")
        if t.stride(1) * t.element_size() % 16:
            raise ValueError(
                f"{name}'s row stride of {t.stride(1) * t.element_size()} "
                "bytes is not a multiple of 16, which TMA needs")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    softmax: str = "shifted",
) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d)) V per head. q: [B, Nq, C], k/v: [B, Nk, C]
    -> [B, Nq, C]. On a CUDA tensor this launches the Hopper kernel (bf16,
    or fp32: the split, then `csrc/flash_fwd_d64_f32_sm90.cu` at head dim 64
    or `csrc/flash_fwd_d512_f32_sm90.cu` at 512; head dim 64 or 512;
    contiguous inputs; no autograd) or raises; on a CPU tensor it runs
    `flash_attention_plain`."""
    _check_inputs(q, k, v, num_heads, softmax)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, softmax)
    b, _, c = q.shape
    d = c // num_heads
    _check_cuda({"q": q, "k": k, "v": v}, d, HEAD_DIMS, b * num_heads)
    check_tma({"q": q, "k": k, "v": v})

    shift = row_shift(q, k, num_heads) if softmax == "shifted" else None
    out = torch.empty_like(q)
    _launch_forward(q, k, v, shift, out, b, num_heads, d, c,
                    softmax == "online", f"{softmax}_d{d}")
    return out


def flash_attention_folded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Exact softmax(Q K^T / sqrt(D)) V on folded tensors: q [BH, Nq, D],
    k/v [BH, Nk, D] -> [BH, Nq, D]; the TPU package's first
    `flash_attention` (`marigold_tpu/ops/flash_attention.py:471`). On a CUDA
    tensor this launches the online kernel with BH batches of one D-wide
    head (bf16 or fp32, D 64 or 512; no padding of D or N: the kernel masks
    ragged N) or raises; on a CPU tensor it runs the plain online forward
    with one head."""
    _check_inputs(q, k, v, 1)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, 1, "online")
    bh, nq, d = q.shape
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"the folded flash kernel takes D in {HEAD_DIMS}, got {d}; other "
            "head widths are a ROADMAP item (queue 2)")
    _check_cuda({"q": q, "k": k, "v": v}, d, HEAD_DIMS, bh)
    check_tma({"q": q, "k": k, "v": v})
    out = torch.empty_like(q)
    _launch_forward(q, k, v, None, out, bh, 1, d, d, True, f"folded_d{d}")
    return out


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (out [B, Nq, C], lse [B*H, Nq] fp32), exact
    online softmax. On a CUDA tensor this launches the Hopper kernel (bf16,
    or fp32: the split, then `csrc/flash_fwd_d64_f32_sm90.cu`; head dim 64)
    or raises; on a CPU tensor it runs `flash_attention_lse_plain`."""
    _check_inputs(q, k, v, num_heads)
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, num_heads)
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    _check_cuda({"q": q, "k": k, "v": v}, d, TRAIN_HEAD_DIMS, b * num_heads)
    check_tma({"q": q, "k": k, "v": v})
    out = torch.empty_like(q)
    lse = torch.empty((b * num_heads, nq), device=q.device, dtype=torch.float32)
    if q.dtype == torch.float32:
        lib, counter = _f32_library(), launches_f32
        operands = _split_fwd_f32(q, k, v)
        fn, args = lib.mt_flash_fwd_lse_f32, (
            *(t.data_ptr() for t in operands), out.data_ptr(),
            lse.data_ptr(), b, num_heads, nq, nk, c, c)
    else:
        lib, counter = _library(), launches
        fn, args = lib.mt_flash_attention_fwd_lse, (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, num_heads, nq, nk, d, c, c, c)
    with torch.cuda.device(q.device):
        err = fn(*args, 1.0 / math.sqrt(d),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, f"flash attention lse ({q.dtype})")
    counter.add(f"lse_d{d}")
    return out, lse


def row_delta(out: torch.Tensor, dout: torch.Tensor, num_heads: int,
              pad: int = 0) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, [B*H, Nq + pad] fp32 with zeros in
    the `pad` columns: the plain op the TPU wrapper computes outside its
    backward kernels (`_flash_dt_bwd_pallas`), written by the reduction
    into the padded rows the kernels read."""
    b, nq, c = out.shape
    delta = out.new_zeros((b * num_heads, nq + pad), dtype=torch.float32)
    prod = (dout.float() * out).view(b, nq, num_heads, c // num_heads)
    torch.sum(prod, -1, out=delta.view(b, num_heads, nq + pad)[:, :, :nq]
              .transpose(1, 2))
    return delta


def bwd_stats(out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' row statistics: lse and `row_delta`, each
    [B*H, round_up(Nq, STAT_PAD)] fp32, padded with LSE_PAD and 0 as the TPU
    wrapper pads them (one small copy of lse): each 64-row stage of the dK/dV
    kernel then reads its rows, padded ones included, as one 16-byte-aligned
    bulk copy."""
    bh, nq = lse.shape
    pad = -nq % STAT_PAD
    lse_p = lse.new_full((bh, nq + pad), LSE_PAD)
    lse_p[:, :nq] = lse
    return lse_p, row_delta(out, dout, num_heads, pad)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention gradients (dq, dk, dv) from the training forward's out and
    lse. On a CUDA tensor this launches the dQ kernel and the dK/dV kernel
    (bf16 after `bwd_stats`; fp32 after one split, `split_bwd_f32`: dQ on
    `csrc/flash_bwd_dq_f32_sm90.cu`, which also writes the padded
    statistics, dK/dV on `csrc/flash_bwd_dkv_f32_sm90.cu`; head dim 64; q,
    k, v and dout as TMA takes them, `check_tma`) or raises; on a CPU tensor
    it runs `flash_attention_bwd_plain` (which recomputes the softmax
    itself)."""
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
    check_tma({"q": q, "k": k, "v": v, "dout": dout})
    _check_cuda({"q": q, "k": k, "v": v, "dout": dout, "out": out}, d,
                TRAIN_HEAD_DIMS, b * num_heads)
    if q.dtype == torch.float32:
        parts = split_bwd_f32(q, k, v, dout)
        dq, lse_p, delta_p = flash_attention_bwd_dq_f32(
            q, k, v, out, lse, dout, num_heads, parts)
    else:
        parts = None
        lse_p, delta_p = bwd_stats(out, lse, dout, num_heads)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse_p, delta_p, num_heads)
    return (dq, *flash_attention_bwd_dkv(q, k, v, dout, lse_p, delta_p,
                                         num_heads, parts))


def split_bwd_f32(q, k, v, dout) -> list:
    """The fp32 backward's one operand split, read by both kernels: the
    (hi, lo) pairs of q, dout, k and v in their layout, then of q, dout and
    k transposed (`split_tf32`, one launch of seven jobs)."""
    return split_tf32([q, dout, k, v], [q, dout, k])


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, num_heads: int
                           ) -> torch.Tensor:
    """bf16 dQ [B, Nq, C] by `csrc/flash_bwd_sm90.cu`: lse and delta are the
    padded [B*H, round_up(Nq, STAT_PAD)] fp32 rows of `bwd_stats`.
    Unchecked but for the dtype: `flash_attention_bwd` checks the arguments
    before it calls this (fp32 takes `flash_attention_bwd_dq_f32`)."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd_dq takes bf16, got {q.dtype}")
    b, nq, c = q.shape
    d = c // num_heads
    dq = torch.empty_like(q)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.mt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, num_heads, nq, k.shape[1], d, c, c, lse.shape[1],
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, f"flash attention dQ ({q.dtype})")
    launches.add(f"bwd_dq_d{d}")
    return dq


def flash_attention_bwd_dq_f32(q, k, v, out, lse, dout, num_heads: int,
                               parts: Optional[list] = None
                               ) -> tuple[torch.Tensor, ...]:
    """fp32 (dQ [B, Nq, C], lse_p, delta_p) by
    `csrc/flash_bwd_dq_f32_sm90.cu` on `split_bwd_f32`'s pairs (`parts`, or
    one split launch here when None): the kernel computes delta =
    rowsum(dO * O) itself and writes `bwd_stats`' padded lse and delta rows
    ([B*H, round_up(Nq, STAT_PAD)] fp32), which the dK/dV kernel reads.
    `lse` is the training forward's [B*H, Nq]. Unchecked:
    `flash_attention_bwd` checks the arguments before it calls this."""
    b, nq, c = q.shape
    d = c // num_heads
    if parts is None:
        parts = split_bwd_f32(q, k, v, dout)
    ld_stat = -(-nq // STAT_PAD) * STAT_PAD
    dq = torch.empty_like(q)
    lse_p, delta_p = (lse.new_empty((b * num_heads, ld_stat)) for _ in range(2))
    lib = _f32_bwd_library()
    operands = [t for i in (0, 1, 2, 3, 6) for t in parts[i]]  # q dO k v k^T
    with torch.cuda.device(q.device):
        err = lib.mt_flash_bwd_dq_f32(
            *(t.data_ptr() for t in operands), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), lse_p.data_ptr(),
            delta_p.data_ptr(), b, num_heads, nq, k.shape[1], d, c, ld_stat,
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, f"flash attention dQ ({q.dtype})")
    launches_f32.add(f"bwd_dq_d{d}")
    return dq, lse_p, delta_p


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, num_heads: int,
                            parts: Optional[list] = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, Nk, C] by the dK/dV kernel of q's dtype: lse and delta
    the padded rows (`bwd_stats`, or in fp32 the dQ kernel's). In fp32 it
    reads `split_bwd_f32`'s pairs (`parts`, or one split launch here when
    None). Unchecked: `flash_attention_bwd` checks the arguments before it
    calls this."""
    b, nq, c = q.shape
    d = c // num_heads
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.float32:
        if parts is None:
            parts = split_bwd_f32(q, k, v, dout)
        lib, counter = _f32_bwd_library(), launches_f32
        fn = lib.mt_flash_bwd_dkv_f32
        operands = [t for pair in parts[:6] for t in pair]  # q dO k v q^T dO^T
        strides = (c,)
    else:
        lib, counter = _bwd_library(), launches
        fn = lib.mt_flash_attention_bwd_dkv
        operands, strides = [q, k, v, dout], (c, c)
    with torch.cuda.device(q.device):
        err = fn(
            *(t.data_ptr() for t in operands), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, num_heads, nq,
            k.shape[1], d, *strides, lse.shape[1], 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, f"flash attention dK/dV ({q.dtype})")
    counter.add(f"bwd_dkv_d{d}")
    return dk, dv


@torch.library.custom_op("marigold_tpu_torch::flash_attention_lse",
                         mutates_args=())
def flash_attention_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention_lse` as a dispatcher op, so that a selective
    activation-checkpoint policy can see it and keep its outputs
    (`train/train_step.py`, remat "save_heavy"): a Python call through
    ctypes is invisible to the policy and would launch again when the
    forward is recomputed in the backward, as the JAX package's remat policy
    keeps its `custom_vjp` call. Its outputs are out in q's dtype (fp32 for
    an fp32 step, so the policy keeps them in fp32) and the fp32 lse. Not
    differentiable itself: `FlashAttentionFunction` calls it."""
    out, lse = flash_attention_lse(q, k, v, num_heads)
    return out, lse


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: the port of the TPU package's
    `flash_attention_dt` custom VJP (`_flash_dt_fwd`, `_flash_dt_bwd`).

    apply(q, k, v, num_heads, softmax) with q: [B, Nq, C], k/v: [B, Nk, C].
    For 64-wide heads the forward is the exact online softmax with the row
    logsumexp (`flash_attention_lse_op`), whatever the serving `softmax` mode,
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
            out, lse = flash_attention_lse_op(q, k, v, num_heads)
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
