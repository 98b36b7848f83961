"""Flash attention for long self-attention: hand-written Hopper kernels
(`csrc/flash_fwd_sm90.cu` for every bf16 forward at head widths 40, 64, 80
and 160, `csrc/flash_fwd_d512_sm90.cu` for the 512-wide one,
`csrc/flash_attention.cu` for their C entry points, `csrc/flash_bwd_sm90.cu`
for the dQ and dK/dV backward at 40, 64, 80 and 160 (its dQ kernel also
computes delta and writes the padded statistics dK/dV reads); in fp32
`csrc/flash_fwd_d64_f32_sm90.cu` for the forwards at 40, 64, 80 and 160,
`csrc/flash_fwd_d512_f32_sm90.cu` for the 512-wide one,
`csrc/flash_bwd_dq_f32_sm90.cu` for dQ, `csrc/flash_bwd_dkv_f32_sm90.cu` for
dK/dV (both at 40, 64, 80 and 160) and `csrc/tf32_split.cu` for the operand
split they all read) and their plain PyTorch versions.

Replaces the TPU package's `marigold_tpu/ops/flash_attention.py` kernels:
  * serving forward, `_flash_dt_impl` and its three Pallas kernels:
    `_flash_kernel_dt_shifted` (the UNet heads: 64 wide in SD2, 40, 80 and
    160 wide in an SD1.x-class UNet),
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
    row's logits over a strided K subsample (`shift_sample`: stride
    max(1, nk // 128), at most 255 keys) + 40. The kernels at head widths
    40, 64, 80 and 160 compute it in their own launch, from a sample pass
    over those keys before their K loop (`flash_attention_shift` returns
    the shift they used); the 512-wide ones take it from `row_shift`, the
    plain version, which also runs on the CPU.
  * "online": exact running-max softmax.

Under autograd (`FlashAttentionFunction`, which `ops/attention.py` calls
when an input requires grad) the forward is the exact online softmax with
the logsumexp whatever the serving mode, and the backward recomputes P from
it, as the TPU package's `_flash_dt_fwd`/`_flash_dt_bwd` do. The kernels
for that take the UNet head widths of TRAIN_HEAD_DIMS (SD2's 64; an
SD1.x-class UNet's 40, 80 and 160), at any N (the TPU package's
`_use_pallas_bwd` sends rows over 6 MiB to its XLA backward, a VMEM
limit: the math is the same); the 512-wide VAE head (which
`_use_pallas_bwd` also keeps off its kernels) takes the serving forward and
the plain backward `flash_attention_bwd_plain`.

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
outputs through TMA tensor maps, whose preconditions `check_kernel_args`
holds: a 16-byte aligned base, a row stride and a head stride (the serving
forwards' maps are {D, H, N, B}: a box past a narrow head's D reads zeros,
never the next head) that are multiples of 16 bytes and at least one row
(the fp32 kernels' float4 loads need the same). A tensor that breaks them
raises; it is never copied into shape. `flash_attention_packed` reads q, k
and v in place in one [B, N, 3C] projection (row stride 3C), for
`ops/attention.py:self_attention_projected`.

Each wrapper launches its kernel for a CUDA tensor, or raises; it runs the
plain version only for a tensor on the CPU. The raw kernel wrappers are not
differentiable and raise when called with grad enabled on an input that
requires grad. On a CUDA tensor a wrapper checks its arguments in one pass
(`check_kernel_args`: what the kernels and their TMA maps take), reads the
raw current stream and switches the current device only when q's is
another: at the small SD1.x shapes the host time of a call is longer than
the kernel's. `launches` counts kernel launches by variant
("shifted_d<D>", "online_d<D>" and "folded_d<D>" for each D in HEAD_DIMS,
"lse_d<D>", "bwd_dq_d<D>", "bwd_dkv_d<D>" for each D in TRAIN_HEAD_DIMS)
for bf16, and
`launches_f32` those of the fp32 kernels by the same names, and the
operand split as "tf32_split".
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from marigold_tpu_torch.ops import cuda_build

SHIFT_MARGIN = 40.0  # marigold_tpu/ops/flash_attention.py:_SHIFT_MARGIN
SHIFT_SAMPLE_TARGET = 128  # ~128 sampled K columns per row
SHIFT_SAMPLE_MAX = 255  # the most a row samples: 255 keys at nk = 255
EXP_CLAMP = 75.0
SOFTMAX_MODES = ("shifted", "online")
HEAD_DIMS = (40, 64, 80, 160, 512)  # the serving forwards' instantiations
TRAIN_HEAD_DIMS = (40, 64, 80, 160)  # the lse forward and the backward kernels
# the dtypes whose kernels read q, k and v in place at any row stride
# (`flash_attention_packed`); the fp32 route splits them into contiguous
# tf32 copies first
PACKED_DTYPES = (torch.bfloat16,)
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


def shift_sample(nk: int) -> tuple[int, int]:
    """(stride, n_sub) of the shifted softmax's K subsample: the keys 0,
    stride, 2 stride, ... < nk, n_sub = ceil(nk / stride) <= SHIFT_SAMPLE_MAX
    of them, as the TPU wrapper's `kt[:, :, ::stride]` takes them
    (`_flash_dt_impl`, flash_attention.py:366; stride from the unpadded
    nk). The shifted kernels get both."""
    stride = max(1, nk // SHIFT_SAMPLE_TARGET)
    return stride, -(-nk // stride)


def row_shift(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-query-row softmax shift [B*H, Nq] fp32: max over a strided K
    subsample (`shift_sample`) of the fp32 logits, plus the margin (TPU
    wrapper `_flash_dt_impl`, flash_attention.py:366-373). The plain
    version of the shift the kernels at D < 512 compute themselves; the
    512-wide kernels read it."""
    b, nq, c = q.shape
    scale = 1.0 / math.sqrt(c // num_heads)
    stride, _ = shift_sample(k.shape[1])
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
    C a multiple of 4), counted as "tf32_split" in `launches_f32`; on CPU
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
    err = cuda_build.on_device(
        xs[0], lib.mt_tf32_split, ptrs(*(x.data_ptr() for x in xs)),
        ptrs(*(hi.data_ptr() for hi, _ in outs)),
        ptrs(*(lo.data_ptr() for _, lo in outs)),
        (ctypes.c_int * n)(*(x.shape[1] for x in xs)),
        (ctypes.c_int * n)(*([0] * len(rows) + [1] * len(cols))),
        n, b, c, cuda_build.stream_of(xs[0]))
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


@functools.cache  # bound once: every bf16 forward call goes through here
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("flash_attention", SOURCES)
    fn = lib.mt_flash_attention_fwd
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 10 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.mt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mt_cuda_error_string.restype = ctypes.c_char_p
    _bind(lib, "mt_flash_attention_fwd_lse", 5, 8)
    return lib


def _f32_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("flash_attention_f32", F32_SOURCES)
    _bind(lib, "mt_flash_fwd_f32", 8, 10)
    _bind(lib, "mt_flash_fwd_d512_f32", 8, 7)
    _bind(lib, "mt_flash_fwd_lse_f32", 8, 7)
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
                    online: bool, variant: str, shift_out=None) -> None:
    """One serving forward on q's stream: the bf16 Hopper kernels (q, k, v
    and out read at their own row strides) or, in fp32, the operand split
    of contiguous q, k, v and then the 3xTF32 kernel of the head width,
    counted as `variant` in `launches` or `launches_f32`. Shifted: `shift`
    is `row_shift`'s at D = 512 and None below, where the kernel computes
    it on `shift_sample`'s keys and writes it into `shift_out` if given."""
    nq, nk, scale = q.shape[1], k.shape[1], 1.0 / math.sqrt(d)
    stride, n_sub = (1, nk) if online else shift_sample(nk)
    stream = cuda_build.stream_of(q)
    shift_ptr = shift.data_ptr() if shift is not None else None
    out_ptr = shift_out.data_ptr() if shift_out is not None else None
    if q.dtype == torch.float32:
        lib, counter = _f32_library(), launches_f32
        operands = [t.data_ptr() for t in _split_fwd_f32(q, k, v)]
        ld = q.shape[2]
        if d == 512:
            err = cuda_build.on_device(q, lib.mt_flash_fwd_d512_f32, *operands,
                             shift_ptr, out.data_ptr(), b, heads, nq, nk, ld,
                             ld, int(online), scale, stream)
        else:
            err = cuda_build.on_device(q, lib.mt_flash_fwd_f32, *operands,
                             out.data_ptr(), out_ptr, b, heads, nq, nk, d, ld,
                             ld, int(online), stride, n_sub, scale, stream)
    else:
        lib, counter = _library(), launches
        err = cuda_build.on_device(
            q, lib.mt_flash_attention_fwd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), shift_ptr, out.data_ptr(), out_ptr, b, heads, nq,
            nk, d, q.stride(1), k.stride(1), out.stride(1), stride, n_sub,
            scale, int(online), stream)
    _raise_on(lib, err, lambda: f"flash attention ({q.dtype})")
    counter.add(variant)


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The bf16 backward library's argtypes (`csrc/flash_bwd_sm90.cu`, or
    a build of it with other flags, flash_bwd_variants.py's)."""
    _bind(lib, "mt_flash_attention_bwd_dq", 9, 8)
    _bind(lib, "mt_flash_attention_bwd_dkv", 8, 8)
    return lib


def _bwd_library() -> ctypes.CDLL:
    return bind_bwd(cuda_build.load_library("flash_attention_bwd", BWD_SOURCES))


def _raise_on(lib: ctypes.CDLL, err: int, what) -> None:
    """Raises on a nonzero cudaError; `what` names the kernel (a callable
    giving the name, so that a launch that went well formats nothing)."""
    if err != 0:
        what = what() if callable(what) else what
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.mt_cuda_error_string(err).decode()} (cudaError {err})"
        )


def _check_inputs(tensors: dict, num_heads: int,
                  softmax: str = "online") -> list:
    """The part of `check_kernel_args` that holds on any device: a softmax
    mode; each tensor of `tensors` ({"q": q, "k": k, "v": v}, then the
    backward's "dout" and "out") on q's device, of q's dtype, [B, N, C]; k
    and v of one shape with q's batch and channels; C over `num_heads`.
    The CPU paths check this alone. Returns the tensors' shapes."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"unknown softmax mode: {softmax!r}")
    q = tensors["q"]
    device, dtype = q.device, q.dtype
    shapes = []  # each attribute read once: a read is ~0.3 µs of host time
    for name, t in tensors.items():
        shape = t.shape
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {dtype}")
        if len(shape) != 3:
            raise ValueError(f"{name} must be [B, N, C], got {tuple(shape)}")
        shapes.append(shape)
    b, nq, c = shapes[0]
    ks, vs = shapes[1], shapes[2]
    if ks != vs or ks[0] != b or ks[2] != c:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(ks)}, "
                         f"v {tuple(vs)}")
    if c % num_heads:
        raise ValueError(f"C={c} is not divisible by {num_heads} heads")
    return shapes


def check_kernel_args(tensors: dict, num_heads: int, head_dims: tuple,
                      softmax: str = "online", strided: bool = False) -> int:
    """What the CUDA kernels take of `tensors` ({"q": q, "k": k, "v": v},
    then the backward's "dout" and "out", each of q's shape), in one pass:
    what `_check_inputs` checks on any device; a CUDA device; bf16 or fp32
    (KERNEL_DTYPES; fp16 and others raise ValueError); a head width in
    `head_dims`; each tensor contiguous (`strided`: [B, N, C] views of rows
    with any row stride, channels contiguous, as the bf16 forwards read
    them); what the TMA maps of the kernels take (at least one row, a
    16-byte aligned base, a row stride and, for the head maps {D, H, N, B},
    a head stride of D elements that are multiples of 16 bytes); no
    autograd; B*H within the grid's y limit. Where several checks fail, the
    first one met here raises (a tensor whose channels are not contiguous
    fails as such before its row stride is looked at). Reads only each
    tensor's device (and is_cuda), dtype, shape, strides, element size,
    data_ptr and requires_grad, so that a stand-in with those can be
    checked on the CPU. Returns the head width."""
    shapes = _check_inputs(tensors, num_heads, softmax)
    q = tensors["q"]
    b, nq, c = shapes[0]
    if not q.is_cuda:
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    dtype = q.dtype
    if dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"flash attention on CUDA takes {KERNEL_DTYPES}, got {dtype}")
    d = c // num_heads
    if d not in head_dims:
        raise ValueError(
            f"head dim {d} not in the kernel's {head_dims}; other "
            "head widths are a ROADMAP item (queue 2)")
    size = q.element_size()
    grad = torch.is_grad_enabled()
    for (name, t), shape in zip(tensors.items(), shapes):
        strides = t.stride()
        if strides[2] != 1 and shape[2] > 1:  # channels first
            _raise_layout(name, strides, strided)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if shape[0] < 1 or shape[1] < 1:
            raise ValueError(f"{name} {tuple(shape)} has no rows")
        if strides[1] * size % 16:
            raise ValueError(
                f"{name}'s row stride of {strides[1] * size} bytes is not a "
                "multiple of 16, which TMA needs")
        if strided:
            if strides[0] != shape[1] * strides[1]:
                _raise_layout(name, strides, strided)
        elif ((shape[1] != 1 and strides[1] != shape[2])
              or (shape[0] != 1 and strides[0] != shape[1] * shape[2])) \
                and not _contiguous(shape, strides):
            _raise_layout(name, strides, strided)
        if grad and t.requires_grad:
            raise RuntimeError(
                "the flash-attention kernels are not differentiable: with grad "
                "enabled call FlashAttentionFunction (ops/attention.py's "
                "dispatch_attention does)"
            )
    if d * size % 16:
        raise ValueError(f"q's head stride of {d * size} bytes is not a "
                         "multiple of 16, which TMA needs")
    if b * num_heads > 65535:
        raise ValueError(f"B*H={b * num_heads} exceeds the grid's y limit")
    return d


def _contiguous(shape, strides) -> bool:
    """torch's is_contiguous of a [B, N, C] tensor from its shape and
    strides (the stride of a dimension of size 1 does not count)."""
    b, n, c = shape
    return (b * n * c == 0
            or ((c == 1 or strides[2] == 1) and (n == 1 or strides[1] == c)
                and (b == 1 or strides[0] == n * c)))


def _raise_layout(name: str, strides, strided: bool):
    if strided:
        raise ValueError(f"{name} must be [B, N, C] rows with contiguous "
                         f"channels, got strides {tuple(strides)}")
    raise ValueError(f"{name} must be contiguous")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    softmax: str = "shifted",
) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d)) V per head. q: [B, Nq, C], k/v: [B, Nk, C]
    -> [B, Nq, C]. On a CUDA tensor this launches the Hopper kernel (bf16,
    or fp32: the split, then `csrc/flash_fwd_d64_f32_sm90.cu` at head dims
    40, 64, 80 and 160 or `csrc/flash_fwd_d512_f32_sm90.cu` at 512; a head
    dim in HEAD_DIMS; contiguous inputs; no autograd) or raises; on a CPU
    tensor it runs `flash_attention_plain`."""
    return _serving_forward(q, k, v, num_heads, softmax)


def _serving_forward(q, k, v, num_heads: int, softmax: str,
                     strided: bool = False,
                     shift_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`flash_attention`'s body; `strided` takes [B, N, C] views of rows
    with any row stride (`flash_attention_packed`'s q, k and v);
    `shift_out` ([B*H, Nq] fp32, shifted mode) receives the row shift."""
    if q.is_cpu:
        _check_inputs({"q": q, "k": k, "v": v}, num_heads, softmax)
        if shift_out is not None:
            shift_out.copy_(row_shift(q, k, num_heads))
        return flash_attention_plain(q, k, v, num_heads, softmax)
    d = check_kernel_args({"q": q, "k": k, "v": v}, num_heads, HEAD_DIMS,
                          softmax, strided)
    # the kernels below 512 compute the shift themselves
    shift = (row_shift(q, k, num_heads) if softmax == "shifted" and d == 512
             else None)
    # contiguous (q itself may be a strided view of a packed projection)
    out = q.new_empty(q.shape) if strided else torch.empty_like(q)
    _launch_forward(q, k, v, shift, out, q.shape[0], num_heads, d,
                    softmax == "online", f"{softmax}_d{d}", shift_out)
    return out


def flash_attention_shift(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int, strided: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The shifted forward and the row shift it used, [B*H, Nq] fp32 in
    natural-log units: on a CUDA tensor at head dims 40, 64, 80 and 160 the
    kernel writes the shift it computed through its `lse` pointer (what the
    serving path leaves null; the 512-wide kernels, which read
    `row_shift`'s, raise); on a CPU tensor it is `row_shift`'s. `strided`
    as `flash_attention_packed` reads q, k and v. For the tests and
    chip_smoke.py, which hold the kernel's shift to `row_shift`."""
    shift = torch.empty((q.shape[0] * num_heads, q.shape[1]),
                        dtype=torch.float32, device=q.device)
    out = _serving_forward(q, k, v, num_heads, "shifted", strided, shift)
    return out, shift


def flash_attention_packed(qkv: torch.Tensor, num_heads: int,
                           softmax: str = "shifted") -> torch.Tensor:
    """Self-attention on one [B, N, 3C] projection whose channels are q, k
    and v side by side (`ops/attention.py:self_attention_projected`'s
    product with the stacked [3C, C] weight) -> [B, N, C]. On a CUDA tensor
    the bf16 kernel reads q, k and v in place at row stride 3C (the head
    maps take any row stride: no split copies), counted as `flash_attention`
    counts it; fp32 (whose split needs contiguous operands) raises, as do
    autograd and the other checks of `flash_attention`. On a CPU tensor it
    runs `flash_attention_plain` on the three views."""
    b, n, c3 = qkv.shape
    if c3 % 3:
        raise ValueError(f"qkv's {c3} channels are not three equal parts")
    c = c3 // 3
    if qkv.is_cuda and qkv.dtype not in PACKED_DTYPES:
        raise ValueError(f"flash_attention_packed takes {PACKED_DTYPES} on "
                         f"CUDA, got {qkv.dtype}: the fp32 kernels read "
                         "contiguous split copies")
    return _serving_forward(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                            num_heads, softmax, strided=True)


def flash_attention_folded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Exact softmax(Q K^T / sqrt(D)) V on folded tensors: q [BH, Nq, D],
    k/v [BH, Nk, D] -> [BH, Nq, D]; the TPU package's first
    `flash_attention` (`marigold_tpu/ops/flash_attention.py:471`). On a CUDA
    tensor this launches the online kernel with BH batches of one D-wide
    head (bf16 or fp32, D in HEAD_DIMS; no padding of N: the kernel masks
    ragged N, and TMA zero-fills the lanes of a narrow head's boxes) or
    raises; on a CPU tensor it runs the plain online forward with one
    head."""
    if q.is_cpu:
        _check_inputs({"q": q, "k": k, "v": v}, 1)
        return flash_attention_plain(q, k, v, 1, "online")
    if q.ndim == 3 and q.shape[2] not in HEAD_DIMS:
        raise NotImplementedError(
            f"the folded flash kernel takes D in {HEAD_DIMS}, got "
            f"{q.shape[2]}; other head widths are a ROADMAP item (queue 2)")
    d = check_kernel_args({"q": q, "k": k, "v": v}, 1, HEAD_DIMS)
    out = torch.empty_like(q)
    _launch_forward(q, k, v, None, out, q.shape[0], 1, d, True,
                    f"folded_d{d}")
    return out


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (out [B, Nq, C], lse [B*H, Nq] fp32), exact
    online softmax. On a CUDA tensor this launches the Hopper kernel (bf16,
    or fp32: the split, then `csrc/flash_fwd_d64_f32_sm90.cu`; a head dim in
    TRAIN_HEAD_DIMS) or raises; on a CPU tensor it runs
    `flash_attention_lse_plain`."""
    if q.is_cpu:
        _check_inputs({"q": q, "k": k, "v": v}, num_heads)
        return flash_attention_lse_plain(q, k, v, num_heads)
    d = check_kernel_args({"q": q, "k": k, "v": v}, num_heads,
                          TRAIN_HEAD_DIMS)
    b, nq, c = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((b * num_heads, nq), device=q.device, dtype=torch.float32)
    if q.dtype == torch.float32:
        lib, counter = _f32_library(), launches_f32
        operands = _split_fwd_f32(q, k, v)
        fn, args = lib.mt_flash_fwd_lse_f32, (
            *(t.data_ptr() for t in operands), out.data_ptr(),
            lse.data_ptr(), b, num_heads, nq, nk, d, c, c)
    else:
        lib, counter = _library(), launches
        fn, args = lib.mt_flash_attention_fwd_lse, (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, num_heads, nq, nk, d, c, c, c)
    err = cuda_build.on_device(q, fn, *args, 1.0 / math.sqrt(d), cuda_build.stream_of(q))
    _raise_on(lib, err, lambda: f"flash attention lse ({q.dtype})")
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
    """The dK/dV kernels' row statistics: lse and `row_delta`, each
    [B*H, round_up(Nq, STAT_PAD)] fp32, padded with LSE_PAD and 0 as the TPU
    wrapper pads them (one small copy of lse): each 64-row stage of the dK/dV
    kernel then reads its rows, padded ones included, as one 16-byte-aligned
    bulk copy. The plain version of what the dQ kernels of both dtypes
    write; the CPU tests and chip_smoke.py hold the kernels' rows to it,
    and no kernel path calls it."""
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
    lse. On a CUDA tensor this launches the dQ kernel, which also computes
    delta = rowsum(dO * O) and writes the padded statistics, and then the
    dK/dV kernel that reads them (bf16: the two kernels of
    `csrc/flash_bwd_sm90.cu` and nothing else; fp32 after one split,
    `split_bwd_f32`: dQ on `csrc/flash_bwd_dq_f32_sm90.cu`, dK/dV on
    `csrc/flash_bwd_dkv_f32_sm90.cu`; a head dim in TRAIN_HEAD_DIMS; q, k,
    v, dout and out as TMA takes them, `check_kernel_args`) or raises; on a
    CPU tensor it runs `flash_attention_bwd_plain` (which recomputes the
    softmax itself)."""
    if q.is_cpu:
        _check_inputs({"q": q, "k": k, "v": v}, num_heads)
        return flash_attention_bwd_plain(q, k, v, dout, num_heads)
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} / out {tuple(out.shape)} "
                         f"must match q {tuple(q.shape)}")
    d = check_kernel_args({"q": q, "k": k, "v": v, "dout": dout, "out": out},
                          num_heads, TRAIN_HEAD_DIMS)
    b, nq, _ = q.shape
    if lse.shape != (b * num_heads, nq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 [{b * num_heads}, {nq}]")
    if q.dtype == torch.float32:
        parts = split_bwd_f32(q, k, v, dout)
        dq, lse_p, delta_p = flash_attention_bwd_dq_f32(
            q, k, v, out, lse, dout, num_heads, parts)
    else:
        parts = None
        dq, lse_p, delta_p = flash_attention_bwd_dq(q, k, v, out, lse, dout,
                                                    num_heads)
    return (dq, *flash_attention_bwd_dkv(q, k, v, dout, lse_p, delta_p,
                                         num_heads, parts))


def split_bwd_f32(q, k, v, dout) -> list:
    """The fp32 backward's one operand split, read by both kernels: the
    (hi, lo) pairs of q, dout, k and v in their layout, then of q, dout and
    k transposed (`split_tf32`, one launch of seven jobs)."""
    return split_tf32([q, dout, k, v], [q, dout, k])


def flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, num_heads: int
                                 ) -> tuple[torch.Tensor, ...]:
    """The dQ kernels' function in plain PyTorch (the TPU package's
    `_flash_bwd_dq_kernel` and the statistics its wrapper
    `_flash_dt_bwd_pallas` computes first): (dq [B, Nq, C] in q's dtype,
    lse_p, delta_p), the last two `bwd_stats`' padded rows. P = exp(S -
    lse) from the forward's lse [B*H, Nq], dP = dO V^T, dS = P (dP -
    delta) rounded to the storage dtype, dQ = dS K * scale; fp32 sums, in
    BWD_CHUNK query rows. The CPU tests hold it to the Pallas kernel (fp32,
    atol 2e-4 and rtol 1e-3, the backward tests' tolerance) and its
    statistics to the TPU wrapper's (atol and rtol 1e-5)."""
    b, nq, c = q.shape
    scale = 1.0 / math.sqrt(c // num_heads)
    acc = _accum_dtype(q)
    lse_p, delta_p = bwd_stats(out, lse, dout, num_heads)
    qh, gh = _heads(q, num_heads), _heads(dout, num_heads)
    kh, vh = _heads(k, num_heads).to(acc), _heads(v, num_heads).to(acc)
    stats = [x[:, :nq].reshape(b, num_heads, nq, 1).to(acc)
             for x in (lse_p, delta_p)]
    dq = []
    for r0 in range(0, nq, BWD_CHUNK):
        rows = slice(r0, r0 + BWD_CHUNK)
        q_c, g_c = qh[:, :, rows].to(acc), gh[:, :, rows].to(acc)
        p = torch.exp(torch.matmul(q_c, kh.transpose(-1, -2)) * scale
                      - stats[0][:, :, rows])
        dp = torch.matmul(g_c, vh.transpose(-1, -2))
        ds = (p * (dp - stats[1][:, :, rows])).to(k.dtype).to(acc)
        dq.append(torch.matmul(ds, kh) * scale)
    return _unheads(torch.cat(dq, dim=2)).to(q.dtype), lse_p, delta_p


def flash_attention_bwd_dq(q, k, v, out, lse, dout, num_heads: int
                           ) -> tuple[torch.Tensor, ...]:
    """bf16 (dQ [B, Nq, C], lse_p, delta_p) by `csrc/flash_bwd_sm90.cu`:
    the kernel computes delta = rowsum(dO * O) itself and writes
    `bwd_stats`' padded lse and delta rows ([B*H, round_up(Nq, STAT_PAD)]
    fp32), which the dK/dV kernel reads. `lse` is the training forward's
    [B*H, Nq]. On a CPU tensor `flash_attention_bwd_dq_plain`. Unchecked
    but for the dtype: `flash_attention_bwd` checks the arguments before it
    calls this (fp32 takes `flash_attention_bwd_dq_f32`)."""
    if q.is_cpu:
        return flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, num_heads)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd_dq takes bf16, got {q.dtype}")
    b, nq, c = q.shape
    d = c // num_heads
    ld_stat = -(-nq // STAT_PAD) * STAT_PAD
    dq = torch.empty_like(q)
    lse_p, delta_p = (lse.new_empty((b * num_heads, ld_stat)) for _ in range(2))
    lib = _bwd_library()
    err = cuda_build.on_device(
        q, lib.mt_flash_attention_bwd_dq, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), dout.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), lse_p.data_ptr(), delta_p.data_ptr(), b, num_heads,
        nq, k.shape[1], d, c, c, ld_stat, 1.0 / math.sqrt(d),
        cuda_build.stream_of(q))
    _raise_on(lib, err, f"flash attention dQ ({q.dtype})")
    launches.add(f"bwd_dq_d{d}")
    return dq, lse_p, delta_p


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
    err = cuda_build.on_device(
        q, lib.mt_flash_bwd_dq_f32, *(t.data_ptr() for t in operands),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        lse_p.data_ptr(), delta_p.data_ptr(), b, num_heads, nq, k.shape[1], d,
        c, ld_stat, 1.0 / math.sqrt(d), cuda_build.stream_of(q))
    _raise_on(lib, err, f"flash attention dQ ({q.dtype})")
    launches_f32.add(f"bwd_dq_d{d}")
    return dq, lse_p, delta_p


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, num_heads: int,
                            parts: Optional[list] = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, Nk, C] by the dK/dV kernel of q's dtype: lse and delta
    the padded rows the dQ kernel of that dtype wrote (`bwd_stats`' layout
    and values). In fp32 it
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
    err = cuda_build.on_device(
        q, fn, *(t.data_ptr() for t in operands), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, num_heads, nq,
        k.shape[1], d, *strides, lse.shape[1], 1.0 / math.sqrt(d),
        cuda_build.stream_of(q))
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
    For heads of TRAIN_HEAD_DIMS (40, 64, 80, 160) the forward is the exact
    online softmax with the row logsumexp (`flash_attention_lse_op`),
    whatever the serving `softmax` mode, and the backward runs the dQ and
    dK/dV kernels (`flash_attention_bwd`); on a CPU tensor their plain
    versions. The 512-wide VAE head, whose rows the TPU package's
    `_use_pallas_bwd` also rejects, runs the serving forward in `softmax`
    mode and the plain chunked backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, softmax: str = "shifted"):
        _check_inputs({"q": q, "k": k, "v": v}, num_heads, softmax)
        d = q.shape[2] // num_heads
        ctx.num_heads = num_heads
        ctx.kernel_bwd = d in TRAIN_HEAD_DIMS
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
