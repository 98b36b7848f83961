"""Winograd F(2x2, 3x3) convolution: the hand-written Hopper kernels
(`csrc/winograd.cu` for bf16, `csrc/winograd_f32_sm90.cu` for fp32) and
their plain PyTorch version.

Replaces the TPU package's `marigold_tpu/ops/winograd.py:_winograd_impl`
(opt-in under MARIGOLD_TPU_CONV=winograd). For each 2x2 output tile and its
4x4 input patch d (SAME zero padding):

    V = B^T d B          per input channel,
    M_ij = sum_c V_ij[c] U_ij[c, k]   with U = G g G^T (the filter),
    Y = A^T M A + bias,

with (Lavin & Gray)
    B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]
    G   = [[1,0,0],[1/2,1/2,1/2],[1/2,-1/2,1/2],[0,0,1]]
    A^T = [[1,1,1,0],[0,1,-1,-1]].

Rounding: U is computed in fp32 and rounded once to the input dtype, as the
TPU wrapper does. V is summed in fp32 and rounded once to the input dtype
(the TPU kernel sums its two stages in bf16); the 16 products accumulate in
fp32 and so do the output transform and the bias. The plain version rounds
at the same places.

The wrapper computes U (unless the caller passes it, `prepared=`, what
`models/layers.py:Conv2d` caches; `prepare_weight`) and allocates the
scratch V [16, B * H/2 * W/2, C] that the kernel's first launch writes and
its second reads. The TPU wrapper's pixel unshuffle into four phases and its
8-aligned phase width exist to give Mosaic unit-stride slices; the input
transform reads x's rows from NCHW instead.

fp32 storage (`--full_precision`) takes the 3xTF32 kernels of
`csrc/winograd_f32_sm90.cu` on the tensor cores (the arithmetic of
`csrc/tf32x3.cuh`): an fp32 input transform that writes V split into tf32
parts as [2, 16, T, C], then the products lo.hi + hi.lo + hi.hi of each
M_ij summed in fp32 and added into the four output phases, against U split
the same way, [2, 16, K, C] (`filter_transform_tf32`). V is rounded by
nothing but its split (the plain version's round to fp32 is exact).
`winograd3x3_tf32x3_plain` emulates the kernels' arithmetic for the CPU
tests.

`supports` is the TPU package's gate (that of `ops/conv.py` plus even H and
W, and H*W at most MARIGOLD_TPU_WINO_MAX_HW when that is set and non-zero,
read on every call) without the TPU VMEM plan. On a CUDA tensor
`winograd3x3` launches the kernel (bf16 or fp32, no autograd) or raises; on
a CPU tensor it runs `winograd3x3_plain`. `launches["winograd"]` counts
bf16 kernel launches, `launches_f32["winograd"]` fp32 ones.
"""

from __future__ import annotations

import ctypes
import os

import torch

from marigold_tpu_torch.ops import conv as conv_ops
from marigold_tpu_torch.ops import cuda_build
from marigold_tpu_torch.ops.flash_attention import split_tf32_plain

SOURCES = ("winograd.cu",)
F32_SOURCES = ("winograd_f32_sm90.cu",)
# input channels per fresh accumulator of the fp32 GEMM (CHUNK_CB 32-wide
# channel blocks of wgmma adds)
F32_CHUNK = 640

BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
AT = ((1, 1, 1, 0), (0, 1, -1, -1))

launches = cuda_build.LaunchCounter()
launches_f32 = cuda_build.LaunchCounter()


def supports(x_shape, w_shape, stride, padding, dtype) -> bool:
    """x NCHW, w OIHW: the nine-tap gate plus even H and W and the
    MARIGOLD_TPU_WINO_MAX_HW cap (0: none)."""
    if not conv_ops.supports(x_shape, w_shape, stride, padding, dtype):
        return False
    h, w = x_shape[2], x_shape[3]
    if h % 2 or w % 2:
        return False
    max_hw = int(os.environ.get("MARIGOLD_TPU_WINO_MAX_HW", "0"))
    return not (max_hw and h * w > max_hw)


def filter_transform(weight: torch.Tensor) -> torch.Tensor:
    """U = G g G^T of OIHW [K, C, 3, 3] in fp32 (float64 for float64),
    rounded to the weight's dtype, as [16, K, C] with index 4 * i + j."""
    acc_t = torch.float64 if weight.dtype == torch.float64 else torch.float32
    g = torch.tensor(G, dtype=acc_t, device=weight.device)
    u = torch.einsum("ia,jb,kcab->ijkc", g, g, weight.to(acc_t))
    k, c = weight.shape[:2]
    return u.reshape(16, k, c).to(weight.dtype).contiguous()


def filter_transform_tf32(weight: torch.Tensor) -> torch.Tensor:
    """The fp32 kernel's filter: `filter_transform` of an fp32 OIHW weight
    split into tf32 parts, [2, 16, K, C] (hi, lo)."""
    return torch.stack(split_tf32_plain(filter_transform(weight)))


def prepare_weight(weight: torch.Tensor) -> torch.Tensor:
    """The filter as the kernel of its dtype reads it:
    `filter_transform_tf32` for fp32, `filter_transform` otherwise."""
    return (filter_transform_tf32(weight) if weight.dtype == torch.float32
            else filter_transform(weight))


def winograd3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (even H and W): V rounded to
    x's dtype after fp32 sums, the 16 products, A^T M A and the bias in fp32
    (float64 for float64 inputs), the result in x's dtype."""
    b, c, h, w = x.shape
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    bt = torch.tensor(BT, dtype=acc_t, device=x.device)
    at = torch.tensor(AT, dtype=acc_t, device=x.device)
    u = filter_transform(weight).to(acc_t).reshape(4, 4, -1, c)
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1)).to(acc_t)
    d = xp.unfold(2, 4, 2).unfold(3, 4, 2)  # [B, C, H/2, W/2, 4, 4]
    v = torch.einsum("ir,bcyxrs,js->bcyxij", bt, d, bt).to(x.dtype).to(acc_t)
    m = torch.einsum("bcyxij,ijkc->bkyxij", v, u)
    y = torch.einsum("pi,bkyxij,qj->bkypxq", at, m, at)
    y = y.reshape(b, -1, h, w) + bias.to(acc_t).reshape(1, -1, 1, 1)
    return y.to(x.dtype)


def winograd3x3_tf32x3_plain(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """The fp32 kernels' arithmetic in plain PyTorch, for the CPU tests: V
    in fp32 and U split into tf32 parts, lo.hi + hi.lo + hi.hi of each
    M_ij summed in fp32 over F32_CHUNK input channels at a time, each chunk
    taken through A^T M A into the output, then the bias."""
    b, c, h, w = x.shape
    bt = torch.tensor(BT, dtype=torch.float32, device=x.device)
    at = torch.tensor(AT, dtype=torch.float32, device=x.device)
    uh, ul = split_tf32_plain(filter_transform(weight).reshape(4, 4, -1, c))
    d = torch.nn.functional.pad(x, (1, 1, 1, 1)).unfold(2, 4, 2).unfold(3, 4, 2)
    vh, vl = split_tf32_plain(torch.einsum("ir,bcyxrs,js->bcyxij", bt, d, bt))
    y = 0
    for c0 in range(0, c, F32_CHUNK):
        ch = slice(c0, c0 + F32_CHUNK)
        m = sum(torch.einsum("bcyxij,ijkc->bkyxij", vp[:, ch], up[..., ch])
                for vp, up in ((vl, uh), (vh, ul), (vh, uh)))
        y = y + torch.einsum("pi,bkyxij,qj->bkypxq", at, m, at)
    return y.reshape(b, -1, h, w) + bias.reshape(1, -1, 1, 1)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("winograd", SOURCES)
    fn = lib.mt_winograd_fwd
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.mt_winograd_blocks.argtypes = [i] * 5
        lib.mt_winograd_blocks.restype = i
        lib.mt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def f32_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("winograd_f32", F32_SOURCES)
    fn = lib.mt_winograd_f32_fwd
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.mt_winograd_f32_blocks.argtypes = [i] * 5
        lib.mt_winograd_f32_blocks.restype = i
        lib.mt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def blocks(b: int, c: int, h: int, w: int, k: int) -> int:
    """Blocks of the kernel's GEMM launch for x [b, c, h, w] -> k."""
    return _library().mt_winograd_blocks(b, c, h, w, k)


def blocks_f32(b: int, c: int, h: int, w: int, k: int) -> int:
    """Blocks of the fp32 kernel's GEMM launch for x [b, c, h, w] -> k."""
    return f32_library().mt_winograd_f32_blocks(b, c, h, w, k)


def winograd3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                *, prepared: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, C, H, W] * weight [K, C, 3, 3] + bias [K] -> [B, K, H, W] by
    F(2x2, 3x3), SAME padding, stride 1, H and W even. On a CUDA tensor
    this launches the Hopper kernels (bf16 or fp32; C, K multiples of 128;
    no autograd) or raises; on a CPU tensor it runs `winograd3x3_plain`.
    `prepared`, if given, is `prepare_weight(weight)` computed earlier (the
    CPU path ignores it)."""
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"winograd3x3 takes even H and W, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return winograd3x3_plain(x, weight, bias)
    conv_ops.check_cuda(x, weight, bias, "winograd")
    b, c, h, w = x.shape
    k = weight.shape[0]
    if prepared is None:
        prepared = prepare_weight(weight)
    f32 = x.dtype == torch.float32
    conv_ops.check_prepared(prepared, (2, 16, k, c) if f32 else (16, k, c), x,
                            "winograd")
    if f32:
        v = torch.empty((2, 16, b * (h // 2) * (w // 2), c), device=x.device,
                        dtype=x.dtype)
        out = torch.empty((b, k, h, w), device=x.device, dtype=x.dtype)
        lib = f32_library()
        with torch.cuda.device(x.device):
            err = lib.mt_winograd_f32_fwd(
                x.data_ptr(), prepared.data_ptr(), bias.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, c, h, w, k,
                torch.cuda.current_stream().cuda_stream)
        conv_ops.raise_on(lib, err, "winograd (fp32)")
        launches_f32.add("winograd")
        return out
    v = torch.empty((16, b * (h // 2) * (w // 2), c), device=x.device,
                    dtype=x.dtype)
    out = torch.empty((b, k, h, w), device=x.device, dtype=x.dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mt_winograd_fwd(
            x.data_ptr(), prepared.data_ptr(), bias.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, c, h, w, k,
            torch.cuda.current_stream().cuda_stream)
    conv_ops.raise_on(lib, err, "winograd")
    launches.add("winograd")
    return out
