"""SAME-padded stride-1 3x3 convolution as nine shifted products: the
hand-written Hopper kernels (`csrc/conv3x3.cu` for bf16,
`csrc/conv3x3_f32_sm90.cu` for fp32) and their plain PyTorch version.

Replaces the TPU package's `marigold_tpu/ops/conv.py:_conv3x3_pallas` (the
nine-tap kernel, opt-in under MARIGOLD_TPU_CONV=pallas):

    y[b, k, h, w] = bias[k]
        + sum_{dy, dx, c} x[b, c, h + dy - 1, w + dx - 1] * W[k, c, dy, dx]

with fp32 accumulation and the result in the input's dtype. The port takes
NCHW activations and OIHW weights as the models hold them. The wrapper
rearranges the weight tap-major into `[9, K, C]` (C innermost: the K-major
B operand the kernel's TMA reads), unless the caller passes it already
prepared (`prepared=`, what `models/layers.py:Conv2d` caches;
`prepare_weight`), and allocates the NHWC scratch that the library's first
launch fills with a copy of x, so that each (tap, 64-channel block) of the
A operand is one TMA box of 64 pixels x 128 bytes, as the TPU wrapper pads
and flattens x outside its kernel. The TPU wrapper's H padding and
column-wrap masks have no counterpart: TMA reads the SAME padding as zeros.

`supports` is the TPU package's gate (3x3, stride 1, padding 1, C and K at
least 128 and multiples of 128, bf16 or fp32) without the TPU VMEM plan
(`_plan`), which has no counterpart here: the kernel tiles any such shape.

fp32 storage (`--full_precision`) takes the 3xTF32 implicit GEMM of
`csrc/conv3x3_f32_sm90.cu` on the tensor cores: each operand x = hi + lo in
tf32 parts, lo.hi + hi.lo + hi.hi summed in fp32 (the arithmetic of
`csrc/tf32x3.cuh`). Its weight is the split taps, `[2, 9, K, C]`
(`taps_tf32`); x is split into NHWC hi and lo parts by a launch of its own
(`split_x_tf32`, counted as "conv3x3_split"). `conv3x3_tf32x3_plain`
emulates the kernel's arithmetic for the CPU tests.

On a CUDA tensor `conv3x3` launches the kernel (bf16 or fp32, no autograd)
or raises; on a CPU tensor it runs `conv3x3_plain`. `KernelConvFunction`
carries a kernel conv under autograd with the plain conv gradients, as the
TPU package's custom VJP takes XLA's; it passes no prepared weight, so the
wrapper prepares it on every call. `launches["conv3x3"]` counts bf16
kernel launches, `launches_f32["conv3x3"]` fp32 ones and
`launches_f32["conv3x3_split"]` the fp32 split of x.
"""

from __future__ import annotations

import ctypes

import torch

from marigold_tpu_torch.ops import cuda_build
from marigold_tpu_torch.ops.flash_attention import split_tf32_plain

SOURCES = ("conv3x3.cu",)
F32_SOURCES = ("conv3x3_f32_sm90.cu",)
# input channels per fresh accumulator of the fp32 kernel (CHUNK_CB 32-wide
# channel blocks x 9 taps of wgmma adds)
F32_CHUNK = 128
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

launches = cuda_build.LaunchCounter()
launches_f32 = cuda_build.LaunchCounter()


def supports(x_shape, w_shape, stride, padding, dtype) -> bool:
    """True when the kernel takes this conv: x NCHW, w OIHW (the JAX
    package's `supports` on NHWC/HWIO shapes, without its VMEM plan)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    c_out, c_in, kh, kw = w_shape
    if (kh, kw) != (3, 3) or tuple(_pair(stride)) != (1, 1):
        return False
    if tuple(_pair(padding)) != (1, 1):
        return False
    if c_in < 128 or c_out < 128 or c_in % 128 or c_out % 128:
        return False
    return dtype in (torch.bfloat16, torch.float32) and x_shape[2] >= 1


def _pair(v):
    return (v, v) if isinstance(v, int) else v


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: nine tap products of the
    zero-padded input with the [9, K, C] weight, summed in fp32 (float64
    for float64 inputs), bias added, cast to x's dtype."""
    b, c, h, w = x.shape
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    w9 = taps(weight).to(acc_t)
    xp = torch.nn.functional.pad(x.to(acc_t), (1, 1, 1, 1))
    acc = bias.to(acc_t).reshape(1, -1, 1, 1).expand(b, -1, h, w).clone()
    for t in range(9):
        dy, dx = divmod(t, 3)
        acc += torch.einsum("bchw,kc->bkhw", xp[:, :, dy:dy + h, dx:dx + w],
                            w9[t])
    return acc.to(x.dtype)


def taps(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [K, C, 3, 3] -> tap-major [9, K, C], tap = 3 * dy + dx."""
    k, c = weight.shape[:2]
    return weight.permute(2, 3, 0, 1).reshape(9, k, c).contiguous()


def taps_tf32(weight: torch.Tensor) -> torch.Tensor:
    """The fp32 kernel's weight: `taps` of an fp32 OIHW weight split into
    tf32 parts, [2, 9, K, C] (hi, lo)."""
    return torch.stack(split_tf32_plain(taps(weight)))


def prepare_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weight as the kernel of its dtype reads it: `taps_tf32` for
    fp32, `taps` otherwise."""
    return taps_tf32(weight) if weight.dtype == torch.float32 else taps(weight)


def split_x_tf32_plain(x: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] fp32 -> [2, B, H, W, C]: the NHWC hi and lo parts that
    the fp32 kernel's A boxes read (`split_tf32_plain` of the NHWC copy)."""
    return torch.stack(split_tf32_plain(x.permute(0, 2, 3, 1).contiguous()))


def conv3x3_tf32x3_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """The fp32 kernel's arithmetic in plain PyTorch, for the CPU tests: x
    and the taps split into tf32 parts, lo.hi + hi.lo + hi.hi of each tap
    summed in fp32 into a fresh accumulator per F32_CHUNK input channels
    (all nine taps), each added into the running sum, then the bias."""
    b, c, h, w = x.shape
    xh, xl = split_tf32_plain(torch.nn.functional.pad(x, (1, 1, 1, 1)))
    wh, wl = split_tf32_plain(taps(weight))
    run = x.new_zeros((b, weight.shape[0], h, w))
    for c0 in range(0, c, F32_CHUNK):
        ch = slice(c0, c0 + F32_CHUNK)
        fresh = torch.zeros_like(run)
        for t in range(9):
            dy, dx = divmod(t, 3)
            for xp, wp in ((xl, wh), (xh, wl), (xh, wh)):
                fresh += torch.einsum("bchw,kc->bkhw",
                                      xp[:, ch, dy:dy + h, dx:dx + w],
                                      wp[t, :, ch])
        run += fresh
    return run + bias.reshape(1, -1, 1, 1)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("conv3x3", SOURCES)
    fn = lib.mt_conv3x3_fwd
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.mt_conv3x3_blocks.argtypes = [i] * 5
        lib.mt_conv3x3_blocks.restype = i
        lib.mt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def f32_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("conv3x3_f32", F32_SOURCES)
    fn = lib.mt_conv3x3_f32_fwd
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.mt_conv3x3_f32_split.argtypes = [p, p, i, i, i, i, p]
        lib.mt_conv3x3_f32_split.restype = ctypes.c_int
        lib.mt_conv3x3_f32_blocks.argtypes = [i] * 5
        lib.mt_conv3x3_f32_blocks.restype = i
        lib.mt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def blocks(b: int, c: int, h: int, w: int, k: int) -> int:
    """Blocks the kernel launches for x [b, c, h, w] -> k channels."""
    return _library().mt_conv3x3_blocks(b, c, h, w, k)


def blocks_f32(b: int, c: int, h: int, w: int, k: int) -> int:
    """Blocks the fp32 kernel launches for x [b, c, h, w] -> k channels."""
    return f32_library().mt_conv3x3_f32_blocks(b, c, h, w, k)


def split_x_tf32(x: torch.Tensor) -> torch.Tensor:
    """`split_x_tf32_plain` of a contiguous fp32 [B, C, H, W] tensor (C a
    multiple of 32): on a CUDA tensor one launch of
    `csrc/conv3x3_f32_sm90.cu`'s split, counted as "conv3x3_split" in
    `launches_f32`; on a CPU tensor the plain version."""
    if x.device.type == "cpu":
        return split_x_tf32_plain(x)
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"split_x_tf32 takes a contiguous fp32 [B, C, H, W] "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    b, c, h, w = x.shape
    xs = torch.empty((2, b, h, w, c), device=x.device, dtype=x.dtype)
    lib = f32_library()
    with torch.cuda.device(x.device):
        err = lib.mt_conv3x3_f32_split(
            x.data_ptr(), xs.data_ptr(), b, c, h, w,
            torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "conv3x3 x split (fp32)")
    launches_f32.add("conv3x3_split")
    return xs


def check_cuda(x, weight, bias, what: str) -> None:
    """What the conv kernels take: CUDA contiguous tensors on one device,
    all bf16 or all fp32, a gated shape, no autograd."""
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: x is {x.dtype}, the kernels take "
                         f"{KERNEL_DTYPES}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.dtype != x.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if not supports(x.shape, weight.shape, 1, 1, x.dtype) or \
            x.shape[1] != weight.shape[1] or bias.shape != (weight.shape[0],):
        raise ValueError(f"{what}: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)} "
                         "is not a gated 3x3 conv")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError(
            f"the {what} kernel is not differentiable: with grad enabled call "
            "KernelConvFunction (models/layers.py's Conv2d does)")


def check_prepared(prepared: torch.Tensor, shape: tuple, x: torch.Tensor,
                   what: str) -> None:
    """A rearranged weight handed to a kernel: x's dtype, contiguous, on
    x's device, of `shape`, 16-byte aligned (TMA and float4 loads read
    it)."""
    if prepared.dtype != x.dtype or prepared.device != x.device or \
            not prepared.is_contiguous() or tuple(prepared.shape) != shape or \
            prepared.data_ptr() % 16:
        raise ValueError(
            f"{what}: the prepared weight must be a contiguous 16-byte aligned "
            f"{x.dtype} {shape} tensor on {x.device}, got {prepared.dtype} "
            f"{tuple(prepared.shape)} on {prepared.device}")


def raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.mt_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
            prepared: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, C, H, W] * weight [K, C, 3, 3] + bias [K] -> [B, K, H, W],
    SAME padding, stride 1. On a CUDA tensor this launches the Hopper
    kernel (bf16 or fp32; C, K multiples of 128; no autograd) or raises; on
    a CPU tensor it runs `conv3x3_plain`. `prepared`, if given, is
    `prepare_weight(weight)` computed earlier (the CPU path ignores it)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    check_cuda(x, weight, bias, "conv3x3")
    b, c, h, w = x.shape
    k = weight.shape[0]
    if prepared is None:
        prepared = prepare_weight(weight)
    f32 = x.dtype == torch.float32
    check_prepared(prepared, (2, 9, k, c) if f32 else (9, k, c), x, "conv3x3")
    if f32:
        xs = split_x_tf32(x)
        out = torch.empty((b, k, h, w), device=x.device, dtype=x.dtype)
        lib = f32_library()
        with torch.cuda.device(x.device):
            err = lib.mt_conv3x3_f32_fwd(
                xs.data_ptr(), prepared.data_ptr(), bias.data_ptr(),
                out.data_ptr(), b, c, h, w, k,
                torch.cuda.current_stream().cuda_stream)
        raise_on(lib, err, "conv3x3 (fp32)")
        launches_f32.add("conv3x3")
        return out
    x_nhwc = torch.empty((b, h, w, c), device=x.device, dtype=x.dtype)
    out = torch.empty((b, k, h, w), device=x.device, dtype=x.dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mt_conv3x3_fwd(
            x.data_ptr(), prepared.data_ptr(), bias.data_ptr(),
            x_nhwc.data_ptr(), out.data_ptr(), b, c, h, w, k,
            torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "conv3x3")
    launches.add("conv3x3")
    return out


class KernelConvFunction(torch.autograd.Function):
    """A kernel conv under autograd: apply(x, weight, bias, forward) with
    forward `conv3x3` or `winograd.winograd3x3`; the backward is the plain
    SAME 3x3 conv's gradients (`torch.nn.grad`), as the TPU package's custom
    VJPs take XLA's conv gradients."""

    @staticmethod
    def forward(ctx, x, weight, bias, forward):
        ctx.save_for_backward(x, weight)
        return forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        gx = torch.nn.grad.conv2d_input(x.shape, weight, g, padding=1)
        gw = torch.nn.grad.conv2d_weight(x, weight.shape, g, padding=1)
        return gx, gw, g.sum(dim=(0, 2, 3)), None
