"""Image utilities of the port's pipelines.

Counterpart of `marigold_tpu/pipelines/image_util.py`:
  * `resize_np` / `resize_torch` reproduce `jax.image.resize(...,
    antialias=True)` (the JAX package's processing-resolution and on-device
    resize-back transform): JAX's separable scale-and-translate weights,
    built here in numpy (jax/_src/image/scale.py:compute_weight_mat) and
    applied as two contractions;
  * `resize_host` is the torchvision-antialias numpy resize of the host
    resize-back path;
  * `colorize_depth_maps` colours with the port's own copy of matplotlib's
    "Spectral" (the CLIs' default, so depth colouring needs no matplotlib)
    and imports matplotlib for any other colour map;
  * `hwc2chw`, `srgb2linear`, `linear2srgb` and `norm_to_rgb` serve the
    normals and IID outputs.
"""

from __future__ import annotations

import numpy as np
import torch

RESAMPLE_METHODS = {
    "bilinear": "linear",
    "bicubic": "cubic",
    # half-pixel-center sampling, torchvision's NEAREST_EXACT
    "nearest": "nearest",
    "nearest-exact": "nearest",
}


def get_resample_method(name: str) -> str:
    if name not in RESAMPLE_METHODS:
        raise ValueError(f"Unknown resampling method: {name}")
    return RESAMPLE_METHODS[name]


def resize_max_res_shape(h: int, w: int, max_edge: int) -> tuple[int, int]:
    """Aspect-preserving max-edge resize target (floor, at least 1)."""
    scale = max_edge / max(h, w)
    return max(int(h * scale), 1), max(int(w * scale), 1)


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2, np.float32(0), out)


def jax_resize_weights(n_in: int, n_out: int, method: str,
                       antialias: bool = True) -> np.ndarray:
    """[n_in, n_out] fp32 weights of jax.image.resize along one axis
    (scale = n_out / n_in, no translation)."""
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1)) if antialias else np.float32(1)
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = kernel(x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    off = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(n_in) / np.float32(n_out)
    return np.floor(off).astype(np.int64)


def resize_np(img: np.ndarray, out_hw: tuple[int, int], method: str = "bilinear",
              antialias: bool = True) -> np.ndarray:
    """img: [..., H, W, C] -> [..., h, w, C], jax.image.resize semantics."""
    h, w = img.shape[-3], img.shape[-2]
    th, tw = out_hw
    m = get_resample_method(method)
    x = np.asarray(img, np.float32)
    if m == "nearest":
        return x[..., _nearest_index(h, th), :, :][..., _nearest_index(w, tw), :]
    if th != h:
        x = _axis_matmul(x, jax_resize_weights(h, th, m, antialias), -3)
    if tw != w:
        x = _axis_matmul(x, jax_resize_weights(w, tw, m, antialias), -2)
    return np.ascontiguousarray(x)


def _axis_matmul(x: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """Contract `axis` of x with w [n_in, n_out] as one 2-D BLAS matmul."""
    xt = np.ascontiguousarray(np.moveaxis(x, axis, -1))
    y = (xt.reshape(-1, xt.shape[-1]) @ w).reshape(xt.shape[:-1] + w.shape[1:])
    return np.moveaxis(y, -1, axis)


def resize_torch(img: torch.Tensor, out_hw: tuple[int, int],
                 method: str = "bilinear", antialias: bool = True) -> torch.Tensor:
    """img: [B, C, H, W] fp32 -> [B, C, h, w], the same weights as resize_np,
    applied on img's device."""
    h, w = img.shape[-2:]
    th, tw = out_hw
    m = get_resample_method(method)
    if m == "nearest":
        ri = torch.from_numpy(_nearest_index(h, th)).to(img.device)
        ci = torch.from_numpy(_nearest_index(w, tw)).to(img.device)
        return img[..., ri, :][..., ci]
    x = img
    if th != h:
        wh = torch.from_numpy(jax_resize_weights(h, th, m, antialias)).to(img.device)
        x = torch.einsum("bchw,hH->bcHw", x, wh)
    if tw != w:
        ww = torch.from_numpy(jax_resize_weights(w, tw, m, antialias)).to(img.device)
        x = torch.einsum("bchw,wW->bchW", x, ww)
    return x


def _aa_axis_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """[n_out, n_in] weights of torchvision's antialiased separable resize
    (aten upsample_*2d_aa): support scales with the downscale ratio,
    truncated edge kernels renormalize."""
    ratio = n_in / n_out
    clamped = max(ratio, 1.0)
    if method == "linear":
        f_support = 1.0

        def filt(x):
            return np.maximum(0.0, 1.0 - np.abs(x))
    else:  # bicubic, PIL/AA cubic with a = -0.5
        f_support = 2.0
        a = -0.5

        def filt(x):
            x = np.abs(x)
            return np.where(
                x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))

    support = f_support * clamped
    centers = ratio * (np.arange(n_out) + 0.5)
    xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((centers + support + 0.5).astype(np.int64), n_in)
    W = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        ks = np.arange(xmin[i], xmax[i])
        wts = filt((ks + 0.5 - centers[i]) / clamped)
        s = wts.sum()
        if s > 0:
            W[i, ks] = wts / s
    return W.astype(np.float32)


def resize_host(img: np.ndarray, out_hw: tuple[int, int],
                method: str = "bilinear") -> np.ndarray:
    """numpy resize with torchvision `resize(..., antialias=True)` semantics
    (the reference's resize-back). img: [..., H, W, C]."""
    h, w = img.shape[-3], img.shape[-2]
    th, tw = out_hw
    if (h, w) == (th, tw):
        return np.asarray(img)
    m = get_resample_method(method)
    if m == "nearest":
        ri = np.minimum(((np.arange(th) + 0.5) * (h / th)).astype(np.int64), h - 1)
        ci = np.minimum(((np.arange(tw) + 0.5) * (w / tw)).astype(np.int64), w - 1)
        return np.asarray(img)[..., ri, :, :][..., :, ci, :]
    x = np.asarray(img, np.float32)
    tmp = np.einsum("oh,...hwc->...owc", _aa_axis_matrix(h, th, m), x)
    return np.einsum("pw,...owc->...opc", _aa_axis_matrix(w, tw, m), tmp)


def chw2hwc(chw: np.ndarray) -> np.ndarray:
    assert chw.ndim == 3
    return np.moveaxis(chw, 0, -1)


def hwc2chw(hwc: np.ndarray) -> np.ndarray:
    assert hwc.ndim == 3
    return np.moveaxis(hwc, -1, 0)


# matplotlib's `_Spectral_data`: the 11 ColorBrewer anchors, as bytes
_SPECTRAL_ANCHORS = (
    (158, 1, 66), (213, 62, 79), (244, 109, 67), (253, 174, 97),
    (254, 224, 139), (255, 255, 191), (230, 245, 152), (171, 221, 164),
    (102, 194, 165), (50, 136, 189), (94, 79, 162))
LUT_SIZE = 256  # matplotlib's rcParams["image.lut"]


def linear_segmented_lut(anchors, n: int = LUT_SIZE) -> np.ndarray:
    """[n, 3] float64 table of evenly spaced RGB anchors in [0, 1],
    interpolated linearly as matplotlib's `LinearSegmentedColormap.from_list`
    builds its lookup table (`colors._create_lookup_table`, gamma 1)."""
    y = np.asarray(anchors, np.float64)
    x = np.linspace(0.0, 1.0, len(y)) * (n - 1)
    xind = (n - 1) * np.linspace(0.0, 1.0, n)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    mid = dist[:, None] * (y[ind] - y[ind - 1]) + y[ind - 1]
    return np.clip(np.concatenate([y[:1], mid, y[-1:]]), 0.0, 1.0)


SPECTRAL_LUT = linear_segmented_lut(np.asarray(_SPECTRAL_ANCHORS) / 255.0)


def apply_lut(lut: np.ndarray, x: np.ndarray) -> np.ndarray:
    """x in [0, 1] -> lut rows, indexed as a matplotlib Colormap indexes a
    float array: floor(x * N) in x's dtype, x == 1 to the last row."""
    n = lut.shape[0]
    xa = np.array(x, copy=True)
    xa *= xa.dtype.type(n)
    xa[xa == n] = n - 1
    return lut[np.clip(xa.astype(np.int64), 0, n - 1)]


def colorize_depth_maps(depth_map, min_depth: float = 0.0, max_depth: float = 1.0,
                        cmap: str = "Spectral", valid_mask=None) -> np.ndarray:
    """Depth [H, W] (or [B, H, W]) -> colored [B, 3, H, W] in [0, 1], black
    where `valid_mask` ([H, W] or [B, H, W], when given) is False.
    "Spectral" uses the port's own table; any other colour map needs
    matplotlib, imported here (ImportError without it)."""
    depth = np.asarray(depth_map, np.float32)
    if depth.ndim == 2:
        depth = depth[None]
    depth = depth.reshape((-1,) + depth.shape[-2:])
    rng = max(max_depth - min_depth, 1e-8)
    d = np.clip((depth - min_depth) / rng, 0, 1)
    if cmap == "Spectral":
        colored = apply_lut(SPECTRAL_LUT, d)
    else:
        import matplotlib

        colored = matplotlib.colormaps[cmap](d, bytes=False)[..., 0:3]
    if valid_mask is not None:
        valid_mask = np.asarray(valid_mask, bool)
        if valid_mask.ndim == 2:
            valid_mask = valid_mask[None]
        colored[~valid_mask.reshape((-1,) + valid_mask.shape[-2:])] = 0
    return np.moveaxis(colored, -1, 1)


def float2int(img: np.ndarray, n_bits: int = 8) -> np.ndarray:
    """[0, 1] float -> uint image."""
    m = 2**n_bits - 1
    dtype = np.uint8 if n_bits == 8 else np.uint16
    return (np.clip(img, 0, 1) * m + 0.5).astype(dtype)


def srgb2linear(img):
    return img ** 2.2


def linear2srgb(img):
    """numpy array or torch tensor: clipped at 0, then gamma 1/2.2."""
    if isinstance(img, torch.Tensor):
        return img.clamp_min(0.0) ** (1.0 / 2.2)
    return np.clip(img, 0.0, None) ** (1.0 / 2.2)


def norm_to_rgb(norm: np.ndarray) -> np.ndarray:
    """[-1, 1] normals [H, W, 3] -> uint8 RGB."""
    return float2int((np.asarray(norm) + 1.0) / 2.0)


def to_image(rgb_u8: np.ndarray):
    """[H, W, 3] uint8 -> a PIL image when PIL is installed, else the array."""
    try:
        from PIL import Image
    except ImportError:
        return rgb_u8
    return Image.fromarray(rgb_u8)
