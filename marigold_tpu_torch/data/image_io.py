"""Host-side image IO for the data layer.

Behavioral reference: src/util/image_util.py:99-128 — PNG via PIL
(normalized to [0,1]), HDR .exr via OpenCV (OPENCV_IO_ENABLE_OPENEXR),
reading from plain files or tar members; sRGB<->linear gamma 2.2.
"""

from __future__ import annotations

import io
import os

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")

import numpy as np
from PIL import Image

HDR_EXTENSIONS = (".exr", ".hdr")


def is_hdr(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in HDR_EXTENSIONS


def img_linear2srgb(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0.0, None) ** (1.0 / 2.2)


def img_srgb2linear(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0.0, None) ** 2.2


def _decode_exr_bytes(data: bytes) -> np.ndarray:
    img = _decode_exr_cv2(data)
    if img is None:
        # cv2 builds without OpenEXR (`OpenEXR: NO`, common in minimal
        # images) silently return None — fall back to the pure-Python
        # scanline decoder (data/exr.py)
        from marigold_tpu_torch.data.exr import read_exr

        return np.ascontiguousarray(read_exr(data).astype(np.float32))
    if img.ndim == 3 and img.shape[-1] == 3:
        img = img[..., ::-1]  # BGR -> RGB
    return np.ascontiguousarray(img.astype(np.float32))


def _decode_exr_cv2(data: bytes):
    import tempfile

    try:
        import cv2
    except ImportError:
        return None

    # cv2.imdecode does not support EXR streams on all builds; go via file
    with tempfile.NamedTemporaryFile(suffix=".exr", delete=False) as f:
        f.write(data)
        tmp = f.name
    try:
        return cv2.imread(tmp, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    finally:
        os.unlink(tmp)


def decode_image_bytes(data: bytes, path_hint: str = "") -> np.ndarray:
    """bytes -> [H,W,C] (or [H,W]) float array in [0,1] (LDR) or linear
    radiance (HDR). Mirrors reference read_img_from_file/tar semantics."""
    if is_hdr(path_hint):
        img = _decode_exr_bytes(data)
        return np.clip(img, 0.0, 1.0) if img.max() <= 1.0 + 1e-6 else np.clip(
            img, 0.0, None
        )
    img = np.asarray(Image.open(io.BytesIO(data)))
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def read_img_from_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image_bytes(f.read(), path)


def read_exr_raw(path: str) -> np.ndarray:
    """Decode an EXR without any range clipping — required for signed data
    (normal maps), where decode_image_bytes' non-negative radiance clip
    would zero out the negative components."""
    with open(path, "rb") as f:
        return _decode_exr_bytes(f.read())


def read_img_from_tar(tar_obj, rel_path: str) -> np.ndarray:
    member = tar_obj.extractfile("./" + rel_path)
    return decode_image_bytes(member.read(), rel_path)
