"""Minimal pure-Python OpenEXR codec (scanline images).

Why this exists: the reference reads InteriorVerse/Hypersim HDR images with
OpenCV built against OpenEXR (reference src/util/image_util.py); many
deployment images (including this one) ship cv2 with `OpenEXR: NO`, which
makes `cv2.imread` silently return None for every .exr. This module is the
dependency-free fallback: it decodes the subset of EXR that dataset files
actually use — single-part scanline images, NO/ZIPS/ZIP compression,
HALF/FLOAT/UINT channels — and encodes uncompressed FLOAT scanline files
(fixtures, preprocessing outputs).

Format reference: the public OpenEXR file layout specification
(openexr.com/en/latest/OpenEXRFileLayout.html).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}

# compression id -> scanlines per block
_BLOCK_LINES = {0: 1, 1: 1, 2: 1, 3: 16}  # NO, RLE, ZIPS, ZIP
_SUPPORTED_COMPRESSION = {0, 2, 3}


class ExrError(ValueError):
    pass


def _read_cstring(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    """chlist -> [(name, pixel_type)], in storage (alphabetical) order."""
    out = []
    pos = 0
    while pos < len(data) and data[pos] != 0:
        name, pos = _read_cstring(data, pos)
        (ptype,) = struct.unpack_from("<i", data, pos)
        pos += 16  # type(4) + pLinear+pad(4) + xSampling(4) + ySampling(4)
        out.append((name, ptype))
    return out


def _unpredict_deinterleave(raw: bytes) -> bytes:
    """Invert the ZIP/ZIPS post-deflate reorder: byte-delta predictor, then
    the two-half interleave (OpenEXR ImfZip.cpp)."""
    arr = np.frombuffer(raw, np.uint8).astype(np.int64)
    arr[1:] -= 128
    arr = np.cumsum(arr).astype(np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def read_exr(data: bytes) -> np.ndarray:
    """Decode single-part scanline EXR bytes -> [H,W] or [H,W,C] float32
    (channels in R,G,B(,A) order when present; alphabetical otherwise).
    UINT channels pass through as their float value."""
    if len(data) < 8 or struct.unpack_from("<i", data, 0)[0] != _MAGIC:
        raise ExrError("not an EXR file (bad magic)")
    version = struct.unpack_from("<i", data, 4)[0]
    # version-field flag bits (OpenEXRFileLayout): 9 = tiled, 11 = deep
    # data, 12 = multi-part; the low byte is the format version number
    if version & 0x1000:
        raise ExrError("multi-part EXR is not supported")
    if version & 0x200:
        raise ExrError("tiled EXR is not supported")
    if version & 0x800:
        raise ExrError("deep-data EXR is not supported")
    if version & 0xFF not in (1, 2):
        raise ExrError(f"unsupported EXR version {version}")

    pos = 8
    attrs: Dict[str, bytes] = {}
    while data[pos] != 0:
        name, pos = _read_cstring(data, pos)
        _typ, pos = _read_cstring(data, pos)
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = data[pos : pos + size]
        pos += size
    pos += 1  # header terminator

    channels = _parse_channels(attrs["channels"])
    compression = attrs["compression"][0]
    if compression not in _SUPPORTED_COMPRESSION:
        raise ExrError(
            f"unsupported EXR compression id {compression} "
            "(supported: NONE, ZIPS, ZIP)"
        )
    x_min, y_min, x_max, y_max = struct.unpack("<4i", attrs["dataWindow"])
    w, h = x_max - x_min + 1, y_max - y_min + 1
    if attrs.get("lineOrder", b"\0")[0] not in (0, 1):
        raise ExrError("random-Y line order is not supported")

    block_lines = _BLOCK_LINES[compression]
    n_blocks = -(-h // block_lines)
    # skip the offset table; blocks follow contiguously and are
    # self-describing (robust to files with a zeroed table)
    pos += 8 * n_blocks

    itemsizes = [np.dtype(_PIXEL_DTYPES[pt]).itemsize for _, pt in channels]
    line_raw = w * sum(itemsizes)

    planes = {
        name: np.empty((h, w), np.float32) for name, _ in channels
    }
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        payload = data[pos : pos + size]
        pos += size
        y0 = y - y_min
        n_lines = min(block_lines, h - y0)
        raw_len = line_raw * n_lines
        if compression != 0 and size < raw_len:
            payload = _unpredict_deinterleave(zlib.decompress(payload))
        if len(payload) != raw_len:
            raise ExrError(
                f"scanline block at y={y}: got {len(payload)} bytes, "
                f"expected {raw_len}"
            )
        off = 0
        for line in range(n_lines):
            for (name, ptype), isz in zip(channels, itemsizes):
                row = np.frombuffer(
                    payload, _PIXEL_DTYPES[ptype], count=w, offset=off
                )
                planes[name][y0 + line] = row.astype(np.float32)
                off += w * isz

    names = [n for n, _ in channels]
    if len(names) == 1:
        return planes[names[0]]
    order = [n for n in ("R", "G", "B", "A") if n in planes]
    order += [n for n in sorted(names) if n not in order]
    return np.stack([planes[n] for n in order], axis=-1)


def write_exr(path: str, arr: np.ndarray) -> None:
    """Encode [H,W] (Y) or [H,W,3] (RGB) float32 as an uncompressed
    scanline EXR readable by any conforming reader (incl. read_exr and
    OpenEXR-enabled cv2)."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, nch = arr.shape
    if nch not in (1, 3):
        raise ExrError(f"write_exr supports 1 or 3 channels, got {nch}")
    # storage order is alphabetical; map storage name -> RGB source index
    names = ["Y"] if nch == 1 else ["B", "G", "R"]
    src = {"Y": 0, "B": 2, "G": 1, "R": 0}

    def attr(name: str, typ: str, payload: bytes) -> bytes:
        return (
            name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload
        )

    chlist = b""
    for cn in names:
        chlist += (
            cn.encode() + b"\0" + struct.pack("<i", 2)  # FLOAT
            + b"\0\0\0\0" + struct.pack("<ii", 1, 1)
        )
    chlist += b"\0"
    header = (
        attr("channels", "chlist", chlist)
        + attr("compression", "compression", b"\0")
        + attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
        + attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    pre = struct.pack("<ii", _MAGIC, 2)
    table_pos = len(pre) + len(header)
    data_start = table_pos + 8 * h
    line_bytes = 8 + w * 4 * nch
    offsets = struct.pack(f"<{h}Q", *(data_start + y * line_bytes
                                      for y in range(h)))
    blocks = []
    for y in range(h):
        block = struct.pack("<ii", y, w * 4 * nch)
        for cn in names:
            block += arr[y, :, src[cn]].tobytes()
        blocks.append(block)
    with open(path, "wb") as f:
        f.write(pre + header + offsets + b"".join(blocks))
