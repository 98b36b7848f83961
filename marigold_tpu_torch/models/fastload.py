"""Fast checkpoint ingest: mmap'd safetensors, a few large slabs staged
through pinned host buffers, one host-to-device copy per slab, the casts on
the device.

Counterpart of `marigold_tpu/models/fastload.py` (`_plan`,
`load_tree_ondevice`, `enabled`). The per-tensor path of
`models/weights.py` reads each file into one host buffer and copies the
module's parameters tensor by tensor from it, casting on the host side of
each copy: ~700 small host-to-device copies at SD2 scale. Here:

  1. each file's header is parsed (8-byte little-endian length, JSON) and
     its data region memory-mapped; the header's offsets are checked before
     any byte is trusted, so a truncated or corrupt file raises ValueError
     here;
  2. the data region is cut into slabs of about SLAB_TARGET_BYTES, split
     only at tensor boundaries;
  3. each slab is copied from the map into one of two pinned host buffers
     and sent to the device in one non-blocking copy, so the next slab's
     host copy overlaps this one's transfer;
  4. each tensor is a view of its slab on the device, reinterpreted in its
     stored dtype, reshaped, and cast there to the requested dtype (or
     copied out, so that no slab outlives its loop iteration);
  5. `load_module` fills a module built on the meta device with
     `load_state_dict(..., assign=True)`: no random init, no second copy.

The TPU package's byte-lane bitcast (`_bitcast_1d`) and per-slab unpack
programs exist for XLA's layouts and compile-time memory; eager PyTorch
reinterprets a byte view directly and has no counterpart of either. The
names follow `weights.checkpoint_name`, the one mapping both paths use.

Errors are not swallowed: the TPU package's loader falls back to its host
path on any device error (`marigold_tpu/models/weights.py:223`, a bare
`except Exception`); here a failed device load raises. MARIGOLD_TPU_FASTLOAD=0
selects the per-tensor path (`weights.load_state_dict` + `build_module`), as
in the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from marigold_tpu_torch.models import weights as W

SLAB_TARGET_BYTES = 256 * 1024 * 1024


def enabled() -> bool:
    """False when MARIGOLD_TPU_FASTLOAD=0 (read at each call)."""
    return os.environ.get("MARIGOLD_TPU_FASTLOAD", "1") != "0"


@dataclass(frozen=True)
class TensorSpec:
    name: str
    st_dtype: str
    shape: tuple
    slab: int  # index into the slabs
    offset: int  # byte offset within the slab
    nbytes: int


def parse_header(fname: str) -> tuple[dict, int]:
    """(header without __metadata__, file offset of the data region)."""
    with open(fname, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def plan(files: list[str]) -> tuple[list[TensorSpec], list[np.ndarray]]:
    """Every tensor of `files` packed into boundary-aligned slabs:
    (specs, slabs as read-only uint8 views of the files' maps). Raises
    ValueError for offsets outside the data region, a size that does not
    match the shape, or overlapping tensors; NotImplementedError for a
    dtype the format names and torch lacks."""
    specs: list[TensorSpec] = []
    slabs: list[np.ndarray] = []
    for fname in files:
        header, data_start = parse_header(fname)
        entries = sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0])
        mm = np.memmap(fname, dtype=np.uint8, mode="r")
        data_size = mm.shape[0] - data_start
        prev_end = 0
        for name, meta in entries:
            if meta["dtype"] not in W._ST_DTYPES:
                raise NotImplementedError(
                    f"fastload: unsupported safetensors dtype {meta['dtype']} "
                    f"for {name!r} in {fname}")
            e0, e1 = meta["data_offsets"]
            want = math.prod(meta["shape"]) * W._ST_DTYPES[meta["dtype"]].itemsize
            if not 0 <= e0 <= e1 <= data_size:
                raise ValueError(
                    f"fastload: {name!r} in {fname} declares data_offsets "
                    f"[{e0}, {e1}) outside the {data_size}-byte data region "
                    "(truncated or corrupt checkpoint?)")
            if e1 - e0 != want:
                raise ValueError(
                    f"fastload: {name!r} in {fname} declares {e1 - e0} bytes "
                    f"but shape {tuple(meta['shape'])} x {meta['dtype']} "
                    f"needs {want}")
            if e0 < prev_end:
                raise ValueError(
                    f"fastload: {name!r} in {fname} overlaps the previous "
                    "tensor's data region (corrupt header)")
            prev_end = e1
        i = 0
        while i < len(entries):
            begin = end = entries[i][1]["data_offsets"][0]
            j = i
            while j < len(entries):
                e1 = entries[j][1]["data_offsets"][1]
                if e1 - begin > SLAB_TARGET_BYTES and j > i:
                    break
                end = e1
                j += 1
            for name, meta in entries[i:j]:
                e0, e1 = meta["data_offsets"]
                specs.append(TensorSpec(name, meta["dtype"], tuple(meta["shape"]),
                                        len(slabs), e0 - begin, e1 - e0))
            slabs.append(mm[data_start + begin:data_start + end])
            i = j
    return specs, slabs


def _unpack(slab: torch.Tensor, spec: TensorSpec,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One tensor out of a device slab, in `dtype` for floating tensors (the
    stored dtype otherwise), in memory of its own."""
    st = W._ST_DTYPES[spec.st_dtype]
    raw = slab[spec.offset:spec.offset + spec.nbytes]
    if spec.offset % st.itemsize:  # unaligned in the file: copy out first
        raw = raw.clone()
    t = raw.view(st).reshape(spec.shape)
    if dtype is not None and t.is_floating_point() and st != dtype:
        return t.to(dtype)
    return t.clone()


def load_state_dict(path: str, device, dtype: Optional[torch.dtype] = None,
                    variant: Optional[str] = None,
                    strip_prefix: str = "") -> dict[str, torch.Tensor]:
    """A safetensors file or component dir -> {port name: tensor on
    `device`}, floating tensors cast to `dtype` on the device (None: as
    stored)."""
    device = torch.device(device)
    specs, slabs = plan(W.select_safetensor_files(path, variant))
    pinned = device.type == "cuda"
    size = max((s.shape[0] for s in slabs), default=0)
    stage = [torch.empty(size, dtype=torch.uint8, pin_memory=pinned)
             for _ in range(2 if pinned else 1)]
    done = [None] * len(stage)  # the copy that last read each buffer
    by_slab: dict[int, list[TensorSpec]] = {}
    for s in specs:
        by_slab.setdefault(s.slab, []).append(s)
    out = {}
    for i, host in enumerate(slabs):
        buf = stage[i % len(stage)]
        if done[i % len(stage)] is not None:
            done[i % len(stage)].synchronize()
        n = host.shape[0]
        buf[:n].numpy()[:] = host
        if pinned:
            slab = torch.empty(n, dtype=torch.uint8, device=device)
            slab.copy_(buf[:n], non_blocking=True)
            done[i % len(stage)] = torch.cuda.Event()
            done[i % len(stage)].record()
        else:
            slab = buf[:n].to(device, copy=True)
        for spec in by_slab.get(i, ()):
            out[W.checkpoint_name(spec.name, strip_prefix)] = _unpack(
                slab, spec, dtype)
        del slab
    return out


def load_module(cls, cfg, path: str, dtype: torch.dtype, device,
                variant: Optional[str] = None,
                strip_prefix: str = "") -> nn.Module:
    """`cls(cfg)` built on the meta device and filled from the checkpoint
    at `path` by `load_state_dict(..., assign=True)`, in `dtype` on
    `device`; the same checks as `weights.build_module` (every parameter
    present, `position_ids` and `text_projection` ignored)."""
    with torch.device("meta"):
        model = cls(cfg)
    sd = load_state_dict(path, device, dtype, variant, strip_prefix)
    sd = {k: v for k, v in sd.items() if not W._IGNORED_KEYS.search(k)}
    missing, unexpected = model.load_state_dict(sd, strict=False, assign=True)
    if missing or unexpected:
        raise ValueError(f"{cls.__name__}: missing {missing[:8]}"
                         f"{'...' if len(missing) > 8 else ''}, unexpected "
                         f"{unexpected[:8]}{'...' if len(unexpected) > 8 else ''}")
    return model.eval().requires_grad_(False)
