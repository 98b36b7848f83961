"""Checkpoint I/O for the port: diffusers-layout safetensors <-> torch
modules.

Diffusers checkpoints are stored in torch layout (OIHW convs, [out, in]
linears), which is the port's own layout, so loading is a name mapping:
  * the `text_model.` prefix of transformers CLIP checkpoints is stripped
    and a CLIPModel's `text_projection` is dropped;
  * historical diffusers VAE attention names (query/key/value/proj_attn)
    become to_q/to_k/to_v/to_out.0;
  * HF weight variants (`model.fp16.safetensors`) are selected as the JAX
    package does (`marigold_tpu/models/weights.py:select_safetensor_files`).

The safetensors format is read and written here, without the safetensors
package: an 8-byte little-endian header length, a JSON header of
{name: {dtype, shape, data_offsets}}, then the raw little-endian bytes.

`from_jax_tree` carries the JAX package's parameter trees across (HWIO ->
OIHW, [in, out] -> [out, in]; embeddings as they are), the inverse of the
JAX package's `torch_to_tree`.

The component loaders (`load_unet`, `load_vae`, `load_text_encoder`) load
onto the CUDA device unless given another, and raise without one, as the
JAX package's load onto its default accelerator; they go through
`models/fastload.py` unless MARIGOLD_TPU_FASTLOAD=0.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import struct
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)

_VAE_ATTN_ALIASES = {
    "query": "to_q",
    "key": "to_k",
    "value": "to_v",
    "proj_attn": "to_out.0",
}
_EMBEDDING_MARKERS = ("token_embedding", "position_embedding", "embeddings")
# keys some checkpoints carry that are no parameter of the port's modules
_IGNORED_KEYS = re.compile(r"(^|\.)position_ids$|^text_projection\.")

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


# ------------------------------------------------------------------ #
# safetensors


def read_safetensors_header(path: str) -> dict[str, tuple[tuple, str]]:
    """{name: (shape, dtype)} of one .safetensors file from its header
    alone (the 8-byte length and the JSON after it); no tensor byte is
    read. dtype is the format's own name ("F16", "F32", ...)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return {name: (tuple(meta["shape"]), meta["dtype"])
            for name, meta in header.items() if name != "__metadata__"}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """All tensors of one .safetensors file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        f.readinto(data)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        dtype = _ST_DTYPES[meta["dtype"]]
        shape = tuple(meta["shape"])
        count = math.prod(shape)
        if end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: {name} has {end - begin} bytes for "
                             f"shape {shape} {meta['dtype']}")
        if not count:
            t = torch.empty(0, dtype=dtype)
        elif begin % dtype.itemsize:  # unaligned: copy out
            t = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
        out[name] = t.reshape(shape)
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write tensors (on any device) to one .safetensors file, copying one
    tensor at a time to the host."""
    header, offset = {}, 0
    # largest element size first, as the safetensors package orders them,
    # so every tensor starts aligned to its element size
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().data)


def select_safetensor_files(path: str, variant: Optional[str] = None) -> list[str]:
    """`path` (a file or a component dir) -> the .safetensors files to load,
    honoring HF weight variants: variant=None loads the non-variant files,
    variant="fp16" the *.fp16.safetensors ones; if nothing matches, one
    group (plain first, else the first variant by name) is loaded."""
    if os.path.isfile(path):
        return [path]
    names = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    shard = r"(?:-\d+-of-\d+)?\.safetensors$"
    var_re = re.compile(r"\.(fp16|bf16|fp32)" + shard)
    if variant:
        pat = re.compile(re.escape(f".{variant}") + shard)
        want = [f for f in names if pat.search(f)]
    else:
        want = [f for f in names if not var_re.search(f)]
    if not want:
        groups: dict = {}
        for f in names:
            m = var_re.search(f)
            groups.setdefault(m.group(1) if m else None, []).append(f)
        if groups:
            chosen = None if None in groups else sorted(
                k for k in groups if k is not None)[0]
            logger.warning("no %s weights under %s; loading %s",
                           "plain" if variant is None else repr(variant), path,
                           chosen or "plain")
            want = groups[chosen]
    if not want:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return sorted(os.path.join(path, f) for f in want)


def checkpoint_name(name: str, strip_prefix: str = "") -> str:
    """Checkpoint tensor name -> the port's state-dict key."""
    if strip_prefix and name.startswith(strip_prefix):
        name = name[len(strip_prefix):]
    return ".".join(_VAE_ATTN_ALIASES.get(p, p) for p in name.split("."))


def load_state_dict(path: str, variant: Optional[str] = None,
                    strip_prefix: str = "") -> dict[str, torch.Tensor]:
    flat: dict[str, torch.Tensor] = {}
    for f in select_safetensor_files(path, variant):
        for name, t in read_safetensors(f).items():
            flat[checkpoint_name(name, strip_prefix)] = t
    return flat


# ------------------------------------------------------------------ #
# JAX trees


def _is_embedding(parts) -> bool:
    return any(m in parts for m in _EMBEDDING_MARKERS)


def from_jax_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested JAX parameter tree (leaves convertible with np.asarray) ->
    flat torch state dict: HWIO -> OIHW, [in, out] -> [out, in],
    embeddings, norms and biases unchanged."""
    out: dict[str, torch.Tensor] = {}

    def rec(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                rec(v, path + (k,))
            return
        value = np.asarray(node)
        if path[-1] == "weight":
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2 and not _is_embedding(path):
                value = value.T
        out[prefix + ".".join(path)] = torch.from_numpy(np.array(value, order="C"))

    rec(tree, ())
    return out


# ------------------------------------------------------------------ #
# modules


def random_state_dict(model: nn.Module, generator: torch.Generator,
                      dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Random parameters by the JAX package's init scheme
    (`marigold_tpu/models/layers.py:init_*`): conv and linear weights
    uniform in +-1/sqrt(fan_in), biases 0, norm weights 1, embeddings
    N(0, 0.02). `model` may live on the meta device; draws run on the
    generator's device, in state-dict order."""
    device = generator.device
    out = {}
    for name, p in model.state_dict().items():
        parts = name.split(".")
        if parts[-1] == "bias":
            t = torch.zeros(p.shape, device=device)
        elif p.ndim == 1:
            t = torch.ones(p.shape, device=device)
        elif _is_embedding(parts):
            t = torch.randn(p.shape, generator=generator, device=device) * 0.02
        else:
            lim = 1.0 / math.sqrt(math.prod(p.shape[1:]))
            t = torch.rand(p.shape, generator=generator, device=device)
            t = t.mul_(2 * lim).sub_(lim)
        out[name] = t.to(dtype)
    return out


def build_module(cls, cfg, state_dict: Mapping[str, torch.Tensor],
                 dtype: torch.dtype, device) -> nn.Module:
    """Instantiate `cls(cfg)` on `device` in `dtype` without a random init
    and fill it from `state_dict` (every parameter must be present;
    `position_ids` and `text_projection` are ignored)."""
    with torch.device("meta"):
        model = cls(cfg)
    model = model.to(dtype=dtype).to_empty(device=device)
    sd = {k: v for k, v in state_dict.items() if not _IGNORED_KEYS.search(k)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise ValueError(f"{cls.__name__}: missing {missing[:8]}"
                         f"{'...' if len(missing) > 8 else ''}, unexpected "
                         f"{unexpected[:8]}{'...' if len(unexpected) > 8 else ''}")
    return model.eval().requires_grad_(False)


def read_config(dirpath: str, filename: str = "config.json") -> dict:
    with open(os.path.join(dirpath, filename)) as f:
        return json.load(f)


def write_config(cfg: Mapping[str, Any], dirpath: str,
                 filename: str = "config.json") -> None:
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, filename), "w") as f:
        json.dump(dict(cfg), f, indent=2)


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA device when None; a CUDA device without one
    raises (no silent fallback to the CPU: the CPU is asked for by
    `device="cpu"`)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port loads onto the CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to load "
            "onto the CPU")
    return device


def load_component(cls, cfg, subdir: str, dtype, device, variant=None,
                   strip_prefix: str = "") -> nn.Module:
    """One component dir -> `cls(cfg)` in `dtype` on `device` (None: the
    CUDA device, raising without one), by `models/fastload.py` unless
    MARIGOLD_TPU_FASTLOAD=0 selects the per-tensor path (`load_state_dict`
    + `build_module`). Either path raises on a failed load."""
    from marigold_tpu_torch.models import fastload

    device = resolve_device(device)
    if fastload.enabled():
        return fastload.load_module(cls, cfg, subdir, dtype, device, variant,
                                    strip_prefix)
    return build_module(cls, cfg, load_state_dict(subdir, variant, strip_prefix),
                        dtype, device)


def load_unet(subdir: str, dtype=torch.float32, device=None,
              variant: Optional[str] = None):
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

    cfg = UNetConfig.from_dict(read_config(subdir))
    return load_component(UNet2DConditionModel, cfg, subdir, dtype, device,
                          variant)


def load_vae(subdir: str, dtype=torch.float32, device=None,
             variant: Optional[str] = None):
    from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    cfg = VAEConfig.from_dict(read_config(subdir))
    return load_component(AutoencoderKL, cfg, subdir, dtype, device, variant)


def load_text_encoder(subdir: str, dtype=torch.float32, device=None,
                      variant: Optional[str] = None):
    from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel

    cfg = CLIPTextConfig.from_dict(read_config(subdir))
    return load_component(CLIPTextModel, cfg, subdir, dtype, device, variant,
                          strip_prefix="text_model.")


def save_component(cfg_dict: Mapping[str, Any], state_dict: Mapping[str, torch.Tensor],
                   subdir: str, filename: str, prefix: str = "") -> None:
    """config.json + one safetensors file, names prefixed (e.g.
    "text_model." for a transformers text encoder)."""
    write_config(cfg_dict, subdir)
    write_safetensors({prefix + k: v for k, v in state_dict.items()},
                      os.path.join(subdir, filename))
