"""The port's fast checkpoint ingest (`models/fastload.py`: mmap'd slabs,
one copy per slab, casts on the device, `load_state_dict(assign=True)`)
against the per-tensor path (`weights.load_state_dict` + `build_module`)
on the CPU, as tests/test_fastload.py holds the JAX package's: every
parameter bit for bit for each component of a tiny SD2 checkpoint in fp32,
bf16 and fp16, for the fp16 weight variant, sharded files, many small slabs,
BF16-stored and unaligned tensors; truncated or corrupt files raising; and
the loaders taking the card unless given the CPU."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from marigold_tpu_torch.models import fastload
from marigold_tpu_torch.models import weights as W
from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from marigold_tpu_torch.pipelines import base as tbase
from test_torch_train_cli import write_port_sd2

PARTS = [("unet", UNet2DConditionModel, UNetConfig, ""),
         ("vae", AutoencoderKL, VAEConfig, ""),
         ("text_encoder", CLIPTextModel, CLIPTextConfig, "text_model.")]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_port_sd2(str(tmp_path_factory.mktemp("fastload")))


def _per_tensor(cls, cfg, path, dtype, variant=None, strip=""):
    return W.build_module(cls, cfg, W.load_state_dict(path, variant, strip),
                          dtype, "cpu")


def _assert_same(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape, k
        assert torch.equal(sa[k].view(torch.uint8), sb[k].view(torch.uint8)), k
    assert not any(p.requires_grad for p in a.parameters())
    assert not a.training


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sub,cls,cfg_cls,strip", PARTS)
def test_every_parameter_matches_the_per_tensor_path(ckpt, sub, cls, cfg_cls,
                                                     strip, dtype):
    path = os.path.join(ckpt, sub)
    cfg = cfg_cls.from_dict(W.read_config(path))
    fast = fastload.load_module(cls, cfg, path, dtype, "cpu", strip_prefix=strip)
    _assert_same(fast, _per_tensor(cls, cfg, path, dtype, strip=strip))


def test_fp16_variant_sharded_files_and_small_slabs(ckpt, tmp_path, monkeypatch):
    """The UNet stored as the fp16 variant in two shards, loaded in many
    small slabs: the variant's files are chosen over the plain ones, and
    every parameter is the per-tensor path's."""
    src = os.path.join(ckpt, "unet")
    sd = {k: v.half() for k, v in W.load_state_dict(src).items()}
    names = sorted(sd)
    d = tmp_path / "unet"
    W.write_config(W.read_config(src), str(d))
    W.write_safetensors({k: sd[k] for k in names[::2]},
                        str(d / "diffusion_pytorch_model.fp16-00001-of-00002.safetensors"))
    W.write_safetensors({k: sd[k] for k in names[1::2]},
                        str(d / "diffusion_pytorch_model.fp16-00002-of-00002.safetensors"))
    W.write_safetensors({k: torch.zeros_like(v) for k, v in sd.items()},
                        str(d / "diffusion_pytorch_model.safetensors"))
    monkeypatch.setattr(fastload, "SLAB_TARGET_BYTES", 4096)
    specs, slabs = fastload.plan(W.select_safetensor_files(str(d), "fp16"))
    assert len(slabs) > 10 and len(specs) == len(sd)
    cfg = UNetConfig.from_dict(W.read_config(src))
    for dtype in (torch.float32, torch.bfloat16):
        fast = fastload.load_module(UNet2DConditionModel, cfg, str(d), dtype,
                                    "cpu", variant="fp16")
        _assert_same(fast, _per_tensor(UNet2DConditionModel, cfg, str(d), dtype,
                                       variant="fp16"))
        assert all(p.abs().sum() > 0 for p in fast.parameters()
                   if p.ndim > 1)  # the variant, not the zeroed plain file


def _write_raw(path, header: dict, data: bytes):
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob + data)


def test_bf16_stored_and_unaligned_tensors(tmp_path):
    """A BF16 tensor and an F16 tensor at an odd byte offset (no writer of
    the port makes one, a hand-made file can) come out bit for bit."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal(5).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32)).half()
    data = b"\x07" + b.view(torch.uint8).numpy().tobytes() + \
        a.view(torch.uint8).numpy().tobytes()
    _write_raw(tmp_path / "m.safetensors", {
        "b": {"dtype": "F16", "shape": [2, 3], "data_offsets": [1, 13]},
        "a": {"dtype": "BF16", "shape": [5], "data_offsets": [13, 23]},
        "pad": {"dtype": "U8", "shape": [1], "data_offsets": [0, 1]},
    }, data)
    got = fastload.load_state_dict(str(tmp_path / "m.safetensors"), "cpu")
    assert torch.equal(got["a"].view(torch.int16), a.view(torch.int16))
    assert torch.equal(got["b"].view(torch.int16), b.reshape(2, 3).view(torch.int16))
    assert got["pad"].dtype == torch.uint8
    cast = fastload.load_state_dict(str(tmp_path / "m.safetensors"), "cpu",
                                    torch.float32)
    assert torch.equal(cast["a"], a.float()) and cast["pad"].dtype == torch.uint8


def test_truncated_or_corrupt_files_raise(ckpt, tmp_path):
    f = tmp_path / "m.safetensors"
    _write_raw(f, {"t": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}},
               b"\0" * 8)
    with pytest.raises(ValueError, match="t.*data region"):
        fastload.load_state_dict(str(f), "cpu")
    _write_raw(f, {"t": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}},
               b"\0" * 8)
    with pytest.raises(ValueError, match="needs 16"):
        fastload.load_state_dict(str(f), "cpu")
    _write_raw(f, {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                   "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}},
               b"\0" * 12)
    with pytest.raises(ValueError, match="overlaps"):
        fastload.load_state_dict(str(f), "cpu")
    _write_raw(f, {"t": {"dtype": "F8_E9", "shape": [1], "data_offsets": [0, 1]}},
               b"\0")
    with pytest.raises(NotImplementedError, match="F8_E9"):
        fastload.load_state_dict(str(f), "cpu")
    # a real component file cut short
    d = tmp_path / "vae"
    src = os.path.join(ckpt, "vae")
    W.write_config(W.read_config(src), str(d))
    blob = open(os.path.join(src, "diffusion_pytorch_model.safetensors"), "rb").read()
    (d / "diffusion_pytorch_model.safetensors").write_bytes(blob[:-100])
    with pytest.raises(ValueError, match="truncated"):
        W.load_vae(str(d), device="cpu")


@pytest.mark.parametrize("flag", ["1", "0"])
def test_the_loaders_take_the_card_unless_given_the_cpu(ckpt, monkeypatch, flag):
    """MARIGOLD_TPU_FASTLOAD=0 keeps the per-tensor path; either way the
    loaders and load_pipeline_components load onto the CUDA device by
    default and raise without one."""
    monkeypatch.setenv("MARIGOLD_TPU_FASTLOAD", flag)
    calls = []
    load_module = fastload.load_module
    monkeypatch.setattr(fastload, "load_module",
                        lambda *a, **k: calls.append(1) or load_module(*a, **k))
    unet = W.load_unet(os.path.join(ckpt, "unet"), torch.bfloat16, device="cpu")
    assert len(calls) == (flag == "1")
    assert all(p.dtype == torch.bfloat16 and p.device.type == "cpu"
               for p in unet.parameters())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    for load, sub in ((W.load_unet, "unet"), (W.load_vae, "vae"),
                      (W.load_text_encoder, "text_encoder")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(os.path.join(ckpt, sub))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbase.load_pipeline_components(ckpt)
    core, _ = tbase.load_pipeline_components(ckpt, torch.float32, "cpu")
    assert core.device.type == "cpu"
