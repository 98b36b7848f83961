"""The port's checkpoint manifest (models/manifest.py) and validate_ckpt CLI
against the JAX package's, on the tiny checkpoints of tests/fixtures.py.

The expected manifests must be equal as dicts for every component of the
depth, normals, IID-appearance and IID-lighting checkpoints, and of the
full SD2 configuration. On broken checkpoints both reports and both CLI
exit codes must agree. The header-only reader must give read_safetensors'
shapes without reading a tensor byte."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from fixtures import make_tiny_checkpoint
from marigold_tpu.cli.validate_ckpt import main as jax_validate
from marigold_tpu.models import manifest as jm
from marigold_tpu_torch.cli.validate_ckpt import main as torch_validate
from marigold_tpu_torch.models import manifest as tm
from marigold_tpu_torch.models import weights as W

KINDS = ("unet", "vae", "text_encoder")
CKPTS = {"depth": {"mode": "depth"}, "normals": {"mode": "normals"},
         "iid_appearance": {"mode": "iid"},
         "iid_lighting": {"mode": "iid", "iid_variant": "lighting"}}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return {name: make_tiny_checkpoint(str(tmp_path_factory.mktemp(name)), **kw)
            for name, kw in CKPTS.items()}


@pytest.mark.parametrize("name", list(CKPTS))
def test_expected_manifest_matches_jax(ckpts, name):
    for kind in KINDS:
        ref = jm.expected_component_manifest(
            kind, jm._component_config(ckpts[name], kind))
        got = tm.expected_component_manifest(
            kind, tm._component_config(ckpts[name], kind))
        assert got == ref, kind
    assert tm.validate_checkpoint(ckpts[name]) == jm.validate_checkpoint(
        ckpts[name])


def test_expected_manifest_matches_jax_at_sd2_width():
    """The full SD2 configurations (each package's config defaults)."""
    from marigold_tpu.models import clip_text as jclip
    from marigold_tpu.models import unet as junet
    from marigold_tpu.models import vae as jvae
    from marigold_tpu_torch.models import clip_text as tclip
    from marigold_tpu_torch.models import unet as tunet
    from marigold_tpu_torch.models import vae as tvae

    for kind, jcfg, tcfg in [("unet", junet.UNetConfig(), tunet.UNetConfig()),
                             ("vae", jvae.VAEConfig(), tvae.VAEConfig()),
                             ("text_encoder", jclip.CLIPTextConfig(),
                              tclip.CLIPTextConfig())]:
        got = tm.expected_component_manifest(kind, tcfg)
        assert got == jm.expected_component_manifest(kind, jcfg), kind
    assert got["text_model.embeddings.token_embedding.weight"] == (49408, 1024)


def _rewrite(path, drop=None, grow=None, add=None):
    tensors = W.read_safetensors(path)
    if drop is not None:
        tensors.pop(drop)
    if grow is not None:
        t = tensors[grow]
        tensors[grow] = torch.zeros((t.shape[0] + 1,) + tuple(t.shape[1:]),
                                    dtype=t.dtype)
    if add is not None:
        tensors[add] = torch.zeros((2, 2))
    W.write_safetensors(tensors, path)


def _broken(ckpt, root, case):
    d = os.path.join(root, case)
    shutil.copytree(ckpt, d)
    vae = os.path.join(d, "vae", "diffusion_pytorch_model.safetensors")
    unet = os.path.join(d, "unet", "diffusion_pytorch_model.safetensors")
    if case == "missing_tensor":
        _rewrite(vae, drop="encoder.conv_in.weight")
    elif case == "shape_mismatch":
        _rewrite(unet, grow="conv_out.bias")
    elif case == "missing_scheduler":
        shutil.rmtree(os.path.join(d, "scheduler"))
    elif case == "unexpected_keys":
        _rewrite(vae, add="totally_new.weight")
    elif case == "empty":
        shutil.rmtree(d)
        os.makedirs(d)
    elif case == "not_a_directory":
        shutil.rmtree(d)
    return d


@pytest.mark.parametrize("case", ["missing_tensor", "shape_mismatch",
                                  "missing_scheduler", "unexpected_keys",
                                  "empty", "not_a_directory"])
def test_broken_checkpoints_report_as_jax(ckpts, tmp_path, case, capsys):
    d = _broken(ckpts["depth"], str(tmp_path), case)
    ref, got = jm.validate_checkpoint(d), tm.validate_checkpoint(d)
    assert got == ref
    assert tm.format_report(got) == jm.format_report(ref)
    assert got["ok"] == (case == "unexpected_keys")
    if case == "missing_tensor":
        assert "encoder.conv_in.weight" in got["components"]["vae"]["missing"]
    if case == "shape_mismatch":
        mm = got["components"]["unet"]["mismatched"]["conv_out.bias"]
        assert mm["actual"][0] == mm["expected"][0] + 1
    for argv in ([d], [d, "--json"]):
        rc = jax_validate(argv)
        ref_out = capsys.readouterr().out
        assert torch_validate(argv) == rc == (0 if got["ok"] else 1)
        assert capsys.readouterr().out == ref_out


def test_cli_json_line(ckpts, capsys):
    assert torch_validate([ckpts["depth"], ckpts["iid_lighting"], "--json"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    reps = [json.loads(line) for line in lines]
    assert [r["checkpoint"] for r in reps] == [ckpts["depth"],
                                               ckpts["iid_lighting"]]
    assert all(r["ok"] for r in reps)


def test_header_reader_matches_read_safetensors_without_the_data(ckpts, tmp_path):
    """Same shapes and dtypes as the full reader; a file cut right after its
    header still reads, so no tensor byte is touched."""
    src = os.path.join(ckpts["depth"], "unet",
                       "diffusion_pytorch_model.safetensors")
    head = W.read_safetensors_header(src)
    full = W.read_safetensors(src)
    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    assert head == {k: (tuple(v.shape), names[v.dtype]) for k, v in full.items()}
    with open(src, "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        f.seek(0)
        prefix = f.read(8 + n)
    cut = str(tmp_path / "cut.safetensors")
    with open(cut, "wb") as f:
        f.write(prefix)
    assert W.read_safetensors_header(cut) == head
    with pytest.raises(ValueError):
        W.read_safetensors(cut)
