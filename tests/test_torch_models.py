"""The port's UNet, VAE and CLIP text tower against the JAX package's on the
tiny configurations of tests/fixtures.py, with weights carried across by
`from_jax_tree` and loaded from a diffusers-layout checkpoint on disk; and
the port's safetensors reader/writer against the safetensors package.
fp32, tolerance 1e-4 * max|ref|."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from safetensors.numpy import load_file, save_file

from fixtures import TINY_VAE, make_tiny_checkpoint
from marigold_tpu.models import clip_text as jclip
from marigold_tpu.models import unet as junet
from marigold_tpu.models import vae as jvae
from marigold_tpu.models import weights as JW
from marigold_tpu_torch.models import clip_text as tclip
from marigold_tpu_torch.models import unet as tunet
from marigold_tpu_torch.models import vae as tvae
from marigold_tpu_torch.models import weights as TW

REL = 1e-4


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=REL * np.abs(ref).max(), rtol=0)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    return make_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def jax_models(tiny_ckpt):
    """The JAX package's configs and parameter trees of the tiny checkpoint,
    read by its per-tensor host loader."""
    def load(kind, cfg_cls, prefix=""):
        d = os.path.join(tiny_ckpt, kind)
        tree = JW.torch_to_tree(JW.load_safetensors_flat(d), dtype=jnp.float32,
                                strip_prefix=prefix)
        return cfg_cls.from_dict(JW.read_config(d)), tree

    return {
        "unet": load("unet", junet.UNetConfig),
        "vae": load("vae", jvae.VAEConfig),
        "text_encoder": load("text_encoder", jclip.CLIPTextConfig, "text_model."),
    }


def _port_model(kind, jax_models, tiny_ckpt, route):
    """The port's module, weights by from_jax_tree or from the files."""
    cls, cfg_cls, load = {
        "unet": (tunet.UNet2DConditionModel, tunet.UNetConfig, TW.load_unet),
        "vae": (tvae.AutoencoderKL, tvae.VAEConfig, TW.load_vae),
        "text_encoder": (tclip.CLIPTextModel, tclip.CLIPTextConfig,
                         TW.load_text_encoder),
    }[kind]
    if route == "disk":
        return load(os.path.join(tiny_ckpt, kind), device="cpu")
    jcfg, params = jax_models[kind]
    return TW.build_module(cls, cfg_cls.from_dict(jcfg.to_dict()),
                           TW.from_jax_tree(params), torch.float32, "cpu")


_unet_apply = jax.jit(junet.apply, static_argnums=1)
_vae_encode = jax.jit(jvae.encode, static_argnums=1)
_vae_decode = jax.jit(jvae.decode_scaled, static_argnums=1)

ROUTES = ["from_jax_tree", "disk"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("hw", [(8, 8), (5, 7)])  # (5, 7): odd-size crops
def test_unet_matches_jax(hw, route, jax_models, tiny_ckpt, rng):
    jcfg, params = jax_models["unet"]
    model = _port_model("unet", jax_models, tiny_ckpt, route)
    x = rng.standard_normal((2,) + hw + (8,)).astype(np.float32)
    ctx = rng.standard_normal((1, 2, 12)).astype(np.float32)
    ref = _unet_apply(params, jcfg, jnp.asarray(x), jnp.asarray(749),
                      jnp.asarray(ctx))
    with torch.no_grad():
        got = model(_nchw(x), 749, torch.from_numpy(ctx))
    _close(_nhwc(got), ref)


def test_unet_config_from_dict():
    cfg = tunet.UNetConfig.from_dict({"attention_head_dim": 8,
                                      "block_out_channels": [32, 64]})
    assert cfg.attention_head_dim == (8, 8)
    assert tunet.UNetConfig().to_dict() == junet.UNetConfig().to_dict()
    assert tvae.VAEConfig().to_dict() == jvae.VAEConfig().to_dict()
    assert tclip.CLIPTextConfig().to_dict() == jclip.CLIPTextConfig().to_dict()


@pytest.mark.parametrize("route", ROUTES)
def test_vae_matches_jax(route, jax_models, tiny_ckpt, rng):
    jcfg, params = jax_models["vae"]
    model = _port_model("vae", jax_models, tiny_ckpt, route)
    x = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    mean, logvar = _vae_encode(params, jcfg, jnp.asarray(x))
    z = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    dec = _vae_decode(params, jcfg, jnp.asarray(z))
    with torch.no_grad():
        tm, tl = model.encode(_nchw(x))
        td = model.decode_scaled(_nchw(z))
    _close(_nhwc(tm), mean)
    _close(_nhwc(tl), logvar)
    _close(_nhwc(td), dec)


@pytest.mark.parametrize("route", ROUTES)
def test_clip_empty_prompt_matches_jax(route, jax_models, tiny_ckpt):
    jcfg, params = jax_models["text_encoder"]
    model = _port_model("text_encoder", jax_models, tiny_ckpt, route)
    ref = jclip.encode_empty_prompt(params, jcfg)
    with torch.no_grad():
        got = model.encode_empty_prompt()
    assert got.shape == (1, 2, jcfg.hidden_size)
    _close(got.numpy(), ref)


def test_load_bf16_onto_device_dtype(tiny_ckpt):
    unet = TW.load_unet(os.path.join(tiny_ckpt, "unet"), dtype=torch.bfloat16,
                        device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in unet.parameters())
    assert not any(p.requires_grad for p in unet.parameters())


def test_missing_parameter_raises(tiny_ckpt):
    sd = TW.load_state_dict(os.path.join(tiny_ckpt, "vae"))
    sd.pop("quant_conv.weight")
    with pytest.raises(ValueError, match="missing"):
        TW.build_module(tvae.AutoencoderKL,
                        tvae.VAEConfig.from_dict(TINY_VAE.to_dict()), sd,
                        torch.float32, "cpu")


# ------------------------------------------------------------------ #
# safetensors and names


def test_safetensors_writer_read_by_the_package(tmp_path, rng):
    tensors = {
        "a.weight": torch.from_numpy(rng.standard_normal((3, 4, 2)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal((5,)).astype(np.float16)),
        "c": torch.arange(7, dtype=torch.int64),
        "d": torch.from_numpy(rng.standard_normal((3,)).astype(np.float16)),
    }
    path = str(tmp_path / "w.safetensors")
    TW.write_safetensors(tensors, path)
    back = load_file(path)
    assert set(back) == set(tensors)
    for k, t in tensors.items():
        np.testing.assert_array_equal(back[k], t.numpy())


def test_safetensors_reader_reads_the_package(tmp_path, rng):
    arrays = {
        "x.y": rng.standard_normal((2, 3)).astype(np.float32),
        "h": rng.standard_normal((9,)).astype(np.float16),
        "i": np.arange(4, dtype=np.int32),
        "e": np.zeros((0, 3), np.float32),
    }
    path = str(tmp_path / "w.safetensors")
    save_file(arrays, path, metadata={"format": "pt"})
    back = TW.read_safetensors(path)
    assert set(back) == set(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k].numpy(), a)


def test_safetensors_bf16_roundtrip(tmp_path):
    t = torch.randn(4, 5).to(torch.bfloat16)
    path = str(tmp_path / "b.safetensors")
    TW.write_safetensors({"t": t}, path)
    assert torch.equal(TW.read_safetensors(path)["t"], t)


def test_variant_selection_and_names(tmp_path):
    d = tmp_path / "vae"
    d.mkdir()
    TW.write_safetensors({"w": torch.zeros(1)}, str(d / "m.safetensors"))
    TW.write_safetensors({"w": torch.ones(1)}, str(d / "m.fp16.safetensors"))
    for variant in (None, "fp16", "bf16"):
        assert TW.select_safetensor_files(str(d), variant) == \
            JW.select_safetensor_files(str(d), variant)
    assert TW.load_state_dict(str(d), "fp16")["w"].item() == 1.0
    for name in ("encoder.mid_block.attentions.0.query.weight",
                 "decoder.mid_block.attentions.0.proj_attn.bias",
                 "text_model.encoder.layers.0.mlp.fc1.weight"):
        assert TW.checkpoint_name(name, "text_model.") == \
            ".".join(JW.dest_parts(name, "text_model."))


def test_text_projection_and_position_ids_are_dropped(tiny_ckpt, tmp_path):
    src = os.path.join(tiny_ckpt, "text_encoder")
    sd = TW.read_safetensors(os.path.join(src, "model.safetensors"))
    sd["text_projection.weight"] = torch.zeros(12, 12)
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    dst = tmp_path / "text_encoder"
    TW.write_config(TW.read_config(src), str(dst))
    TW.write_safetensors(sd, str(dst / "model.safetensors"))
    clip = TW.load_text_encoder(str(dst), device="cpu")
    ref = TW.load_text_encoder(src, device="cpu")
    with torch.no_grad():
        torch.testing.assert_close(clip.encode_empty_prompt(),
                                   ref.encode_empty_prompt(), atol=0, rtol=0)


def test_from_jax_tree_layouts():
    tree = {"conv": {"weight": np.zeros((3, 3, 4, 5)), "bias": np.zeros(5)},
            "lin": {"weight": np.zeros((4, 6))},
            "embeddings": {"token_embedding": {"weight": np.zeros((10, 4))}}}
    sd = TW.from_jax_tree(tree)
    assert sd["conv.weight"].shape == (5, 4, 3, 3)
    assert sd["lin.weight"].shape == (6, 4)
    assert sd["embeddings.token_embedding.weight"].shape == (10, 4)


def test_random_state_dict_scheme():
    with torch.device("meta"):
        model = tvae.AutoencoderKL(tvae.VAEConfig.from_dict(TINY_VAE.to_dict()))
    sd = TW.random_state_dict(model, torch.Generator().manual_seed(0))
    assert set(sd) == set(model.state_dict())
    w = sd["encoder.conv_in.weight"]  # fan_in 3*3*3
    assert w.abs().max() <= 1 / np.sqrt(27) and w.abs().max() > 0.5 / np.sqrt(27)
    assert (sd["encoder.conv_in.bias"] == 0).all()
    assert (sd["encoder.conv_norm_out.weight"] == 1).all()
    again = TW.random_state_dict(model, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
