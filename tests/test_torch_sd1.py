"""SD1.x-class checkpoints in the port against the JAX package (fp32, CPU).

The module builds its own tiny SD1.x-class checkpoint: the JAX package's
`init_params` with `use_linear_projection=False` and heads that are not 64
wide, the transformers' proj_in/proj_out weights as 1x1 convs ([1, 1, C, C]
in the JAX tree, [C, C, 1, 1] on disk, as diffusers stores them; the JAX
`_proj` decides by the weight's rank), and a tiny CLIP tower with
quick_gelu. One copy of its config leaves `use_linear_projection` out, as
SD1.5's published `unet/config.json` does.

Held against the JAX package: the UNet forward (atol 1e-5), the CLIP tower,
the manifest report with the key False and with it absent, the weights
through `from_jax_tree`, the port's writer and the JAX loader (bit for
bit), E=1 `__call__` and `batch_call` through `from_pretrained` on the
JAX package's noise (atol 1e-4, as tests/test_torch_pipeline.py), the
projected self-attention with its switch off and on, and the plain flash
forward and folded entry against the Pallas kernels in interpret mode at
head widths 40, 80 and 160. The kernels themselves are held to the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py --sd1)."""

import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fixtures import TINY_VAE
from test_torch_flash_checks import Stand
from marigold_tpu.core.scheduler import DiffusionSchedule
from marigold_tpu.models import clip_text as jclip
from marigold_tpu.models import layers as JL
from marigold_tpu.models import manifest as jm
from marigold_tpu.models import unet as junet
from marigold_tpu.models import vae as jvae
from marigold_tpu.models import weights as JW
from marigold_tpu.ops import attention as JA
from marigold_tpu.ops.flash_attention import _flash_dt_impl
from marigold_tpu.ops.flash_attention import flash_attention as jax_folded
from marigold_tpu.pipelines.depth import MarigoldDepthPipeline as JaxDepth
from marigold_tpu_torch import MarigoldDepthPipeline as TorchDepth
from marigold_tpu_torch.models import clip_text as tclip
from marigold_tpu_torch.models import manifest as tm
from marigold_tpu_torch.models import unet as tunet
from marigold_tpu_torch.models import weights as TW
from marigold_tpu_torch.ops import attention as TA
from marigold_tpu_torch.ops import flash_attention as fa

UNET_ATOL = 1e-5
PIPE_ATOL = 1e-4  # tests/test_torch_pipeline.py
FLASH_ATOL = 2e-5  # tests/test_torch_flash_attention.py

# SD1.5's layout cut to size: two levels, heads = diffusers'
# `attention_head_dim` 2 (an int, as SD1.5's 8), so 8- and 16-wide heads
TINY_SD1_UNET = junet.UNetConfig(
    sample_size=8, in_channels=8, out_channels=4, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=2,
    attention_head_dim=(2, 2), cross_attention_dim=12, norm_num_groups=4,
    use_linear_projection=False)
TINY_QUICK_CLIP = jclip.CLIPTextConfig(
    vocab_size=49408, hidden_size=12, intermediate_size=24,
    num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=77,
    hidden_act="quick_gelu")


def setup_module(module):
    # one thread per module, as every test module that runs a model
    module._threads = torch.get_num_threads()
    torch.set_num_threads(1)


def teardown_module(module):
    torch.set_num_threads(module._threads)


def conv_form(tree):
    """proj_in/proj_out as 1x1 convs ([1, 1, C, C] HWIO), as
    tests/test_models.py::test_transformer_conv_projection_matches_linear."""
    if isinstance(tree, dict):
        return {k: (dict(v, weight=v["weight"][None, None])
                    if k in ("proj_in", "proj_out") else conv_form(v))
                for k, v in tree.items()}
    return tree


def _write_unet_config(subdir, keep_key: bool):
    d = TINY_SD1_UNET.to_dict()
    d["attention_head_dim"] = 2  # the int form of SD1.5's config
    if not keep_key:
        del d["use_linear_projection"]
    with open(os.path.join(subdir, "config.json"), "w") as f:
        json.dump(d, f, indent=2)


@pytest.fixture(scope="module")
def sd1(tmp_path_factory):
    """{"params", "clip", "vae", "dirs": {"False": ckpt, "absent": ckpt}}."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(18), 3)
    params = conv_form(junet.init_params(k1, TINY_SD1_UNET))
    vae_params = jvae.init_params(k2, TINY_VAE)
    clip_params = jclip.init_params(k3, TINY_QUICK_CLIP)
    root = str(tmp_path_factory.mktemp("sd1"))
    first = os.path.join(root, "key_false")
    JW.save_unet(TINY_SD1_UNET, params, os.path.join(first, "unet"))
    _write_unet_config(os.path.join(first, "unet"), keep_key=True)
    JW.save_vae(TINY_VAE, vae_params, os.path.join(first, "vae"))
    JW.save_text_encoder(TINY_QUICK_CLIP, clip_params,
                         os.path.join(first, "text_encoder"))
    DiffusionSchedule.create().save_pretrained(os.path.join(first, "scheduler"))
    with open(os.path.join(first, "model_index.json"), "w") as f:
        json.dump({"_class_name": "MarigoldDepthPipeline",
                   "default_denoising_steps": 1,
                   "default_processing_resolution": 32,
                   "scale_invariant": True, "shift_invariant": True}, f)
    absent = os.path.join(root, "key_absent")
    shutil.copytree(first, absent)
    _write_unet_config(os.path.join(absent, "unet"), keep_key=False)
    return {"params": params, "clip": clip_params, "vae": vae_params,
            "dirs": {"False": first, "absent": absent}}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("key", ["False", "absent"])
def test_unet_forward_matches_jax(sd1, key, rng):
    """The checkpoint on disk through the port's loader (1x1-conv proj
    weights, the config's key False or absent) against the JAX apply."""
    ckpt = os.path.join(sd1["dirs"][key], "unet")
    model = TW.load_unet(ckpt, device="cpu")
    proj = model.down_blocks[0].attentions[0].proj_in.weight
    assert proj.shape == (16, 16, 1, 1)
    assert model.cfg.attention_head_dim == (2, 2)
    jcfg = junet.UNetConfig.from_dict(JW.read_config(ckpt))
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 2, 12)).astype(np.float32)
    ref = junet.apply(sd1["params"], jcfg, jnp.asarray(x), jnp.asarray(749),
                      jnp.asarray(ctx))
    with torch.no_grad():
        got = model(_nchw(x), 749, torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=UNET_ATOL, rtol=0)


def test_unet_from_jax_tree_matches_linear_form(sd1, rng):
    """The same UNet built from the JAX tree with the proj weights as 1x1
    convs and as linears: one function of the input."""
    cfg = tunet.UNetConfig.from_dict(TINY_SD1_UNET.to_dict())
    conv = TW.build_module(tunet.UNet2DConditionModel, cfg,
                           TW.from_jax_tree(sd1["params"]), torch.float32, "cpu")
    linear_tree = jax.tree_util.tree_map(lambda a: a, sd1["params"])
    for blk in ("down_blocks", "up_blocks"):
        for b in linear_tree[blk].values():
            for a in b.get("attentions", {}).values():
                for p in ("proj_in", "proj_out"):
                    a[p] = dict(a[p], weight=a[p]["weight"][0, 0])
    linear = TW.build_module(tunet.UNet2DConditionModel, cfg,
                             TW.from_jax_tree(linear_tree), torch.float32, "cpu")
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 8)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 2, 12)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(conv(x, 10, ctx).numpy(),
                                   linear(x, 10, ctx).numpy(), atol=1e-6, rtol=0)
    assert linear.state_dict()[
        "down_blocks.0.attentions.0.proj_out.weight"].shape == (16, 16)


def test_projection_rejects_a_wrong_shape():
    p = tunet.Projection(4, 4)
    with pytest.raises(RuntimeError, match="size mismatch"):
        p.load_state_dict({"weight": torch.zeros(4, 4, 3, 3),
                           "bias": torch.zeros(4)})


def test_clip_quick_gelu_matches_jax(sd1):
    ckpt = os.path.join(sd1["dirs"]["absent"], "text_encoder")
    model = TW.load_text_encoder(ckpt, device="cpu")
    assert model.cfg.hidden_act == "quick_gelu"
    ref = jclip.apply(sd1["clip"], TINY_QUICK_CLIP,
                      jnp.asarray([[49406, 320, 1125, 49407]]))
    with torch.no_grad():
        got = model(torch.tensor([[49406, 320, 1125, 49407]]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=UNET_ATOL,
                               rtol=0)
    x = torch.linspace(-6, 6, 97)
    np.testing.assert_allclose(
        tclip._act(x, "quick_gelu").numpy(),
        np.asarray(jclip._act(jnp.asarray(x.numpy()), "quick_gelu")),
        atol=1e-6, rtol=0)


def test_unknown_activation_raises_when_the_tower_runs():
    """Built (the manifest builds it), but run it raises, as the JAX
    package's `_act` does."""
    cfg = tclip.CLIPTextConfig(hidden_size=8, intermediate_size=16,
                               num_hidden_layers=1, num_attention_heads=2,
                               hidden_act="relu")
    model = tclip.CLIPTextModel(cfg)
    with pytest.raises(ValueError, match="unknown act"):
        model(torch.tensor([[49406, 49407]]))
    with pytest.raises(ValueError, match="unknown act"):
        jclip._act(jnp.zeros(3), "relu")


@pytest.mark.parametrize("key", ["False", "absent"])
def test_manifest_report_matches_jax(sd1, key):
    """Both packages' reports on the same directory, config key False and
    absent: their expected proj weights are [C, C] (each package's module
    or init), the files' [C, C, 1, 1]."""
    ckpt = sd1["dirs"][key]
    for kind in ("unet", "vae", "text_encoder"):
        ref = jm.expected_component_manifest(kind,
                                             jm._component_config(ckpt, kind))
        got = tm.expected_component_manifest(kind,
                                             tm._component_config(ckpt, kind))
        assert got == ref, kind
    assert tm.validate_checkpoint(ckpt) == jm.validate_checkpoint(ckpt)


@pytest.mark.parametrize("fastload", ["1", "0"])
def test_weights_round_trip_bit_for_bit(sd1, tmp_path, monkeypatch, fastload):
    """from_jax_tree -> the port's writer -> the JAX loader gives the JAX
    tree bit for bit; the port's two load paths give from_jax_tree's
    tensors bit for bit, the proj weights at rank 4."""
    monkeypatch.setenv("MARIGOLD_TPU_FASTLOAD", fastload)
    flat = TW.from_jax_tree(sd1["params"])
    assert flat["down_blocks.0.attentions.0.proj_in.weight"].shape == (16, 16, 1, 1)
    cfg = tunet.UNetConfig.from_dict(TINY_SD1_UNET.to_dict())
    sub = str(tmp_path / "unet")
    TW.save_component(cfg.to_dict(), flat, sub,
                      "diffusion_pytorch_model.safetensors")
    back = JW.torch_to_tree(JW.load_safetensors_flat(sub))
    ref = jax.tree_util.tree_leaves_with_path(sd1["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    model = TW.load_unet(sub, device="cpu")
    sd = model.state_dict()
    assert sd.keys() == flat.keys()
    for name, t in flat.items():
        assert torch.equal(sd[name], t), name
    # the loaded module saves back as it was
    again = str(tmp_path / "again")
    TW.save_component(cfg.to_dict(), sd, again,
                      "diffusion_pytorch_model.safetensors")
    assert TW.read_safetensors_header(
        os.path.join(again, "diffusion_pytorch_model.safetensors")) == \
        TW.read_safetensors_header(
            os.path.join(sub, "diffusion_pytorch_model.safetensors"))


def _jax_noise(seed, shape):
    """The JAX programs' initial noise, NHWC -> the port's NCHW."""
    n = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    return torch.from_numpy(np.ascontiguousarray(
        n.reshape((-1,) + shape[-3:]).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def pipes(sd1):
    ckpt = sd1["dirs"]["absent"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MARIGOLD_TPU_FASTLOAD", "0")
        jpipe = JaxDepth.from_pretrained(ckpt, dtype=jnp.float32)
    tpipe = TorchDepth.from_pretrained(ckpt, dtype=torch.float32, device="cpu")
    return jpipe, tpipe


def _image(seed, h=40, w=56):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_call_matches_jax_on_shared_noise(pipes, monkeypatch):
    """E=1 __call__ on the SD1.x-class checkpoint whose config leaves the
    key out, through from_pretrained(device="cpu")."""
    jpipe, tpipe = pipes
    img = _image(0)
    ref = jpipe(img, denoising_steps=2, processing_res=32, seed=7,
                color_map=None).depth_np
    monkeypatch.setattr(tpipe, "_noise",
                        lambda n, h, w, seed: _jax_noise(7, (n, h, w, 4)))
    got = tpipe(img, denoising_steps=2, processing_res=32, seed=7,
                color_map=None).depth_np
    assert got.shape == (40, 56)
    np.testing.assert_allclose(got, ref, atol=PIPE_ATOL, rtol=0)


def test_batch_call_matches_jax_on_shared_noise(pipes, monkeypatch):
    jpipe, tpipe = pipes
    imgs = [_image(1), _image(2)]
    ref = jpipe.batch_call(imgs, denoising_steps=2, processing_res=32, seed=5)
    monkeypatch.setattr(
        tpipe, "_noise", lambda n, h, w, seed: _jax_noise(5, (n, 1, h, w, 4)))
    got = tpipe.batch_call(imgs, denoising_steps=2, processing_res=32, seed=5)
    for r, g in zip(ref, got):
        assert g.depth_np.shape == (40, 56)
        np.testing.assert_allclose(g.depth_np, r.depth_np, atol=PIPE_ATOL,
                                   rtol=0)


def _attention_params(rng, c, bias):
    """JAX linear params and the port's Attention module holding them."""
    keys = jax.random.split(jax.random.PRNGKey(int(rng.integers(1 << 30))), 4)
    params = {n: JL.init_linear(k, c, c, jnp.float32, bias=bias)
              for n, k in zip(("to_q", "to_k", "to_v"), keys)}
    params["to_out"] = {"0": JL.init_linear(keys[3], c, c, jnp.float32)}
    attn = tunet.Attention(c, 1, bias=bias)
    attn.load_state_dict(TW.from_jax_tree(params))
    return params, attn


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("switch", [False, True])
def test_self_attention_projected_matches_jax(rng, monkeypatch, switch, bias):
    """Both packages' projected self-attention with the switch off and on
    (as tests/test_flash_attention.py runs the JAX one: the flash path
    forced, its kernel in interpret mode); the port's projected path runs
    its packed plain version on the CPU views of one [B, N, 3C] product.
    A bias on to_q/to_k/to_v takes the linear path in both."""
    b, n, c, heads = 2, 192, 80, 2  # 40-wide heads
    params, attn = _attention_params(rng, c, bias)
    y = rng.standard_normal((b, n, c)).astype(np.float32)
    monkeypatch.setattr(JA, "_PROJECTED_ATTN", switch)
    monkeypatch.setattr(TA, "_PROJECTED_ATTN", switch)
    if switch:
        monkeypatch.setattr(JA, "_FLASH_MIN_SEQ", 1)
        monkeypatch.setattr(JA, "_on_tpu", lambda: True)
        monkeypatch.setattr(
            "marigold_tpu.ops.flash_attention.flash_attention_dt",
            functools.partial(_flash_dt_impl, block_q=128, block_k=128,
                              interpret=True, softmax="shifted"))
        monkeypatch.setattr(TA, "use_flash", lambda q, nk: True)
    packed = []
    monkeypatch.setattr(fa, "flash_attention_packed", functools.partial(
        lambda f, *a: packed.append(a[0].shape) or f(*a),
        fa.flash_attention_packed))
    ref = JA.self_attention_projected(jnp.asarray(y), params, num_heads=heads)
    with torch.no_grad():
        got = TA.self_attention_projected(torch.from_numpy(y), attn, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FLASH_ATOL,
                               rtol=0)
    assert packed == ([(b, n, 3 * c)] if switch and not bias else [])


def test_stacked_weight_is_cached_and_dropped():
    attn = tunet.Attention(16, 2)
    w = attn.qkv_weight()
    assert w.shape == (48, 16) and attn.qkv_weight() is w
    with torch.no_grad():
        attn._modules["to_k"].weight.mul_(2.0)  # bumps _version
    w2 = attn.qkv_weight()
    assert w2 is not w and torch.equal(w2[16:32], attn._modules["to_k"].weight)
    attn.to_v.weight.data.zero_()  # a .data write, reached through to_v
    assert not attn.qkv_weight()[32:].any()
    attn.load_state_dict({k: torch.ones_like(v)
                          for k, v in attn.state_dict().items()})
    assert bool((attn.qkv_weight() == 1).all())


def test_packed_plain_is_the_plain_version_on_its_views(rng):
    c, heads = 160, 1
    qkv = torch.from_numpy(rng.standard_normal((2, 130, 3 * c)).astype(np.float32))
    for mode in fa.SOFTMAX_MODES:
        ref = fa.flash_attention_plain(*(qkv[..., i * c:(i + 1) * c].contiguous()
                                         for i in range(3)), heads, mode)
        torch.testing.assert_close(fa.flash_attention_packed(qkv, heads, mode),
                                   ref, atol=0, rtol=0)
    with pytest.raises(ValueError, match="three equal parts"):
        fa.flash_attention_packed(qkv[..., :-1], heads)


def _jax_dt(q, k, v, heads, softmax):
    """[B, N, C] numpy -> the TPU kernel's [BH, D, N] layout and back."""
    b, nq, c = q.shape
    d = c // heads

    def fold(x):
        return jnp.asarray(x.reshape(b, -1, heads, d).transpose(0, 2, 3, 1)
                           .reshape(b * heads, d, -1))

    out = _flash_dt_impl(fold(q), fold(k), fold(v), block_q=128, block_k=128,
                         interpret=True, softmax=softmax)
    return (np.asarray(out).reshape(b, heads, d, nq).transpose(0, 3, 1, 2)
            .reshape(b, nq, c))


@pytest.mark.parametrize("softmax", ["shifted", "online"])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_plain_forward_matches_pallas_at_sd1_widths(d, softmax, rng):
    """The port's plain forward (what the CUDA kernel is held to) against
    `_flash_dt_impl` in interpret mode at the SD1.x head widths, ragged
    nq != nk, B = 2, two heads."""
    q = rng.standard_normal((2, 150, 2 * d)).astype(np.float32)
    k, v = (rng.standard_normal((2, 210, 2 * d)).astype(np.float32)
            for _ in range(2))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), 2, softmax).numpy()
    np.testing.assert_allclose(got, _jax_dt(q, k, v, 2, softmax),
                               atol=FLASH_ATOL, rtol=0)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_folded_plain_matches_pallas_at_sd1_widths(d, rng):
    """flash_attention_folded against the TPU package's folded
    flash_attention (D zero-padded to 128 there) in interpret mode."""
    q = rng.standard_normal((3, 150, d)).astype(np.float32)
    k, v = (rng.standard_normal((3, 210, d)).astype(np.float32)
            for _ in range(2))
    ref = jax_folded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=128, block_k=128, interpret=True)
    got = fa.flash_attention_folded(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FLASH_ATOL,
                               rtol=0)


def test_check_tma_holds_the_head_stride():
    """The head maps' stride of D elements must be a multiple of 16 bytes
    (`check_kernel_args`, on stand-ins that say they live on a card): D =
    40 in bf16 (80 bytes) and fp32 pass, D = 36 in bf16 does not, even
    where a kernel would take that width."""
    def qkv(c, dtype):
        return {name: Stand((1, 4, c), dtype) for name in ("q", "k", "v")}

    for dtype in (torch.bfloat16, torch.float32):
        assert fa.check_kernel_args(qkv(320, dtype), 8, fa.HEAD_DIMS) == 40
    with pytest.raises(ValueError, match="head stride of 72 bytes"):
        fa.check_kernel_args(qkv(288, torch.bfloat16), 8, (36,))


def test_widths_and_the_autograd_raise_are_declared():
    """The SD1.x widths are declared training widths and routed: autograd
    no longer raises at 40, 80 and 160 (their training kernels exist), and
    on the CPU FlashAttentionFunction takes the lse route whatever the
    serving mode, its output flash_attention_lse_plain's, as the JAX custom
    VJP runs its exact online lse forward at those widths."""
    assert {40, 80, 160} <= set(fa.TRAIN_HEAD_DIMS) <= set(fa.HEAD_DIMS)
    assert not hasattr(fa, "SERVING_ONLY_HEAD_DIMS")
    for d in (40, 80, 160):
        q, k, v = (torch.randn(1, 20, 2 * d, requires_grad=True)
                   for _ in range(3))
        out = fa.FlashAttentionFunction.apply(q, k, v, 2, "shifted")
        assert out.grad_fn._forward_cls is fa.FlashAttentionFunction
        assert out.grad_fn.kernel_bwd
        ref, _ = fa.flash_attention_lse_plain(q.detach(), k.detach(),
                                              v.detach(), 2)
        assert torch.equal(out.detach(), ref)
        out.sum().backward()
        assert q.grad is not None and bool(torch.isfinite(q.grad).all())


def test_sd1_config_from_dict_matches_jax():
    """SD1.5's published unet/config.json keys (attention_head_dim an int,
    no use_linear_projection) read the same in both packages."""
    d = {"block_out_channels": [320, 640, 1280, 1280], "attention_head_dim": 8,
         "cross_attention_dim": 768, "layers_per_block": 2,
         "norm_num_groups": 32, "in_channels": 8}
    j, t = junet.UNetConfig.from_dict(d), tunet.UNetConfig.from_dict(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [c // h for c, h in zip(t.block_out_channels,
                                   t.attention_head_dim)] == [40, 80, 160, 160]
