"""SD1.x-class fine-tuning in the port against the JAX package (fp32, CPU).

The training attention at the SD1.x head widths (40, 80 and 160: 8 heads
at 320, 640 and 1280 channels): the plain lse forward and plain backward,
which the CUDA kernels (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu and
the fp32 csrc/flash_fwd_d64_f32_sm90.cu, csrc/flash_bwd_dq_f32_sm90.cu,
csrc/flash_bwd_dkv_f32_sm90.cu) are held to on the card, against the TPU
kernels in Pallas interpret mode (`_flash_dt_impl_lse`,
`_flash_dt_bwd_pallas`), at lengths that cross the kernels' 64-row stages
and 128-row blocks, nq != nk; FlashAttentionFunction's gradients against
jax.grad through `flash_attention_dt`; then a tiny SD1.x-class UNet whose
heads really are 40 and 80 wide (one head per level, 1x1-conv
proj_in/proj_out) differentiated through the flash dispatch with every
parameter's gradient against the JAX UNet's; one depth micro-step of the
port's train step on a tiny SD1.x-class base (4 input channels widened to
8, a quick_gelu CLIP) against the JAX objective on the same draws; and the
trained UNet saved by the port and read by the JAX loader with its [C, C,
1, 1] projections. Tolerances are stated per test."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import TINY_VAE
from marigold_tpu.core.scheduler import DiffusionSchedule as JSchedule
from marigold_tpu.models import clip_text as jclip
from marigold_tpu.models import surgery as jsurgery
from marigold_tpu.models import unet as junet
from marigold_tpu.models import vae as jvae
from marigold_tpu.models import weights as JW
from marigold_tpu.ops import flash_attention as JF
from marigold_tpu.train import train_step as jts
from marigold_tpu.train.multi_res_noise import multi_res_noise_like
from marigold_tpu_torch.core.scheduler import DiffusionSchedule as TSchedule
from marigold_tpu_torch.models import surgery as tsurgery
from marigold_tpu_torch.models import weights as TW
from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from marigold_tpu_torch.ops import attention as TA
from marigold_tpu_torch.ops import flash_attention as fa
from marigold_tpu_torch.train import train_step as tts
from marigold_tpu_torch.train.checkpoints import save_train_state
from marigold_tpu_torch.train.lr_schedule import iter_exponential as t_iter_exp

# tests/test_torch_flash_backward.py: the tolerance of
# tests/test_flash_attention.py's backward tests
ATOL, RTOL = 2e-4, 1e-3
HEADS = 8
SD1_WIDTHS = (40, 80, 160)
# (B, nq, nk): a row past a 128-row block against a key past a 64-key
# tile, and nq > 128 against nk > 256 (the d = 80 and 160 kernels' 64-row
# blocks, the fp32 d = 160 dQ's 2-slot ring over 9 substages per tile)
LENGTHS = [(1, 129, 65), (2, 200, 257)]
MRN = {"strength": 0.9, "annealed": True, "downscale_strategy": "original"}

# SD1.5's layout cut to size with its head widths kept: one head per level
# at 40 and 80 channels, 1x1-conv projections, a 4-channel base
TINY_SD1_BASE = junet.UNetConfig(
    sample_size=8, in_channels=4, out_channels=4, block_out_channels=(40, 80),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
    attention_head_dim=(1, 1), cross_attention_dim=12, norm_num_groups=8,
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


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _fold(x, heads=HEADS):
    """[B, N, C] numpy -> the TPU kernels' [BH, D, N]."""
    b, n, c = x.shape
    return jnp.asarray(x.reshape(b, n, heads, c // heads).transpose(0, 2, 3, 1)
                       .reshape(b * heads, c // heads, n))


def _unfold(x, b, heads=HEADS):
    """[BH, D, N] -> [B, N, C] numpy."""
    x = np.asarray(x)
    _, d, n = x.shape
    return x.reshape(b, heads, d, n).transpose(0, 3, 1, 2).reshape(b, n, heads * d)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("b,nq,nk", LENGTHS)
@pytest.mark.parametrize("d", SD1_WIDTHS)
def test_lse_plain_matches_tpu_kernel_at_sd1_widths(rng, d, b, nq, nk):
    """flash_attention_lse on CPU tensors (its plain version) against
    `_flash_dt_impl_lse` in interpret mode: out and the row logsumexp."""
    c = HEADS * d
    q, k, v = _rand(rng, b, nq, c), _rand(rng, b, nk, c), _rand(rng, b, nk, c)
    out_j, lse_j = JF._flash_dt_impl_lse(_fold(q), _fold(k), _fold(v), 128,
                                         128, True)
    out, lse = fa.flash_attention_lse(_t(q), _t(k), _t(v), HEADS)
    assert lse.shape == (b * HEADS, nq)
    np.testing.assert_allclose(out.numpy(), _unfold(out_j, b), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("b,nq,nk", LENGTHS)
@pytest.mark.parametrize("d", SD1_WIDTHS)
def test_bwd_plain_matches_tpu_kernels_at_sd1_widths(rng, d, b, nq, nk):
    """flash_attention_bwd on CPU tensors (the plain backward) against the
    dQ and dK/dV Pallas kernels of `_flash_dt_bwd_pallas` in interpret
    mode, on the JAX forward's out and lse."""
    c = HEADS * d
    q, g = _rand(rng, b, nq, c), _rand(rng, b, nq, c)
    k, v = _rand(rng, b, nk, c), _rand(rng, b, nk, c)
    qt, kt, vt, gt = (_fold(x) for x in (q, k, v, g))
    out_j, lse_j = JF._flash_dt_impl_lse(qt, kt, vt, 128, 128, True)
    ref = JF._flash_dt_bwd_pallas(qt, kt, vt, out_j, lse_j, gt, block_q=128,
                                  block_k=128, interpret=True)
    out = _t(_unfold(out_j, b))
    lse = _t(np.asarray(lse_j))
    got = fa.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(g), HEADS)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), _unfold(r, b), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("d", SD1_WIDTHS)
def test_function_grads_match_jax_custom_vjp_at_sd1_widths(rng, d):
    """FlashAttentionFunction (the lse route: its forward the exact online
    one whatever the serving mode) against jax.grad through
    `flash_attention_dt` in interpret mode, whose custom VJP runs the lse
    forward and the Pallas backward at these widths."""
    b, nq, nk = 1, 150, 210
    c = HEADS * d
    q, w = _rand(rng, b, nq, c), _rand(rng, b, nq, c)
    k, v = _rand(rng, b, nk, c), _rand(rng, b, nk, c)

    def loss_jax(qt, kt, vt):
        out = JF.flash_attention_dt(qt, kt, vt, 128, 128, True)
        return jnp.sum(out * _fold(w))

    ref = jax.grad(loss_jax, argnums=(0, 1, 2))(_fold(q), _fold(k), _fold(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttentionFunction.apply(*leaves, HEADS, "shifted")
    assert out.grad_fn.kernel_bwd
    (out * _t(w)).sum().backward()
    for name, leaf, r in zip("qkv", leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), _unfold(r, b),
                                   atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


def _conv_form(tree):
    """proj_in/proj_out as 1x1 convs ([1, 1, C, C] HWIO), as SD1.x-class
    checkpoints store them (tests/test_torch_sd1.py)."""
    if isinstance(tree, dict):
        return {k: (dict(v, weight=v["weight"][None, None])
                    if k in ("proj_in", "proj_out") else _conv_form(v))
                for k, v in tree.items()}
    return tree


def _spy_routes(monkeypatch):
    """Every attention through FlashAttentionFunction (the CPU dispatch
    forced onto the flash path); returns the list that collects each
    call's head width and route."""
    routes = []
    fwd = fa.FlashAttentionFunction.forward

    def spy(ctx_, q, k, v, num_heads, *a):
        out = fwd(ctx_, q, k, v, num_heads, *a)
        routes.append((q.shape[-1] // num_heads, ctx_.kernel_bwd))
        return out

    monkeypatch.setattr(TA, "use_flash", lambda q, nk: True)
    monkeypatch.setattr(fa.FlashAttentionFunction, "forward", staticmethod(spy))
    return routes


def test_tiny_sd1_unet_grads_through_flash_dispatch_match_jax(rng, monkeypatch):
    """A tiny SD1.x-class UNet with heads 40 and 80 wide differentiated
    with the port's flash dispatch forced on and TRAIN_HEAD_DIMS as it is:
    every attention takes the lse route (the kernels' plain versions on
    the CPU), every parameter's gradient, the [C, C, 1, 1] projections'
    among them, against jax.grad of the JAX UNet (atol 5e-5, rtol 1e-3, as
    tests/test_torch_flash_backward.py's SD2-layout UNet)."""
    cfg = dataclasses.replace(TINY_SD1_BASE, in_channels=8)
    params = _conv_form(junet.init_params(jax.random.PRNGKey(19), cfg))
    x = _rand(rng, 1, 16, 16, 8)
    ctx = _rand(rng, 1, 3, 12)
    ref = jax.jit(jax.grad(lambda p: jnp.mean(
        junet.apply(p, cfg, jnp.asarray(x), jnp.asarray(10), jnp.asarray(ctx))
        ** 2)))(params)
    ref = TW.from_jax_tree(ref)

    unet = TW.build_module(UNet2DConditionModel, UNetConfig.from_dict(
        cfg.to_dict()), TW.from_jax_tree(params), torch.float32,
        "cpu").requires_grad_(True)
    routes = _spy_routes(monkeypatch)
    out = unet(_t(x.transpose(0, 3, 1, 2)), 10, _t(ctx))
    (out ** 2).mean().backward()
    # 4 transformer blocks (down, mid, 2 up): a self- and a cross-attention
    # each, at 40 (level 0) and 80 (level 1) lanes, all on the lse route
    assert len(routes) == 8 and {w for w, _ in routes} == {40, 80}
    assert all(kernel for _, kernel in routes)
    proj = unet.down_blocks[0].attentions[0].proj_in.weight
    assert proj.shape == (40, 40, 1, 1) and proj.grad.shape == proj.shape
    for n, p in unet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(), atol=5e-5,
                                   rtol=1e-3, err_msg=n)


@pytest.fixture(scope="module")
def sd1_base(tmp_path_factory):
    """A tiny SD1.x-class base checkpoint written by the JAX package (the
    4-channel UNet with 1x1-conv projections, the tiny VAE, a quick_gelu
    CLIP), then both packages' models after the depth trainer's conv_in
    surgery to 8 channels (fp32, CPU) and each package's empty-prompt
    embedding from its own CLIP."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(20), 3)
    params = _conv_form(junet.init_params(k1, TINY_SD1_BASE))
    vae_params = jvae.init_params(k2, TINY_VAE)
    clip_params = jclip.init_params(k3, TINY_QUICK_CLIP)
    root = str(tmp_path_factory.mktemp("sd1_base"))
    JW.save_unet(TINY_SD1_BASE, params, os.path.join(root, "unet"))
    JW.save_vae(TINY_VAE, vae_params, os.path.join(root, "vae"))
    JW.save_text_encoder(TINY_QUICK_CLIP, clip_params,
                         os.path.join(root, "text_encoder"))
    JSchedule.create().save_pretrained(os.path.join(root, "scheduler"))
    jcfg, jparams = jsurgery.replace_conv_in(TINY_SD1_BASE, params, 8)
    unet4 = TW.load_unet(os.path.join(root, "unet"), device="cpu")
    tcfg, tsd = tsurgery.replace_conv_in(unet4.cfg, unet4.state_dict(), 8)
    # the empty prompt's ids, padded with the end token to 77
    ids = np.array([[49406] + [49407] * 76])
    clip = TW.load_text_encoder(os.path.join(root, "text_encoder"), device="cpu")
    with torch.no_grad():
        text = clip(torch.from_numpy(ids)).numpy()
    return dict(
        root=root, jcfg=jcfg, jparams=jparams, jvae_cfg=TINY_VAE,
        jvae=vae_params, jsched=JSchedule.create(), tcfg=tcfg, tsd=tsd,
        unet=TW.build_module(UNet2DConditionModel, tcfg, tsd, torch.float32,
                             "cpu"),
        tvae=TW.load_vae(os.path.join(root, "vae"), device="cpu"),
        tsched=TSchedule.create(), text=text,
        jtext=np.asarray(jclip.apply(clip_params, TINY_QUICK_CLIP,
                                     jnp.asarray(ids))))


def _batch(seed, bsz=2, hw=(32, 32)):
    """An NHWC depth batch in the JAX step's layout, some pixels invalid."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(-1, 1, (bsz, *hw, 1)).astype(np.float32)
    return {"rgb_norm": rng.uniform(-1, 1, (bsz, *hw, 3)).astype(np.float32),
            "gt_norm": np.repeat(depth, 3, axis=-1),
            "valid_mask": rng.uniform(size=(bsz, *hw, 1)) > 0.05}


def _jax_draws(m, batch, key):
    """(timesteps, noise NCHW) as the JAX `_make_loss_and_grad` draws them
    from `key` (annealed multi-resolution noise)."""
    k_t, k_noise = jax.random.split(key)
    T = m["jsched"].num_train_timesteps
    t = jax.random.randint(k_t, (batch["rgb_norm"].shape[0],), 0, T)
    lat = jvae.encode_mean_scaled(m["jvae"], m["jvae_cfg"],
                                  jnp.asarray(batch["gt_norm"])).astype(jnp.float32)
    noise = multi_res_noise_like(k_noise, lat, MRN["strength"] * (t / T),
                                 MRN["downscale_strategy"])
    return torch.from_numpy(np.array(t)), _nchw(noise)


def _masters(m):
    return {n: t.clone().float().requires_grad_() for n, t in m["tsd"].items()}


def test_depth_micro_step_on_a_sd1_base_matches_jax(sd1_base, monkeypatch):
    """One depth micro-step of the port's objective (masked loss, annealed
    multi-resolution noise, fp32) with every attention on the flash route,
    the 40- and 80-wide heads on the lse forward and backward, against the
    JAX objective and backward (`_make_loss_and_grad`) on the JAX draws:
    the quick_gelu CLIP's embedding (atol 1e-5), the loss within rtol 1e-5
    and each gradient leaf within 1e-4 of its own largest entry plus rtol
    1e-3 (tests/test_torch_train_step.py's tolerances)."""
    m = sd1_base
    np.testing.assert_allclose(m["text"], m["jtext"], atol=1e-5, rtol=0)
    batch, key = _batch(30), jax.random.PRNGKey(31)
    jlg = jts._make_loss_and_grad(m["jcfg"], m["jvae_cfg"], m["jsched"],
                                  "mse_loss", MRN, True, None, "none", None)
    jloss, jgrads = jax.jit(jlg)(m["jparams"], m["jvae"],
                                 jnp.asarray(m["jtext"]),
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 key)
    t, noise = _jax_draws(m, batch, key)
    routes = _spy_routes(monkeypatch)
    loss_and_grad = tts.make_loss_and_grad(
        m["unet"], m["tvae"], m["tsched"], "mse_loss", MRN, True,
        torch.float32, "none")
    loss, grads = loss_and_grad(
        _masters(m), torch.from_numpy(m["text"]),
        {k: _nchw(v) for k, v in batch.items()}, timesteps=t, noise=noise)
    assert {w for w, kernel in routes if kernel} == {40, 80}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = TW.from_jax_tree(jgrads)
    assert ref.keys() == grads.keys()
    assert grads["down_blocks.0.attentions.0.proj_in.weight"].shape == \
        (40, 40, 1, 1)
    for n, g in grads.items():
        r = ref[n].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max() + 1e-9, err_msg=n)


def test_trained_sd1_unet_saves_for_the_jax_loader(sd1_base, tmp_path):
    """Two micro-steps and one Adam update of the port's train step on the
    SD1.x-class base: the masters and Adam's moments keep the loaded
    [C, C, 1, 1] projections; the trainer's checkpoint writer saves the
    UNet at that rank, and the JAX loader reads every tensor back bit for
    bit, the projections as [1, 1, C, C] 1x1 convs."""
    m = sd1_base
    opt = tts.make_optimizer(1e-3, t_iter_exp(100, 0.01, 0), 2, name="adam")
    micro, apply = tts.make_train_step(
        m["unet"], m["tvae"], m["tsched"], opt, loss_name="mse_loss",
        multi_res_noise_cfg=MRN, use_mask=True, compute_dtype=torch.float32)
    state = opt.init(_masters(m))
    for i in range(2):
        batch, key = _batch(40 + i), jax.random.PRNGKey(41 + i)
        t, noise = _jax_draws(m, batch, key)
        micro(state, torch.from_numpy(m["text"]),
              {k: _nchw(v) for k, v in batch.items()}, timesteps=t,
              noise=noise)
    apply(state)
    name = "up_blocks.1.attentions.0.proj_out.weight"
    assert state.params[name].shape == (40, 40, 1, 1)
    assert state.mu[name].shape == state.nu[name].shape == (40, 40, 1, 1)
    assert not torch.equal(state.params[name], m["tsd"][name])
    ckpt = str(tmp_path / "latest")
    save_train_state(ckpt, m["tcfg"], state.params, m["tsched"],
                     {"effective_iter": 1}, None)
    jcfg, jparams = JW.load_unet(os.path.join(ckpt, "unet"))
    assert jcfg.in_channels == 8
    assert jparams["up_blocks"]["1"]["attentions"]["0"]["proj_out"][
        "weight"].shape == (1, 1, 40, 40)
    loaded = TW.from_jax_tree(jparams)
    assert loaded.keys() == state.params.keys()
    for n, p in state.params.items():
        assert torch.equal(loaded[n], p.detach()), n
