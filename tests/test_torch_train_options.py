"""The training options the port took over in one slice (Adafactor, the
bf16 accumulator `accum_dtype`, `grad_dtype`, the `save_heavy` remat policy)
and the normals and IID micro-steps, against the JAX package's train_step
on the CPU in fp32.

The frameworks draw different random numbers from one seed, so the port is
handed the JAX package's own draws, as in test_torch_train_step.py.
Tolerances are stated per test."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from optax._src.factorized import _factored_dims

from marigold_tpu.core.scheduler import DiffusionSchedule as JSchedule
from marigold_tpu.models import surgery as jsurgery
from marigold_tpu.models import vae as jvae
from marigold_tpu.models import weights as JW
from marigold_tpu.train import train_step as jts
from marigold_tpu.train.lr_schedule import iter_exponential as j_iter_exp
from marigold_tpu.train.multi_res_noise import multi_res_noise_like
from marigold_tpu_torch.core.scheduler import DiffusionSchedule as TSchedule
from marigold_tpu_torch.models import surgery as tsurgery
from marigold_tpu_torch.models import weights as TW
from marigold_tpu_torch.models.unet import UNet2DConditionModel
from marigold_tpu_torch.ops import flash_attention as fa
from marigold_tpu_torch.train import train_step as tts
from marigold_tpu_torch.train.lr_schedule import iter_exponential as t_iter_exp
from test_torch_train_cli import write_port_sd2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores several
    times over (tiny models gain nothing from it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MRN = {"strength": 0.9, "annealed": True, "downscale_strategy": "original"}
LR, SCHED = 1e-3, (100, 0.01, 0)


def _nchw(x):
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------- #
# the optimizers on tensors of the UNet's kinds


def _jax_layout(name, t):
    """A port tensor (OIHW conv, [out, in] linear) in the JAX layout."""
    a = t.numpy()
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a.T if a.ndim == 2 else a


SHAPES = {  # port layouts
    "conv.weight": (320, 320, 3, 3),  # factored over (out, in)
    "linear.weight": (1280, 320),  # factored
    "norm.bias": (320,),  # 1-D: v
    "conv_in.weight": (320, 8, 3, 3),  # second-largest dim 8 < 128: v
}


def _run_both(name, micro_grads, k, **opt_kw):
    """micro_grads: list of {param: port-layout grad}; -> (port params,
    JAX params in the port layout, port state)."""
    rng = np.random.default_rng(0)
    params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
              for n, s in SHAPES.items()}
    jopt = jts.make_optimizer(LR, j_iter_exp(*SCHED), k, name=name,
                              **{kk: jnp.bfloat16 for kk in opt_kw})
    jparams = {n: jnp.asarray(_jax_layout(n, p)) for n, p in params.items()}
    jstate = jopt.init(jparams)
    opt = tts.make_optimizer(LR, t_iter_exp(*SCHED), k, name=name, **opt_kw)
    state = opt.init({n: p.clone() for n, p in params.items()})
    for i, g in enumerate(micro_grads):
        jg = {n: jnp.asarray(_jax_layout(n, t)) for n, t in g.items()}
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        opt.accumulate(state, g)
        if (i + 1) % k == 0:
            opt.apply(state)
    back = {}
    for n, p in jparams.items():
        a = np.asarray(p)
        back[n] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else (a.T if a.ndim == 2 else a)
    return state, back, params, jstate


def _grads(seed, n):
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                 * rng.uniform(0.01, 1.0))
             for k, s in SHAPES.items()} for _ in range(n)]


def test_adafactor_two_accumulated_updates_match_optax():
    """4 micro-steps, accumulation 2: the port's Adafactor against
    optax.MultiSteps(optax.adafactor(lr, multiply_by_parameter_scale=False,
    clipping_threshold=1.0)) of the JAX make_optimizer, on a conv weight, a
    linear weight, a bias and the narrow conv_in, in each package's
    layout. Adafactor scales each update to an RMS of at most 1 and the
    factored estimate is symmetric in the two dims, so the packages differ
    by fp32 rounding only: every entry within 1e-4 of lr."""
    state, want, start, _ = _run_both("adafactor", _grads(1, 4), 2)
    assert state.count == 2 and state.acc is None
    opt = tts.make_optimizer(LR, t_iter_exp(*SCHED), 2, name="adafactor")
    for s in SHAPES.values():  # optax's choice of dims, on the port's shape
        assert opt.factored_dims(s) == _factored_dims(s, True, 128), s
    assert opt.factored_dims(SHAPES["conv_in.weight"]) is None
    assert set(state.v_row) == set(state.v_col) == {"conv.weight", "linear.weight"}
    assert set(state.v) == {"norm.bias", "conv_in.weight"}
    for n, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=0, atol=1e-4 * LR,
                                   err_msg=n)
        assert np.abs(want[n] - start[n].numpy()).max() > 0.5 * LR, n


def test_bf16_accumulator_matches_gradient_accumulation():
    """accum_dtype bfloat16 with 3 accumulation steps: after two micro-steps
    the port's running sum is the JAX `gradient_accumulation` bf16
    accumulator bit for bit; after the update the parameters agree as Adam
    does in test_torch_train_step.py (5% of lr per entry)."""
    grads = _grads(2, 3)
    state, want, start, jstate = _run_both("adam", grads[:2], 3,
                                           accum_dtype=torch.bfloat16)
    for n, a in state.acc.items():
        assert a.dtype == torch.bfloat16
        ref = np.asarray(jstate.acc[n].astype(jnp.float32))
        ref = ref.transpose(3, 2, 0, 1) if ref.ndim == 4 else (ref.T if ref.ndim == 2 else ref)
        assert np.array_equal(a.float().numpy(), ref), n
    state, want, start, _ = _run_both("adam", grads, 3, accum_dtype=torch.bfloat16)
    for n, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=0, atol=5e-2 * LR,
                                   err_msg=n)
    # as in the JAX make_optimizer, no narrower accumulator without
    # accumulation
    assert tts.make_optimizer(LR, None, 1, accum_dtype="bfloat16").accum_dtype is None


# ---------------------------------------------------------------------- #
# the step on the tiny checkpoint: normals and IID, grad_dtype, save_heavy


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The tiny SD2 checkpoint (written by the port, read by both packages;
    fp32, CPU), with the normals surgery (conv_in to 8) and the IID
    lighting surgery (3 targets: conv_in to 16, conv_out to 12), and one
    conditioning array."""
    ckpt = write_port_sd2(str(tmp_path_factory.mktemp("sd2")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MARIGOLD_TPU_FASTLOAD", "0")
        jcfg4, jparams4 = JW.load_unet(os.path.join(ckpt, "unet"))
        vae_cfg, vae_params = JW.load_vae(os.path.join(ckpt, "vae"))
    unet4 = TW.load_unet(os.path.join(ckpt, "unet"), device="cpu")
    out = {"jvae_cfg": vae_cfg, "jvae": vae_params,
           "jsched": JSchedule.from_pretrained(os.path.join(ckpt, "scheduler")),
           "tvae": TW.load_vae(os.path.join(ckpt, "vae"), device="cpu"),
           "tsched": TSchedule.from_pretrained(os.path.join(ckpt, "scheduler"))}
    surg = {
        "normals": (lambda c, p: jsurgery.replace_conv_in(c, p, 8),
                    lambda c, p: tsurgery.replace_conv_in(c, p, 8)),
        "iid": (lambda c, p: jsurgery.replace_conv_in_out_multimodal(c, p, 3, 4),
                lambda c, p: tsurgery.replace_conv_in_out_multimodal(c, p, 3, 4)),
    }
    for mode, (jf, tf) in surg.items():
        jcfg, jparams = jf(jcfg4, jparams4)
        tcfg, tsd = tf(unet4.cfg, unet4.state_dict())
        out[mode] = dict(jcfg=jcfg, jparams=jparams, tsd=tsd, unet=TW.build_module(
            UNet2DConditionModel, tcfg, tsd, torch.float32, "cpu"))
    out["text"] = np.random.default_rng(5).standard_normal(
        (1, 2, jcfg4.cross_attention_dim)).astype(np.float32)
    return out


def _batch(mode, seed, bsz=2, hw=(32, 32)):
    """NHWC numpy batch in the JAX step's layout: normals (unit vectors) or
    IID lighting (3 targets in [-1, 1]); no mask, as both recipes train."""
    rng = np.random.default_rng(seed)
    if mode == "normals":
        gt = rng.standard_normal((bsz, *hw, 3)).astype(np.float32)
        gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
    else:
        gt = rng.uniform(-1, 1, (bsz, *hw, 9)).astype(np.float32)
    return {"rgb_norm": rng.uniform(-1, 1, (bsz, *hw, 3)).astype(np.float32),
            "gt_norm": gt}


def _jax_draws(models, batch, key):
    """(timesteps, noise NCHW) as the JAX _make_loss_and_grad draws them
    from `key`, the target latent of each 3-channel group concatenated."""
    k_t, k_noise = jax.random.split(key)
    T = models["jsched"].num_train_timesteps
    t = jax.random.randint(k_t, (batch["rgb_norm"].shape[0],), 0, T)
    gt = jnp.asarray(batch["gt_norm"])
    lat = jnp.concatenate([jvae.encode_mean_scaled(
        models["jvae"], models["jvae_cfg"], gt[..., 3 * i:3 * i + 3])
        for i in range(gt.shape[-1] // 3)], axis=-1).astype(jnp.float32)
    noise = multi_res_noise_like(k_noise, lat, MRN["strength"] * (t / T),
                                 MRN["downscale_strategy"])
    return torch.from_numpy(np.array(t)), _nchw(noise)


def _port(models, mode, batch, key, **kw):
    m = models[mode]
    t, noise = _jax_draws(models, batch, key)
    loss_and_grad = tts.make_loss_and_grad(
        m["unet"], models["tvae"], models["tsched"], "mse_loss", MRN, False,
        **dict(dict(compute_dtype=torch.float32, remat="none"), **kw))
    masters = {n: v.clone().float().requires_grad_() for n, v in m["tsd"].items()}
    return loss_and_grad(masters, torch.from_numpy(models["text"]),
                         {k: _nchw(v) for k, v in batch.items()},
                         timesteps=t, noise=noise)


@pytest.mark.parametrize("mode", ["normals", "iid"])
def test_micro_step_loss_and_every_gradient_match_jax(models, mode):
    """One normals / IID lighting micro-step (no mask, annealed
    multi-resolution noise, fp32) against the JAX objective and backward
    (`_make_loss_and_grad`, which make_train_step differentiates) on the
    JAX draws: loss within rtol 1e-5, each gradient leaf within 1e-4 of its
    own largest entry plus rtol 1e-3 (the depth step's tolerances)."""
    m = models[mode]
    batch, key = _batch(mode, 10), jax.random.PRNGKey(11)
    jlg = jts._make_loss_and_grad(m["jcfg"], models["jvae_cfg"], models["jsched"],
                                  "mse_loss", MRN, False, None, "none", None)
    jloss, jgrads = jax.jit(jlg)(m["jparams"], models["jvae"],
                                 jnp.asarray(models["text"]),
                                 {k: jnp.asarray(v) for k, v in batch.items()}, key)
    loss, grads = _port(models, mode, batch, key)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = TW.from_jax_tree(jgrads)
    assert ref.keys() == grads.keys()
    for n, g in grads.items():
        r = ref[n].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max() + 1e-9, err_msg=n)


def test_grad_dtype_stores_bf16_gradients_of_the_same_forward(models):
    """grad_dtype bfloat16: the forward runs in compute_dtype (fp32 here,
    the loss bit for bit that of grad_dtype None; the JAX package would run
    it in bf16), and each gradient is the fp32 one rounded to bf16, so
    within bf16 rounding (rtol 2**-8) of the fp32 gradients. With a bf16
    forward the bf16 gradients are the ones that reach the fp32 masters."""
    batch, key = _batch("normals", 12), jax.random.PRNGKey(13)
    loss32, g32 = _port(models, "normals", batch, key)
    loss16, g16 = _port(models, "normals", batch, key, grad_dtype="bfloat16")
    assert float(loss16) == float(loss32)
    for n, g in g16.items():
        assert g.dtype == torch.bfloat16, n
        assert torch.equal(g, g32[n].to(torch.bfloat16)), n
        torch.testing.assert_close(g.float(), g32[n], rtol=2**-8, atol=0)
    lossb, gb = _port(models, "normals", batch, key, compute_dtype=torch.bfloat16)
    lossbb, gbb = _port(models, "normals", batch, key, compute_dtype=torch.bfloat16,
                        grad_dtype=torch.bfloat16)
    assert float(lossbb) == float(lossb)
    for n, g in gbb.items():
        assert torch.equal(g.float(), gb[n]), n


def test_save_heavy_gives_the_loss_and_gradients_of_no_remat(models):
    """remat "save_heavy" (selective checkpoint: matmuls, convs and the
    flash lse op saved, elementwise chains recomputed): the loss and
    gradients of remat "none" to fp32 rounding (rtol 1e-5)."""
    batch, key = _batch("iid", 14), jax.random.PRNGKey(15)
    loss_n, grads_n = _port(models, "iid", batch, key)
    loss_h, grads_h = _port(models, "iid", batch, key, remat="save_heavy")
    np.testing.assert_allclose(float(loss_h), float(loss_n), rtol=1e-5)
    for n, g in grads_n.items():
        np.testing.assert_allclose(grads_h[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()) + 1e-12,
                                   err_msg=n)
    with pytest.raises(ValueError, match="remat"):
        tts.make_loss_and_grad(models["iid"]["unet"], models["tvae"],
                               models["tsched"], remat="some")


def test_save_heavy_keeps_the_flash_forward(monkeypatch):
    """The lse forward is a dispatcher op the save_heavy policy keeps: under
    it the forward runs once per step, as without remat; full remat runs it
    again in the backward. (CPU tensors run the plain version, counted
    here through the module function the op calls.)"""
    calls = []
    lse = fa.flash_attention_lse
    monkeypatch.setattr(fa, "flash_attention_lse",
                        lambda *a: calls.append(1) or lse(*a))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 40, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((128, 384)).astype(np.float32) * 0.1)
    w.requires_grad_()

    def fwd(inp):
        q, k, v = (inp @ w).chunk(3, dim=-1)
        return fa.FlashAttentionFunction.apply(q.contiguous(), k.contiguous(),
                                               v.contiguous(), 2, "shifted")

    grads = {}
    for mode, want in (("none", 1), ("full", 2), ("save_heavy", 1)):
        calls.clear()
        out = tts.remat_runner(mode)(fwd, x)
        grads[mode] = torch.autograd.grad(out.square().sum(), w)[0]
        assert len(calls) == want, mode
    for mode in ("full", "save_heavy"):
        torch.testing.assert_close(grads[mode], grads["none"], rtol=1e-5, atol=1e-6)
