"""The port's training objective and step (marigold_tpu_torch.train,
core/scheduler.py's training half, models/surgery.py, utils/seeding.py)
against the JAX package on the tiny SD2-layout checkpoint of
tests/fixtures.py, fp32 on the CPU.

The frameworks draw different random numbers from one seed, so the port is
handed the JAX package's own draws: the timesteps and the multi-resolution
noise that `_make_loss_and_grad` draws from its key are reproduced here in
JAX and passed to the port's step. Tolerances are stated per test."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_tiny_checkpoint
from marigold_tpu.core.scheduler import DiffusionSchedule as JSchedule
from marigold_tpu.models import surgery as jsurgery
from marigold_tpu.models import vae as jvae
from marigold_tpu.models import weights as JW
from marigold_tpu.train import loss as jloss
from marigold_tpu.train import train_step as jts
from marigold_tpu.train.lr_schedule import iter_exponential as j_iter_exp
from marigold_tpu.train.multi_res_noise import _num_levels, multi_res_noise_like
from marigold_tpu.utils import seeding as jseed
from marigold_tpu_torch.core.scheduler import DiffusionSchedule as TSchedule
from marigold_tpu_torch.models import surgery as tsurgery
from marigold_tpu_torch.models import weights as TW
from marigold_tpu_torch.models.unet import UNet2DConditionModel
from marigold_tpu_torch.train import loss as tloss
from marigold_tpu_torch.train import multi_res_noise as tmrn
from marigold_tpu_torch.train import train_step as tts
from marigold_tpu_torch.train.lr_schedule import iter_exponential as t_iter_exp
from marigold_tpu_torch.utils import seeding as tseed

MRN = {"strength": 0.9, "annealed": True, "downscale_strategy": "original"}


def _nchw(x):
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------- #
# the objective's pieces


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_scheduler_training_half_matches_jax(rng, prediction_type):
    js = JSchedule.create(prediction_type=prediction_type)
    ts = TSchedule.create(prediction_type=prediction_type)
    x0 = rng.standard_normal((3, 4, 6, 5)).astype(np.float32)
    eps = rng.standard_normal((3, 4, 6, 5)).astype(np.float32)
    t = np.array([0, 517, 999], np.int32)
    for name in ("add_noise", "training_target"):
        ref = np.asarray(getattr(js, name)(jnp.asarray(x0), jnp.asarray(eps),
                                           jnp.asarray(t)))
        got = getattr(ts, name)(torch.from_numpy(x0), torch.from_numpy(eps),
                                torch.from_numpy(t)).numpy()
        # fp32 elementwise, the same table: atol 1e-6
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("name", sorted(tloss._LOSSES))
def test_losses_match_jax(rng, name):
    pred = rng.uniform(0.1, 2.0, (2, 4, 6, 5)).astype(np.float32)
    target = rng.uniform(0.1, 2.0, (2, 4, 6, 5)).astype(np.float32)
    mask = rng.uniform(size=pred.shape) > 0.3
    jfn, tfn = jloss.get_loss(name), tloss.get_loss(name)
    if name in ("mse_loss", "l1_loss"):
        cases = [{"reduction": r} for r in ("mean", "sum", "none")]
    else:
        cases = [{}, {"valid_mask": mask}]
    for kw in cases:
        ref = np.asarray(jfn(jnp.asarray(pred), jnp.asarray(target),
                             **{k: jnp.asarray(v) if k == "valid_mask" else v
                                for k, v in kw.items()}))
        got = tfn(torch.from_numpy(pred), torch.from_numpy(target),
                  **{k: torch.from_numpy(v) if k == "valid_mask" else v
                     for k, v in kw.items()}).numpy()
        # fp32 sums in another order: rtol 1e-5
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7,
                                   err_msg=f"{name} {list(kw)}")


@pytest.mark.parametrize("warmup", [0, 10])
def test_iter_exponential_matches_jax(warmup):
    j, t = j_iter_exp(100, 0.01, warmup), t_iter_exp(100, 0.01, warmup)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        # both fp32: rtol 1e-6
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6, atol=0,
                                   err_msg=str(step))


def test_seed_sequence_is_the_jax_one():
    for seed, n in ((2024, 64), (-7, 5), (2**40, 3)):
        assert tseed.generate_seed_sequence(seed, n) == \
            jseed.generate_seed_sequence(seed, n)
    a = tseed.generator_from_seed(-123456789012)
    b = tseed.generator_from_seed(-123456789012 + 2**31)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


def _jax_mrn_draws(key, shape_nhwc, strategy):
    """The draws of the JAX multi_res_noise_like, as the port's
    draw_multi_res dict (NCHW)."""
    b, h, w, c = shape_nhwc
    n = _num_levels(h, w)
    keys = jax.random.split(key, n + 2)
    base = jax.random.normal(keys[0], shape_nhwc, jnp.float32)
    levels = [jax.random.normal(keys[i], (b, max(1, h >> i), max(1, w >> i), c),
                                jnp.float32) for i in range(1, n)]
    r = None
    if strategy in ("original", "random_step"):
        r = torch.tensor(float(jax.random.uniform(keys[-1], (), jnp.float32)
                               * 2.0 + 2.0))
    return {"base": _nchw(base), "levels": [_nchw(lv) for lv in levels], "r": r}


@pytest.mark.parametrize("strategy,strength,hw", [
    # annealed per-sample strength at the 480x640 latent (ragged levels)
    ("original", np.array([0.9, 0.3], np.float32), (60, 80)),
    ("power_of_two", 0.9, (16, 16)),
])
def test_multi_res_noise_from_jax_draws(strategy, strength, hw):
    shape = (2, *hw, 4)
    key = jax.random.PRNGKey(3)
    ref = multi_res_noise_like(key, jnp.zeros(shape, jnp.float32),
                               jnp.asarray(strength), strategy)
    draws = _jax_mrn_draws(key, shape, strategy)
    got = tmrn.combine_multi_res(draws, torch.as_tensor(strength))
    # unit-std fp32 noise; bilinear weights computed in another order
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5, rtol=0)
    own = tmrn.draw_multi_res((2, 4, *hw), torch.Generator().manual_seed(0),
                              "cpu", strategy)
    assert [tuple(x.shape) for x in own["levels"]] == \
        [tuple(x.shape) for x in draws["levels"]]


def test_downsample_valid_mask_matches_jax(rng):
    mask = rng.uniform(size=(2, 64, 44, 1)) > 0.02  # 44: a ragged window
    ref = np.asarray(jts.downsample_valid_mask(jnp.asarray(mask), 8))
    got = tts.downsample_valid_mask(_nchw(mask), 8)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(_nhwc(got), ref)


# ---------------------------------------------------------------------- #
# the step on the tiny checkpoint


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX and port models loaded from one tiny SD2 checkpoint, both after
    the depth trainer's conv_in surgery (fp32, CPU), and one conditioning
    array shared by both."""
    ckpt = make_tiny_checkpoint(str(tmp_path_factory.mktemp("sd2")), mode="sd2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MARIGOLD_TPU_FASTLOAD", "0")
        jcfg4, jparams4 = JW.load_unet(os.path.join(ckpt, "unet"))
        vae_cfg, vae_params = JW.load_vae(os.path.join(ckpt, "vae"))
    jcfg, jparams = jsurgery.replace_conv_in(jcfg4, jparams4, 8)
    unet4 = TW.load_unet(os.path.join(ckpt, "unet"), device="cpu")
    tcfg, tsd = tsurgery.replace_conv_in(unet4.cfg, unet4.state_dict(), 8)
    text = np.random.default_rng(5).standard_normal((1, 2, jcfg.cross_attention_dim))
    return dict(
        jcfg=jcfg, jparams=jparams, jvae_cfg=vae_cfg, jvae=vae_params,
        jsched=JSchedule.from_pretrained(os.path.join(ckpt, "scheduler")),
        tcfg4=unet4.cfg, tcfg=tcfg, tsd=tsd,
        unet=TW.build_module(UNet2DConditionModel, tcfg, tsd, torch.float32, "cpu"),
        tvae=TW.load_vae(os.path.join(ckpt, "vae"), device="cpu"),
        tsched=TSchedule.from_pretrained(os.path.join(ckpt, "scheduler")),
        text=text.astype(np.float32))


def test_surgery_matches_jax(models):
    assert models["tcfg"] == dataclasses.replace(models["tcfg4"], in_channels=8)
    assert models["jcfg"].in_channels == 8
    ref = TW.from_jax_tree(models["jparams"])
    assert ref.keys() == models["tsd"].keys()
    for n, t in models["tsd"].items():
        assert torch.equal(t, ref[n]), n


def _batch(seed, bsz=2, hw=(32, 32)):
    """NHWC numpy batch in the JAX step's layout, some pixels invalid."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(-1, 1, (bsz, *hw, 1)).astype(np.float32)
    return {
        "rgb_norm": rng.uniform(-1, 1, (bsz, *hw, 3)).astype(np.float32),
        "gt_norm": np.repeat(depth, 3, axis=-1),
        "valid_mask": rng.uniform(size=(bsz, *hw, 1)) > 0.05,
    }


def _to_port(batch):
    return {"rgb_norm": _nchw(batch["rgb_norm"]), "gt_norm": _nchw(batch["gt_norm"]),
            "valid_mask": _nchw(batch["valid_mask"])}


def _jax_step_draws(models, batch, key):
    """(timesteps, noise NCHW) exactly as the JAX _make_loss_and_grad draws
    them from `key` (annealed multi-resolution noise)."""
    k_t, k_noise = jax.random.split(key)
    bsz = batch["rgb_norm"].shape[0]
    T = models["jsched"].num_train_timesteps
    t = jax.random.randint(k_t, (bsz,), 0, T)
    gt_lat = jvae.encode_mean_scaled(models["jvae"], models["jvae_cfg"],
                                     jnp.asarray(batch["gt_norm"]))
    strength = MRN["strength"] * (t.astype(jnp.float32) / T)
    noise = multi_res_noise_like(k_noise, gt_lat.astype(jnp.float32), strength,
                                 MRN["downscale_strategy"])
    return torch.from_numpy(np.array(t)), _nchw(noise)


def _port_masters(models):
    return {n: t.clone().float().requires_grad_() for n, t in models["tsd"].items()}


LR, SCHED = 1e-3, (100, 0.01, 0)
MICRO_STEPS = [(_batch(100 + i), jax.random.PRNGKey(200 + i)) for i in range(4)]


@pytest.fixture(scope="module")
def jax_run(models):
    """4 micro-steps of the JAX make_train_step (optax.MultiSteps(adam),
    accumulation 2, fp32): per-step metrics, the first micro-step's
    gradients (MultiSteps' accumulator holds exactly them after one step)
    and the final parameters."""
    jopt = jts.make_optimizer(LR, j_iter_exp(*SCHED), 2, name="adam")
    jstep = jax.jit(jts.make_train_step(
        models["jcfg"], models["jvae_cfg"], models["jsched"], jopt, "mse_loss",
        MRN, True, None, "none"))
    state = jts.create_train_state(models["jparams"], jopt)
    metrics, first_grads = [], None
    for batch, key in MICRO_STEPS:
        state, m = jstep(state, models["jvae"], jnp.asarray(models["text"]),
                         {k: jnp.asarray(v) for k, v in batch.items()}, key)
        metrics.append({k: float(v) for k, v in m.items()})
        if first_grads is None:
            first_grads = TW.from_jax_tree(state.opt_state.acc_grads)
    return metrics, first_grads, TW.from_jax_tree(state.params)


def test_loss_and_every_gradient_match_jax(models, jax_run):
    metrics, ref, _ = jax_run
    batch, key = MICRO_STEPS[0]
    t, noise = _jax_step_draws(models, batch, key)
    loss_and_grad = tts.make_loss_and_grad(
        models["unet"], models["tvae"], models["tsched"], "mse_loss", MRN, True,
        torch.float32, "none")
    loss, grads = loss_and_grad(_port_masters(models),
                                torch.from_numpy(models["text"]),
                                _to_port(batch), timesteps=t, noise=noise)
    # fp32 forward of the same model: rtol 1e-5 on the loss
    np.testing.assert_allclose(float(loss), metrics[0]["loss"], rtol=1e-5)
    assert ref.keys() == grads.keys()
    for n, g in grads.items():
        r = ref[n].numpy()
        # fp32 backward through convs/norms summed in another order: each
        # leaf within 1e-4 of its own largest entry, plus rtol 1e-3
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max() + 1e-9, err_msg=n)


def test_full_remat_gives_the_same_loss_and_gradients(models):
    """remat="full" (torch.utils.checkpoint around the UNet forward)
    recomputes the forward in the backward: the same loss and gradients
    as remat="none", to fp32 rounding (rtol 1e-5)."""
    batch, key = MICRO_STEPS[1]
    t, noise = _jax_step_draws(models, batch, key)
    out = []
    for remat in ("none", "full"):
        loss_and_grad = tts.make_loss_and_grad(
            models["unet"], models["tvae"], models["tsched"], "mse_loss", MRN,
            True, torch.float32, remat)
        out.append(loss_and_grad(_port_masters(models),
                                 torch.from_numpy(models["text"]),
                                 _to_port(batch), timesteps=t, noise=noise))
    (loss_n, grads_n), (loss_f, grads_f) = out
    np.testing.assert_allclose(float(loss_f), float(loss_n), rtol=1e-5)
    for n, g in grads_n.items():
        np.testing.assert_allclose(grads_f[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()) + 1e-12,
                                   err_msg=n)


def test_two_accumulated_adam_updates_match_jax(models, jax_run):
    """4 micro-steps, accumulation 2: the port's micro_step/apply_step
    against the JAX make_train_step with optax.MultiSteps(adam)."""
    metrics, _, ref = jax_run
    opt = tts.make_optimizer(LR, t_iter_exp(*SCHED), 2, name="adam")
    micro, apply = tts.make_train_step(
        models["unet"], models["tvae"], models["tsched"], opt,
        loss_name="mse_loss", multi_res_noise_cfg=MRN, use_mask=True,
        compute_dtype=torch.float32)
    state = opt.init(_port_masters(models))
    for i, (batch, key) in enumerate(MICRO_STEPS):
        t, noise = _jax_step_draws(models, batch, key)
        m = micro(state, torch.from_numpy(models["text"]), _to_port(batch),
                  timesteps=t, noise=noise)
        if i % 2 == 1:
            apply(state)
        np.testing.assert_allclose(float(m["loss"]), metrics[i]["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), metrics[i]["grad_norm"],
                                   rtol=1e-4)
    assert (state.step, state.count, state.mini_step) == (4, 2, 0)
    start = models["tsd"]
    diffs = []
    for n, p in state.params.items():
        got, want = p.detach().numpy(), ref[n].numpy()
        # Two Adam steps move each parameter by up to ~2 lr. Adam divides
        # each gradient by its own magnitude, so where a gradient is near
        # eps (1e-8) its ~1e-4-relative difference between the packages is
        # amplified: every entry within 5% of lr, and the mean within
        # 1e-3 of lr.
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * LR, err_msg=n)
        diffs.append(np.abs(got - want).ravel())
        assert np.abs(want - start[n].numpy()).max() > 0.5 * LR, n
    assert np.concatenate(diffs).mean() < 1e-3 * LR
