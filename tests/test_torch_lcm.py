"""LCM sampling of the port against `marigold_tpu/core/lcm.py`, and the
depth pipeline on a tiny LCM checkpoint (tests/fixtures.py's depth
checkpoint with an LCMScheduler config) against the JAX package's (fp32,
CPU).

The JAX package draws LCM's fresh per-step noise inside its programs from
keys folded per chunk and step, which torch cannot reproduce. A 1-step
request draws none, so it is compared on shared initial noise; the 4-step
requests patch both packages' normal draws to the same arrays keyed by
shape. Tolerances: STEP_ATOL = 1e-6 on one fp32 step; ATOL = 1e-4 on the
depth maps (fp32 through the UNet, the VAE and the resizes)."""

import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fixtures import make_tiny_checkpoint
from marigold_tpu.core.lcm import LCMSchedule as JaxLCM
from marigold_tpu.core.scheduler import DiffusionSchedule as JaxSchedule
from marigold_tpu.pipelines.depth import MarigoldDepthPipeline as JaxDepth
from marigold_tpu_torch import MarigoldDepthPipeline as TorchDepth
from marigold_tpu_torch import MarigoldIIDPipeline as TorchIID
from marigold_tpu_torch import MarigoldNormalsPipeline as TorchNormals
from marigold_tpu_torch.core.lcm import LCMSchedule as TorchLCM
from marigold_tpu_torch.core.scheduler import DiffusionSchedule as TorchSchedule
from marigold_tpu_torch.models import weights as W

ATOL = 1e-4
STEP_ATOL = 1e-6
# diffusers LCMScheduler's own defaults beside the Marigold v1 schedule
LCM_CONFIG = {"_class_name": "LCMScheduler", "num_train_timesteps": 1000,
              "beta_start": 0.00085, "beta_end": 0.012,
              "beta_schedule": "scaled_linear", "prediction_type": "epsilon",
              "timestep_spacing": "leading", "steps_offset": 1,
              "rescale_betas_zero_snr": False, "set_alpha_to_one": True,
              "original_inference_steps": 50}


@pytest.fixture(scope="module")
def lcm_ckpt(tmp_path_factory):
    ckpt = make_tiny_checkpoint(str(tmp_path_factory.mktemp("lcm")))
    W.write_config(LCM_CONFIG, os.path.join(ckpt, "scheduler"),
                   "scheduler_config.json")
    return ckpt


@pytest.fixture(scope="module")
def pipes(lcm_ckpt):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MARIGOLD_TPU_FASTLOAD", "0")  # the per-tensor host loader
        jpipe = JaxDepth.from_pretrained(lcm_ckpt, dtype=jnp.float32)
    tpipe = TorchDepth.from_pretrained(lcm_ckpt, dtype=torch.float32,
                                       device="cpu")
    assert jpipe.core.lcm is not None and tpipe.core.lcm is not None
    return jpipe, tpipe


def _image(seed, h=40, w=56):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _schedules(prediction_type, steps=50):
    kw = dict(prediction_type=prediction_type, timestep_spacing="leading",
              rescale_betas_zero_snr=False)
    return (JaxLCM.create(JaxSchedule.create(**kw), original_inference_steps=steps),
            TorchLCM.create(TorchSchedule.create(**kw),
                            original_inference_steps=steps))


@pytest.mark.parametrize("steps", [1, 2, 4, 8, 50])
def test_timesteps_and_boundary_scalings_match_jax(steps):
    jl, tl = _schedules("epsilon")
    ts = tl.inference_timesteps(steps)
    np.testing.assert_array_equal(ts, jl.inference_timesteps(steps))
    assert len(ts) == steps and ts[0] == 999 and np.all(np.diff(ts) < 0)
    np.testing.assert_array_equal(tl.prev_timesteps(ts),
                                  np.concatenate([ts[1:], [-1]]))
    for t in ts:
        ref = jl.boundary_scalings(jnp.asarray(t, jnp.int32))
        for g, r in zip(tl.boundary_scalings(int(t)), ref):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6, atol=0)


def test_too_many_steps_raise_as_in_jax():
    jl, tl = _schedules("epsilon", steps=20)
    for sched in (jl, tl):
        with pytest.raises(ValueError, match="original_inference_steps"):
            sched.inference_timesteps(21)
    assert len(tl.inference_timesteps(20)) == 20


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("last", [False, True])
def test_step_matches_jax(prediction_type, last):
    """One step at t=759 -> 519: (prev, denoised); the last step returns
    denoised as prev and needs no noise."""
    jl, tl = _schedules(prediction_type)
    rng = np.random.default_rng(0)
    out, sample, noise = (rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
                          for _ in range(3))
    t, pt = 759, 519
    ref = jl.step(jnp.asarray(out), jnp.asarray(t), jnp.asarray(pt),
                  jnp.asarray(sample), jnp.asarray(noise), jnp.asarray(last))
    got = tl.step(torch.from_numpy(out), t, pt, torch.from_numpy(sample),
                  None if last else torch.from_numpy(noise), last)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=STEP_ATOL,
                                   rtol=0)
    if last:
        torch.testing.assert_close(got[0], got[1], rtol=0, atol=0)
    bf16 = tl.step(torch.from_numpy(out), t, pt,
                   torch.from_numpy(sample).bfloat16(),
                   torch.from_numpy(noise), last)
    assert bf16[0].dtype == bf16[1].dtype == torch.bfloat16


@pytest.mark.parametrize("entry", ["call", "batch_call"])
def test_one_step_request_matches_jax_on_shared_noise(pipes, monkeypatch,
                                                      caplog, entry):
    """A 1-step E=1 request: the JAX package splits its key for LCM and
    draws the initial noise from the first half; no fresh noise is drawn.
    The depth pipeline logs the deprecation warning."""
    jpipe, tpipe = pipes
    key = jax.random.split(jax.random.PRNGKey(11))[0]
    draws = []

    def noise(n, h, w, seed):
        shape = (n, h, w, 4) if entry == "call" else (n, 1, h, w, 4)
        a = np.asarray(jax.random.normal(key, shape, jnp.float32))
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape((n, h, w, 4)).transpose(0, 3, 1, 2)))

    monkeypatch.setattr(tpipe, "_noise", noise)
    monkeypatch.setattr(tpipe.core, "step_noise",
                        lambda shape, gen: draws.append(shape))
    kw = dict(denoising_steps=1, processing_res=32, seed=11)
    with caplog.at_level(logging.WARNING):
        if entry == "call":
            ref = [jpipe(_image(0), color_map=None, **kw)]
            got = [tpipe(_image(0), color_map=None, **kw)]
        else:
            ref = jpipe.batch_call([_image(1), _image(2)], **kw)
            got = tpipe.batch_call([_image(1), _image(2)], **kw)
    assert any("deprecated" in r.getMessage() for r in caplog.records
               if r.name == "marigold_tpu_torch.pipelines.depth")
    assert draws == []
    for g, r in zip(got, ref):
        assert g.depth_np.shape == (40, 56)
        np.testing.assert_allclose(g.depth_np, r.depth_np, atol=ATOL, rtol=0)


def _keyed(shape):
    """Standard normals keyed by an NHWC shape (the same array for the same
    shape in both packages)."""
    rng = np.random.default_rng(abs(hash(tuple(shape))) % (2**32))
    return rng.standard_normal(tuple(shape)).astype(np.float32)


@pytest.mark.parametrize("entry", ["call", "batch_call"])
def test_four_step_request_matches_jax_on_keyed_draws(pipes, monkeypatch, entry):
    """4 steps re-noise three times. jax.random.normal and the port's two
    draws (`_noise` for the initial noise, `core.step_noise` for each fresh
    draw, NCHW) return the same shape-keyed arrays. In batch_call the
    initial noise ([NI, E, h, w, 4]) and the fresh draws ([rows, h, w, 4])
    differ in shape, so each step gets noise unlike the initial."""
    jpipe, tpipe = pipes
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_keyed(shape), dtype))
    draws = []

    def step_noise(shape, gen):
        draws.append(tuple(shape))
        n, c, h, w = shape
        return torch.from_numpy(_keyed((n, h, w, c)).transpose(0, 3, 1, 2).copy())

    monkeypatch.setattr(tpipe.core, "step_noise", step_noise)
    kw = dict(denoising_steps=4, processing_res=32, seed=0)
    if entry == "call":
        monkeypatch.setattr(tpipe, "_noise", lambda n, h, w, seed: torch.from_numpy(
            _keyed((n, h, w, 4)).transpose(0, 3, 1, 2).copy()))
        ref = [jpipe(_image(3), color_map=None, **kw)]
        got = [tpipe(_image(3), color_map=None, **kw)]
        rows = 1
    else:
        monkeypatch.setattr(tpipe, "_noise", lambda n, h, w, seed: torch.from_numpy(
            _keyed((n, 1, h, w, 4)).reshape(n, h, w, 4).transpose(0, 3, 1, 2).copy()))
        ref = jpipe.batch_call([_image(4), _image(5)], **kw)
        got = tpipe.batch_call([_image(4), _image(5)], **kw)
        rows = 2
    # every step but the last; the tiny VAE downsamples 22x32 by 2
    assert draws == [(rows, 4, 11, 16)] * 3
    for g, r in zip(got, ref):
        assert g.depth_np.shape == (40, 56)
        assert 0.0 <= g.depth_np.min() and g.depth_np.max() <= 1.0
        np.testing.assert_allclose(g.depth_np, r.depth_np, atol=ATOL, rtol=0)


def test_seed_fixes_the_lcm_map(pipes, monkeypatch):
    """The fresh draws come from the request's generator in a fixed order:
    one seed gives one map, another seed another, and every chunk and step
    gets its own draw (E=2 in chunks of 1, 4 steps: six distinct draws)."""
    _, tpipe = pipes
    img = _image(6, 30, 44)
    kw = dict(denoising_steps=4, processing_res=32, color_map=None)
    a, b = (tpipe(img, seed=1, **kw).depth_np for _ in range(2))
    c = tpipe(img, seed=2, **kw).depth_np
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    draws = []
    step_noise = tpipe.core.step_noise

    def record(shape, gen):
        draws.append(step_noise(shape, gen))
        return draws[-1]

    monkeypatch.setattr(tpipe.core, "step_noise", record)
    out = tpipe(img, seed=1, ensemble_size=2, batch_size=1, **kw)
    assert len(draws) == 6 and np.isfinite(out.uncertainty).all()
    assert all(not torch.equal(x, y) for i, x in enumerate(draws)
               for y in draws[i + 1:])
    np.testing.assert_array_equal(
        tpipe(img, seed=1, ensemble_size=2, batch_size=1, **kw).depth_np,
        out.depth_np)


@pytest.mark.parametrize("cls", [TorchNormals, TorchIID])
def test_normals_and_iid_reject_lcm_checkpoints(lcm_ckpt, cls):
    pipe = cls.from_pretrained(lcm_ckpt, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="LCM"):
        pipe(_image(7), denoising_steps=1)
    with pytest.raises(ValueError, match="LCM"):
        pipe.batch_call([_image(7)], denoising_steps=1)
