"""The port's DDIM schedule against the JAX package's (marigold_tpu.core.
scheduler): tables, timestep sequences, ddim_step, guardrails. fp32,
atol 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from marigold_tpu.core import scheduler as jsched
from marigold_tpu_torch.core import scheduler as tsched

ATOL = 1e-6


def _both(**kw):
    return jsched.DiffusionSchedule.create(**kw), tsched.DiffusionSchedule.create(**kw)


@pytest.mark.parametrize("kw", [
    {},
    {"rescale_betas_zero_snr": False, "set_alpha_to_one": True},
    {"beta_schedule": "linear", "beta_start": 0.0001, "beta_end": 0.02},
    {"beta_schedule": "squaredcos_cap_v2"},
])
def test_tables_match(kw):
    j, t = _both(**kw)
    np.testing.assert_allclose(t.alphas_cumprod, np.asarray(j.alphas_cumprod),
                               atol=ATOL, rtol=0)
    assert t.alphas_cumprod.dtype == np.float32
    assert float(t.final_alpha_cumprod) == float(j.final_alpha_cumprod)
    assert t.to_config() == j.to_config()


@pytest.mark.parametrize("spacing", ["trailing", "leading", "linspace"])
@pytest.mark.parametrize("steps", [1, 4, 10, 50])
def test_timesteps_match(spacing, steps):
    j, t = _both(timestep_spacing=spacing)
    np.testing.assert_array_equal(t.inference_timesteps(steps),
                                  j.inference_timesteps(steps))
    ts = t.inference_timesteps(steps)
    np.testing.assert_array_equal(t.prev_timesteps(ts), j.prev_timesteps(ts))


def test_trailing_one_and_four_steps():
    t = tsched.DiffusionSchedule.create()
    assert list(t.inference_timesteps(1)) == [999]
    assert list(t.inference_timesteps(4)) == [999, 749, 499, 249]


@pytest.mark.parametrize("pred", ["v_prediction", "epsilon", "sample"])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("t,pt", [(999, 749), (249, -1), (500, 499)])
def test_ddim_step_matches(pred, clip, t, pt):
    j, s = _both(prediction_type=pred, clip_sample=clip, clip_sample_range=0.5)
    rng = np.random.default_rng(t)
    out = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    ref = np.asarray(j.ddim_step(jnp.asarray(out), jnp.asarray(t), jnp.asarray(pt),
                                 jnp.asarray(x)))
    got = s.ddim_step(torch.from_numpy(out), t, pt, torch.from_numpy(x)).numpy()
    # the step is elementwise, so the port's NCHW and JAX's NHWC agree here
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_ddim_step_keeps_dtype():
    s = tsched.DiffusionSchedule.create()
    x = torch.randn(1, 4, 3, 3, dtype=torch.bfloat16)
    assert s.ddim_step(x, 999, 749, x).dtype == torch.bfloat16


def test_from_pretrained_reads_a_jax_saved_dir(tmp_path):
    j = jsched.DiffusionSchedule.create(prediction_type="epsilon",
                                        timestep_spacing="leading")
    j.save_pretrained(str(tmp_path))
    t = tsched.DiffusionSchedule.from_pretrained(str(tmp_path))
    assert t.to_config() == j.to_config()
    np.testing.assert_allclose(t.alphas_cumprod, np.asarray(j.alphas_cumprod),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw,steps", [
    ({}, 4), ({}, 50), ({"timestep_spacing": "leading"}, 4),
    ({"rescale_betas_zero_snr": False}, 1),
])
def test_check_trailing_zero_snr_matches(kw, steps):
    j, t = _both(**kw)
    assert tsched.check_trailing_zero_snr(t, steps) == \
        jsched.check_trailing_zero_snr(j, steps)
