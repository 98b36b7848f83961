"""Public names of the JAX package that code written against it reaches,
held to the port: the back-compat output alias, `core`'s re-exports and
`colorize_depth_maps(valid_mask=)` (fp32, CPU)."""

import numpy as np
import pytest

import marigold_tpu
import marigold_tpu.core as jcore
import marigold_tpu_torch
import marigold_tpu_torch.core as tcore
from marigold_tpu.pipelines import image_util as jiu
from marigold_tpu_torch.pipelines import image_util as tiu


def test_the_package_exports_the_jax_names():
    assert set(marigold_tpu.__all__) <= set(marigold_tpu_torch.__all__)
    assert marigold_tpu_torch.MarigoldPipelineOutput is \
        marigold_tpu_torch.MarigoldDepthOutput
    assert marigold_tpu_torch.MarigoldPipeline is \
        marigold_tpu_torch.MarigoldDepthPipeline


@pytest.mark.parametrize("name", jcore.__all__)
def test_core_reexports_the_schedule(name):
    assert name in tcore.__all__
    if name == "DiffusionSchedule":
        return
    if name == "make_betas":
        args = [(1000, 0.00085, 0.012, "scaled_linear")]
    elif name == "rescale_zero_terminal_snr":
        args = [(np.linspace(1e-4, 0.02, 1000, dtype=np.float32),)]
    else:
        args = [(1000, n) for n in (1, 4, 10, 50)]
    for a in args:
        np.testing.assert_array_equal(np.asarray(getattr(tcore, name)(*a)),
                                      np.asarray(getattr(jcore, name)(*a)))


@pytest.mark.parametrize("shape", [(24, 32), (2, 24, 32)])
def test_colorize_valid_mask_matches_jax(shape):
    rng = np.random.default_rng(0)
    depth = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    mask = rng.uniform(size=shape) > 0.3
    got = tiu.colorize_depth_maps(depth, 0.0, 1.0, cmap="Spectral",
                                  valid_mask=mask)
    ref = jiu.colorize_depth_maps(depth, 0.0, 1.0, cmap="Spectral",
                                  valid_mask=mask)
    assert got.shape == ref.shape == (len(depth.reshape(-1, 24, 32)), 3, 24, 32)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert (got.transpose(0, 2, 3, 1)[~mask.reshape(-1, 24, 32)] == 0).all()
    unmasked = tiu.colorize_depth_maps(depth, 0.0, 1.0, cmap="Spectral")
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1)[mask.reshape(-1, 24, 32)],
                                  unmasked.transpose(0, 2, 3, 1)[mask.reshape(-1, 24, 32)])
