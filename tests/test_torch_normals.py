"""The port's normals pipeline against the JAX package's, on the tiny normals
checkpoint of tests/fixtures.py (fp32, CPU).

The two frameworks draw different random numbers from one seed, so the
pipeline comparisons hand the port the JAX package's own initial noise
(drawn here as its programs draw it). Tolerances: ATOL = 1e-4 on maps and
uncertainties (fp32 through the UNet, the VAE and the resizes);
ENS_ATOL = 1e-6 for `ensemble_normals` on identical unit vectors."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fixtures import make_tiny_checkpoint
from marigold_tpu.pipelines import ensemble as jens
from marigold_tpu.pipelines.normals import MarigoldNormalsPipeline as JaxNormals
from marigold_tpu_torch import MarigoldNormalsPipeline as TorchNormals
from marigold_tpu_torch.pipelines import base as tbase
from marigold_tpu_torch.pipelines import ensemble as tens
from marigold_tpu_torch.pipelines import image_util as tiu

ATOL = 1e-4
ENS_ATOL = 1e-6


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    ckpt = make_tiny_checkpoint(str(tmp_path_factory.mktemp("normals")),
                                mode="normals")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MARIGOLD_TPU_FASTLOAD", "0")  # the per-tensor host loader
        jpipe = JaxNormals.from_pretrained(ckpt, dtype=jnp.float32)
    tpipe = TorchNormals.from_pretrained(ckpt, dtype=torch.float32, device="cpu")
    return jpipe, tpipe


def _image(seed, h=40, w=56):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _jax_noise(seed, shape):
    """The JAX programs' initial noise, NHWC -> the port's NCHW rows."""
    n = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    return torch.from_numpy(np.ascontiguousarray(
        n.reshape((-1,) + shape[-3:]).transpose(0, 3, 1, 2)))


def _unit_vectors(shape, seed):
    v = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _assert_unit(n, tol=1e-5):
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=tol, rtol=0)


@pytest.mark.parametrize("reduction", ["closest", "mean"])
@pytest.mark.parametrize("uncertainty", [True, False])
def test_ensemble_normals_matches_jax(reduction, uncertainty):
    # members spread around a common direction, as an ensemble's are
    base = _unit_vectors((1, 9, 11, 3), 0)
    members = base + 0.4 * _unit_vectors((5, 9, 11, 3), 1)
    members /= np.linalg.norm(members, axis=-1, keepdims=True)
    ref, ref_unc = jens.ensemble_normals(jnp.asarray(members), uncertainty,
                                         reduction)
    got, got_unc = tens.ensemble_normals(
        torch.from_numpy(members).permute(0, 3, 1, 2), uncertainty, reduction)
    assert got.shape == (1, 3, 9, 11)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=ENS_ATOL, rtol=0)
    if uncertainty:
        assert got_unc.shape == (1, 1, 9, 11)
        assert 0.0 <= got_unc.min() and got_unc.max() <= 1.0
        np.testing.assert_allclose(got_unc.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref_unc), atol=ENS_ATOL, rtol=0)
    else:
        assert got_unc is None and ref_unc is None


def test_ensemble_normals_rejects_bad_input():
    with pytest.raises(ValueError, match="Unrecognized"):
        tens.ensemble_normals(torch.zeros((2, 3, 4, 4)), reduction="median")
    with pytest.raises(ValueError, match="Expecting"):
        tens.ensemble_normals(torch.zeros((2, 1, 4, 4)))


def test_call_matches_jax_on_shared_noise(pipes, monkeypatch):
    """E=1 __call__: processing-res resize, pad, encode, 4-step DDIM,
    decode (clip, renormalize), crop, host resize back to 40x56 and the
    renormalization after it."""
    jpipe, tpipe = pipes
    img = _image(0)
    ref = jpipe(img, denoising_steps=4, processing_res=32, seed=7)
    shapes = []

    def noise(n, h, w, seed):
        shapes.append((n, h, w))
        return _jax_noise(7, (n, h, w, 4))

    monkeypatch.setattr(tpipe, "_noise", noise)
    got = tpipe(img, denoising_steps=4, processing_res=32, seed=7)
    # 40x56 -> 22x32; the tiny VAE downsamples by 2: latent 11x16
    assert shapes == [(1, 11, 16)]
    assert got.normals_np.shape == (40, 56, 3) and got.uncertainty is None
    _assert_unit(got.normals_np)
    np.testing.assert_allclose(got.normals_np, ref.normals_np, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np.asarray(got.normals_img),
                                  tiu.norm_to_rgb(got.normals_np))


@pytest.mark.parametrize("compact", [False, True])
def test_batch_call_matches_jax_on_shared_noise(pipes, monkeypatch, compact):
    """E=1 batch_call of two images: the on-device resize back, the
    renormalization after it and, with compact_readback, the (x+1)/2 uint16
    readback (within ATOL: one uint16 step is 3.1e-5 in [-1, 1])."""
    jpipe, tpipe = pipes
    imgs = [_image(1), _image(2)]
    kw = dict(denoising_steps=4, processing_res=32, seed=5,
              compact_readback=compact)
    ref = jpipe.batch_call(imgs, **kw)
    monkeypatch.setattr(
        tpipe, "_noise", lambda n, h, w, seed: _jax_noise(5, (n, 1, h, w, 4)))
    got = tpipe.batch_call(imgs, **kw)
    for r, g in zip(ref, got):
        assert g.normals_np.shape == (40, 56, 3) and g.uncertainty is None
        assert g.normals_np.min() < -0.05  # [-1, 1], not the (x+1)/2 range
        _assert_unit(g.normals_np, tol=1e-4 if compact else 1e-5)
        np.testing.assert_allclose(g.normals_np, r.normals_np, atol=ATOL, rtol=0)


@pytest.mark.parametrize("entry", ["call", "batch_call"])
def test_mean_ensemble_matches_jax_on_shared_noise(pipes, monkeypatch, entry):
    """E=3, reduction="mean": members in chunks of 2 (__call__), the
    renormalized mean and the arccos uncertainty, both resized back."""
    jpipe, tpipe = pipes
    kw = dict(denoising_steps=2, ensemble_size=3, processing_res=32, seed=3,
              ensemble_kwargs={"reduction": "mean"})
    if entry == "call":
        img = _image(3)
        ref = [jpipe(img, batch_size=2, **kw)]
        monkeypatch.setattr(tpipe, "_noise", lambda n, h, w, seed:
                            _jax_noise(3, (n, h, w, 4)))
        got = [tpipe(img, batch_size=2, **kw)]
    else:
        imgs = [_image(4), _image(5)]
        ref = jpipe.batch_call(imgs, **kw)
        monkeypatch.setattr(tpipe, "_noise", lambda n, h, w, seed:
                            _jax_noise(3, (2, 3, h, w, 4)))
        got = tpipe.batch_call(imgs, **kw)
    for r, g in zip(ref, got):
        assert g.uncertainty.shape == (40, 56)
        assert 0.0 <= g.uncertainty.min() and g.uncertainty.max() <= 1.0
        _assert_unit(g.normals_np)
        np.testing.assert_allclose(g.normals_np, r.normals_np, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.uncertainty, r.uncertainty, atol=ATOL,
                                   rtol=0)


def test_closest_ensemble_matches_jax_away_from_near_ties(pipes, monkeypatch):
    """E=3, reduction="closest" (the default) at processing resolution
    (match_input_res=False, 22x32): "closest" is an argmax over the members'
    cosines to their mean, so where the top two cosines are within 1e-4 the
    two packages may pick different members. The maps are held to ATOL
    wherever the top two differ by more than 1e-4 (on this seed that
    excludes 2 of the 704 pixels), the uncertainty everywhere."""
    jpipe, tpipe = pipes
    img = _image(6)
    kw = dict(denoising_steps=2, ensemble_size=3, processing_res=32, seed=9,
              match_input_res=False)
    ref = jpipe(img, **kw)
    members = []
    ensemble = tbase.ensemble_normals

    def record(normals, **k):
        members.append(normals.clone())
        return ensemble(normals, **k)

    monkeypatch.setattr(tbase, "ensemble_normals", record)
    monkeypatch.setattr(tpipe, "_noise", lambda n, h, w, seed:
                        _jax_noise(9, (n, h, w, 4)))
    got = tpipe(img, **kw)
    assert got.normals_np.shape == (22, 32, 3)
    m = members[0].float()
    mean = m.mean(0, keepdim=True)
    mean = mean / torch.linalg.vector_norm(mean, dim=1, keepdim=True)
    top2 = (m * mean).sum(1).topk(2, dim=0).values  # [2, h, w]
    clear = ((top2[0] - top2[1]) > 1e-4).numpy()
    assert (~clear).sum() <= 2, (~clear).sum()
    np.testing.assert_allclose(got.normals_np[clear], ref.normals_np[clear],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.uncertainty, ref.uncertainty, atol=ATOL,
                               rtol=0)


def test_call_shape_range_and_seed_determinism(pipes):
    _, tpipe = pipes
    img = _image(7, 30, 44)
    a = tpipe(img, denoising_steps=2, seed=1)
    b = tpipe(img, denoising_steps=2, generator=torch.Generator().manual_seed(1))
    c = tpipe(img, denoising_steps=2, seed=2)
    e = tpipe(img, denoising_steps=2, ensemble_size=2, seed=1)
    assert a.normals_np.shape == (30, 44, 3) and a.normals_np.dtype == np.float32
    assert np.isfinite(a.normals_np).all() and np.abs(a.normals_np).max() <= 1.0
    _assert_unit(a.normals_np)
    np.testing.assert_array_equal(a.normals_np, b.normals_np)
    assert not np.array_equal(a.normals_np, c.normals_np)
    assert e.uncertainty.shape == (30, 44)
    with pytest.raises(ValueError):
        tpipe(img, ensemble_size=0)
