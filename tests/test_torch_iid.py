"""The port's IID pipeline against the JAX package's, on the tiny
IID-appearance (albedo + material, 2 targets) and IID-lighting (albedo +
shading + residual, 3 targets) checkpoints of tests/fixtures.py (fp32, CPU).

The pipeline comparisons hand the port the JAX package's own initial noise
(drawn here as its programs draw it). Tolerances: ATOL = 1e-4 on maps and
uncertainties (fp32 through the UNet, each target's VAE decode and the
resizes); `ensemble_iid` and `fill_entry` agree to fp32 rounding (1e-6)
and the entry images bit for bit."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fixtures import make_tiny_checkpoint
from marigold_tpu.pipelines import ensemble as jens
from marigold_tpu.pipelines import iid as jiid
from marigold_tpu.pipelines.iid import MarigoldIIDPipeline as JaxIID
from marigold_tpu_torch import MarigoldIIDPipeline as TorchIID
from marigold_tpu_torch import MarigoldNormalsPipeline as TorchNormals
from marigold_tpu_torch.pipelines import ensemble as tens
from marigold_tpu_torch.pipelines import iid as tiid

ATOL = 1e-4
VARIANTS = {"appearance": ["albedo", "material"],
            "lighting": ["albedo", "shading", "residual"]}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return {v: make_tiny_checkpoint(str(tmp_path_factory.mktemp(v)), mode="iid",
                                    iid_variant=v) for v in VARIANTS}


@pytest.fixture(scope="module")
def pipes(ckpts):
    out = {}
    for v, ckpt in ckpts.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MARIGOLD_TPU_FASTLOAD", "0")  # the per-tensor host loader
            jpipe = JaxIID.from_pretrained(ckpt, dtype=jnp.float32)
        out[v] = (jpipe, TorchIID.from_pretrained(ckpt, dtype=torch.float32,
                                                  device="cpu"))
    return out


def _image(seed, h=40, w=56):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _jax_noise(seed, shape):
    """The JAX programs' initial noise, NHWC -> the port's NCHW rows."""
    n = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    return torch.from_numpy(np.ascontiguousarray(
        n.reshape((-1,) + shape[-3:]).transpose(0, 3, 1, 2)))


def _assert_entries_match(got, ref, names, ensemble):
    assert [e.name for e in got] == names and got.is_complete
    for name in names:
        g, r = got[name], ref[name]
        assert g.array.shape == (3, 40, 56)
        assert 0.0 <= g.array.min() and g.array.max() <= 1.0
        np.testing.assert_allclose(g.array, r.array, atol=ATOL, rtol=0)
        assert np.asarray(g.image).shape == (40, 56, 3)
        if ensemble:
            np.testing.assert_allclose(g.uncertainty, r.uncertainty, atol=ATOL,
                                       rtol=0)
        else:
            assert g.uncertainty is None and r.uncertainty is None


@pytest.mark.parametrize("reduction", ["median", "mean"])
def test_ensemble_iid_matches_jax(reduction):
    x = np.random.default_rng(0).random((4, 7, 9, 6)).astype(np.float32)
    ref, ref_unc = jens.ensemble_iid(jnp.asarray(x), True, reduction)
    got, got_unc = tens.ensemble_iid(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     True, reduction)
    assert got.shape == got_unc.shape == (1, 6, 7, 9)
    for g, r in ((got, ref), (got_unc, ref_unc)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   atol=1e-6, rtol=0)
    assert tens.ensemble_iid(torch.from_numpy(x), False)[1] is None


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_call_matches_jax_on_shared_noise(pipes, monkeypatch, variant):
    """E=1 __call__: 4n-channel noise, one VAE decode per target group, the
    host resize back to 40x56, 3 channels per target into the entries."""
    jpipe, tpipe = pipes[variant]
    n = len(VARIANTS[variant])
    img = _image(0)
    ref = jpipe(img, denoising_steps=2, processing_res=32, seed=7)
    monkeypatch.setattr(tpipe, "_noise", lambda k, h, w, seed:
                        _jax_noise(7, (k, h, w, 4 * n)))
    got = tpipe(img, denoising_steps=2, processing_res=32, seed=7)
    _assert_entries_match(got, ref, VARIANTS[variant], ensemble=False)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_batch_call_matches_jax_on_shared_noise(pipes, monkeypatch, variant):
    """E=1 batch_call of two images: decode chunks, the on-device resize
    back."""
    jpipe, tpipe = pipes[variant]
    n = len(VARIANTS[variant])
    imgs = [_image(1), _image(2)]
    ref = jpipe.batch_call(imgs, denoising_steps=2, processing_res=32, seed=5)
    monkeypatch.setattr(tpipe, "_noise", lambda k, h, w, seed:
                        _jax_noise(5, (k, 1, h, w, 4 * n)))
    got = tpipe.batch_call(imgs, denoising_steps=2, processing_res=32, seed=5)
    for g, r in zip(got, ref):
        _assert_entries_match(g, r, VARIANTS[variant], ensemble=False)


@pytest.mark.parametrize("entry", ["call", "batch_call"])
def test_ensemble_matches_jax_on_shared_noise(pipes, monkeypatch, entry):
    """E=3 on the lighting checkpoint, median/MAD per channel, the
    uncertainty resized with the prediction and sliced per target."""
    jpipe, tpipe = pipes["lighting"]
    kw = dict(denoising_steps=2, ensemble_size=3, processing_res=32, seed=3)
    if entry == "call":
        ref = [jpipe(_image(3), batch_size=2, **kw)]
        monkeypatch.setattr(tpipe, "_noise", lambda k, h, w, seed:
                            _jax_noise(3, (k, h, w, 12)))
        got = [tpipe(_image(3), batch_size=2, **kw)]
    else:
        imgs = [_image(4), _image(5)]
        ref = jpipe.batch_call(imgs, compact_readback=True, **kw)
        monkeypatch.setattr(tpipe, "_noise", lambda k, h, w, seed:
                            _jax_noise(3, (2, 3, h, w, 12)))
        got = tpipe.batch_call(imgs, compact_readback=True, **kw)
    for g, r in zip(got, ref):
        _assert_entries_match(g, r, VARIANTS["lighting"], ensemble=True)
        assert g["shading"].uncertainty.shape == (3, 40, 56)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_noise_has_four_channels_per_target(pipes, variant):
    _, tpipe = pipes[variant]
    n = len(VARIANTS[variant])
    assert tpipe.n_targets == n
    assert tpipe._noise(2, 3, 5, 0).shape == (2, 4 * n, 3, 5)
    assert tpipe.core.unet_cfg.in_channels == 4 * (n + 1)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fill_entry_matches_jax(ckpts, variant):
    """srgb (as is), linear with up_to_scale (divided by the max, then
    gamma 1/2.2) and stack targets: arrays, images and uncertainties."""
    import json

    with open(os.path.join(ckpts[variant], "model_index.json")) as f:
        props = json.load(f)["target_properties"]
    names = props["target_names"]
    rng = np.random.default_rng(1)
    got, ref = tiid.MarigoldIIDOutput(names), jiid.MarigoldIIDOutput(names)
    for name in names:
        pred = (0.8 * rng.random((3, 6, 5))).astype(np.float32)
        unc = rng.random((3, 6, 5)).astype(np.float32)
        got.fill_entry(name, pred, unc, props)
        ref.fill_entry(name, pred, unc, props)
        np.testing.assert_allclose(got[name].array, ref[name].array, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(got[name].image),
                                      np.asarray(ref[name].image))
        np.testing.assert_array_equal(got[name].uncertainty, ref[name].uncertainty)
    assert got.is_complete
    with pytest.raises(RuntimeError, match="already filled"):
        got.fill_entry(names[0], pred)
    with pytest.raises(KeyError):
        got.fill_entry("depth", pred)


def test_target_names_from_out_channels(pipes):
    """Without target_properties in model_index.json the names come from the
    UNet's out_channels / 4, as in the JAX package; a count that disagrees
    with the UNet raises."""
    for variant, (jpipe, tpipe) in pipes.items():
        got = TorchIID(tpipe.core, {}).target_names
        assert got == JaxIID(jpipe.core, {}).target_names
        assert got == [f"target_{i}" for i in range(len(VARIANTS[variant]))]
    with pytest.raises(ValueError, match="out_channels"):
        TorchIID(pipes["lighting"][1].core,
                 {"target_properties": {"target_names": ["albedo"]}})


def test_call_shape_range_and_seed_determinism(pipes):
    _, tpipe = pipes["appearance"]
    img = _image(6, 30, 44)
    a = tpipe(img, denoising_steps=2, seed=1)
    b = tpipe(img, denoising_steps=2, generator=torch.Generator().manual_seed(1))
    c = tpipe(img, denoising_steps=2, seed=2)
    for name in VARIANTS["appearance"]:
        assert a[name].array.shape == (3, 30, 44)
        assert np.isfinite(a[name].array).all()
        assert 0.0 <= a[name].array.min() and a[name].array.max() <= 1.0
        np.testing.assert_array_equal(a[name].array, b[name].array)
    assert not np.array_equal(a["albedo"].array, c["albedo"].array)


@pytest.mark.parametrize("cls", [TorchIID, TorchNormals])
def test_from_pretrained_needs_a_device_or_the_cpu(ckpts, cls):
    """No silent CPU fallback for the new pipelines either."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls.from_pretrained(ckpts["appearance"], dtype=torch.float32)
