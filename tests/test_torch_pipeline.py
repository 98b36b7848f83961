"""The port's depth pipeline as a whole against the JAX package's, on the
tiny checkpoint of tests/fixtures.py (fp32, CPU).

The two frameworks draw different random numbers from one seed, so the
comparisons hand the port the JAX package's own noise (drawn here exactly as
its fused programs draw it) and hold the outputs to atol 1e-4. The host-side
helpers are compared directly; the serving entry points are also checked
for shape, range and determinism per seed."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fixtures import make_tiny_checkpoint
from marigold_tpu.pipelines import base as jbase
from marigold_tpu.pipelines import batchsize as jbs
from marigold_tpu.pipelines import image_util as jiu
from marigold_tpu.pipelines.depth import MarigoldDepthPipeline as JaxDepth
from marigold_tpu_torch import MarigoldDepthPipeline as TorchDepth
from marigold_tpu_torch.pipelines import base as tbase
from marigold_tpu_torch.pipelines import batchsize as tbs
from marigold_tpu_torch.pipelines import image_util as tiu

ATOL = 1e-4


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def pipes(ckpt):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MARIGOLD_TPU_FASTLOAD", "0")  # the per-tensor host loader
        jpipe = JaxDepth.from_pretrained(ckpt, dtype=jnp.float32)
    tpipe = TorchDepth.from_pretrained(ckpt, dtype=torch.float32, device="cpu")
    return jpipe, tpipe


def _image(seed, h=40, w=56):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _jax_noise(seed, shape):
    """The JAX programs' initial noise, NHWC -> the port's NCHW."""
    n = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    return torch.from_numpy(np.ascontiguousarray(
        n.reshape((-1,) + shape[-3:]).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("steps", [1, 4])
def test_core_infer_matches_jax_on_shared_noise(pipes, steps):
    jpipe, tpipe = pipes
    rgb = np.random.default_rng(steps).uniform(-1, 1, (1, 24, 32, 3)).astype(np.float32)
    jlat = np.array(jpipe.core.encode_rgb(jnp.asarray(rgb)))
    tlat = tpipe.core.encode_rgb(torch.from_numpy(rgb).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tlat.permute(0, 2, 3, 1).numpy(), jlat,
                               atol=ATOL, rtol=0)
    noise = np.random.default_rng(10 + steps).standard_normal(
        (2,) + jlat.shape[1:]).astype(np.float32)
    fn = jpipe.core.get_infer_fn(3, 4, steps, 2, "depth")
    ref = np.asarray(fn(jpipe.core.unet_params, jpipe.core.vae_params,
                        jnp.asarray(jlat), jnp.asarray(noise),
                        jpipe.core.empty_text_embed))
    got = tpipe.core.infer(torch.from_numpy(jlat).permute(0, 3, 1, 2),
                           torch.from_numpy(noise).permute(0, 3, 1, 2), steps)
    assert got.shape == (2, 1, 24, 32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=ATOL, rtol=0)


def test_call_matches_jax_on_shared_noise(pipes, monkeypatch):
    """__call__: processing-res resize, /8 pad, encode, 2-step DDIM, decode,
    crop and resize back to the input size."""
    jpipe, tpipe = pipes
    img = _image(0)
    ref = jpipe(img, denoising_steps=2, processing_res=32, seed=7,
                color_map=None).depth_np
    # 40x56 -> 22x32 -> padded 24x32 -> latent 3x4
    monkeypatch.setattr(tpipe, "_noise",
                        lambda n, h, w, seed: _jax_noise(7, (n, h, w, 4)))
    got = tpipe(img, denoising_steps=2, processing_res=32, seed=7,
                color_map=None).depth_np
    assert got.shape == (40, 56)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_batch_call_matches_jax_on_shared_noise(pipes, monkeypatch):
    """batch_call: float path with the on-device resize back."""
    jpipe, tpipe = pipes
    imgs = [_image(1), _image(2)]
    ref = jpipe.batch_call(imgs, denoising_steps=2, processing_res=32, seed=5)
    monkeypatch.setattr(
        tpipe, "_noise", lambda n, h, w, seed: _jax_noise(5, (n, 1, h, w, 4)))
    got = tpipe.batch_call(imgs, denoising_steps=2, processing_res=32, seed=5)
    for r, g in zip(ref, got):
        assert g.depth_np.shape == (40, 56)
        np.testing.assert_allclose(g.depth_np, r.depth_np, atol=ATOL, rtol=0)


def test_call_shape_range_and_seed_determinism(pipes):
    _, tpipe = pipes
    img = _image(3, 30, 44)
    a = tpipe(img, denoising_steps=2, seed=1, color_map="Spectral")
    b = tpipe(img, denoising_steps=2, seed=1, color_map=None)
    c = tpipe(img, denoising_steps=2, seed=2, color_map=None)
    d = tpipe(img, denoising_steps=2,
              generator=torch.Generator().manual_seed(1), color_map=None)
    assert a.depth_np.shape == (30, 44) and a.depth_np.dtype == np.float32
    assert np.isfinite(a.depth_np).all()
    assert a.depth_np.min() >= 0.0 and a.depth_np.max() <= 1.0
    assert np.asarray(a.depth_colored).shape == (30, 44, 3)
    assert a.uncertainty is None
    np.testing.assert_array_equal(a.depth_np, b.depth_np)
    np.testing.assert_array_equal(a.depth_np, d.depth_np)
    assert not np.array_equal(a.depth_np, c.depth_np)


def test_batch_call_uint8_upload_and_compact_readback(pipes):
    _, tpipe = pipes
    imgs = [_image(4), _image(5), _image(6)]
    full = tpipe.batch_call(imgs, denoising_steps=2, processing_res=0, seed=3,
                            batch_size=2)
    again = tpipe.batch_call(imgs, denoising_steps=2, processing_res=0, seed=3)
    compact = tpipe.batch_call(imgs, denoising_steps=2, processing_res=0, seed=3,
                               compact_readback=True)
    assert len(full) == 3
    for f, a, c in zip(full, again, compact):
        assert f.depth_np.shape == (40, 56)
        assert f.depth_np.min() >= 0.0 and f.depth_np.max() <= 1.0
        # chunking the denoise (batch_size=2) changes only the CPU kernels'
        # summation order with the batch size
        np.testing.assert_allclose(f.depth_np, a.depth_np, atol=ATOL, rtol=0)
        # uint16 readback: half a quantization step, plus fp32 rounding
        np.testing.assert_allclose(c.depth_np, a.depth_np, atol=0.5 / 65535 + 1e-7,
                                   rtol=0)


# Ensembles. The tiny random network decodes uncorrelated members, on which
# the alignment is degenerate (the solvers collapse the free scales toward 0
# and land on different, nearly equal costs: tests/test_torch_ensemble.py
# holds the objective there). So both packages get correlated initial noise
# (a shared draw plus an independent one per member), as a trained model's
# members are correlated. The maps then agree to ENS_ATOL: the members to
# ~1e-6, and both device solvers take the same BFGS path up to float32
# rounding, which the renormalization to [0, 1] can stretch.
ENS_ATOL = 1e-3
ENSEMBLE_KWARGS = [None, {"gauge_anchor": False}, {"reg_max_res": 1024}]


def _correlated_noise(shape):
    """Initial noise [..., E, h, w, 4] (NHWC, as JAX draws it)."""
    rng = np.random.default_rng(sum(shape))
    shared = rng.standard_normal((1,) * (len(shape) - 3) + tuple(shape[-3:]))
    return (0.95 * shared + 0.3 * rng.standard_normal(shape)).astype(np.float32)


def _nchw(noise):
    return torch.from_numpy(
        noise.reshape((-1,) + noise.shape[-3:]).transpose(0, 3, 1, 2).copy())


@pytest.fixture
def shared_members(monkeypatch):
    """Correlated noise for both packages. In the reference-exact mode,
    scipy's finite-difference BFGS over an fp32 cost takes a different path
    for members that differ by 1e-7, so there the port's members are first
    held to JAX's at ATOL and then replaced by them: the host solve, the
    resize and the readback are compared on identical members."""
    from marigold_tpu.pipelines import ensemble as jens

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_correlated_noise(tuple(shape)), dtype))
    jax_members = []
    jax_ensemble = jens.ensemble_depth

    def record(depth, **kw):
        if not kw.get("gauge_anchor", True):  # eager; else inside jit
            jax_members.append(np.asarray(depth))
        return jax_ensemble(depth, **kw)

    monkeypatch.setattr(jens, "ensemble_depth", record)
    port_ensemble = tbase.ensemble_depth

    def substitute(depth, **kw):
        if kw.get("gauge_anchor", True):
            return port_ensemble(depth, **kw)
        ref = jax_members.pop(0)
        np.testing.assert_allclose(depth.permute(0, 2, 3, 1).numpy(), ref,
                                   atol=ATOL, rtol=0)
        return port_ensemble(_nchw(ref), **kw)

    monkeypatch.setattr(tbase, "ensemble_depth", substitute)


@pytest.mark.parametrize("ens", ENSEMBLE_KWARGS)
def test_call_ensemble_matches_jax_on_shared_noise(pipes, monkeypatch,
                                                   shared_members, ens):
    """__call__ at E=3: chunked members (batch_size=2), the padding mask
    (or, reference-exact, cropped members), uncertainty resized with the
    prediction."""
    jpipe, tpipe = pipes
    img = _image(7)
    kw = dict(denoising_steps=2, ensemble_size=3, processing_res=32, seed=3,
              color_map=None, ensemble_kwargs=ens)
    ref = jpipe(img, batch_size=2, **kw)
    monkeypatch.setattr(tpipe, "_noise", lambda n, h, w, seed:
                        _nchw(_correlated_noise((n, h, w, 4))))
    got = tpipe(img, batch_size=2, **kw)
    assert got.depth_np.shape == got.uncertainty.shape == (40, 56)
    assert got.uncertainty.min() >= 0.0 and got.uncertainty.max() > 0.0
    np.testing.assert_allclose(got.depth_np, ref.depth_np, atol=ENS_ATOL, rtol=0)
    np.testing.assert_allclose(got.uncertainty, ref.uncertainty,
                               atol=ENS_ATOL, rtol=0)


@pytest.mark.parametrize("ens,compact", [
    (None, False), (None, True), ({"gauge_anchor": False}, True),
    ({"reg_max_res": 1024}, False)])
def test_batch_call_ensemble_matches_jax_on_shared_noise(
        pipes, monkeypatch, shared_members, ens, compact):
    """batch_call at NI=2 x E=3: the rows share the denoise batch, each
    image's cropped members are ensembled, the uncertainty goes through the
    resize and the uint16 readback."""
    jpipe, tpipe = pipes
    imgs = [_image(8), _image(9)]
    kw = dict(denoising_steps=2, ensemble_size=3, processing_res=32, seed=4,
              ensemble_kwargs=ens, compact_readback=compact)
    ref = jpipe.batch_call(imgs, **kw)
    monkeypatch.setattr(tpipe, "_noise", lambda n, h, w, seed:
                        _nchw(_correlated_noise((2, 3, h, w, 4))))
    got = tpipe.batch_call(imgs, **kw)
    for r, g in zip(ref, got):
        assert g.depth_np.shape == g.uncertainty.shape == (40, 56)
        np.testing.assert_allclose(g.depth_np, r.depth_np, atol=ENS_ATOL, rtol=0)
        np.testing.assert_allclose(g.uncertainty, r.uncertainty,
                                   atol=ENS_ATOL, rtol=0)


@pytest.mark.parametrize("ensemble_size,ens", [
    (1, None), (3, None), (3, {"gauge_anchor": False})])
def test_call_shape_bucketing_matches_jax_on_shared_noise(
        pipes, monkeypatch, shared_members, ensemble_size, ens):
    """__call__(shape_bucketing=True) on a 72x100 image at processing_res=0:
    both packages pad to the 64-px grid (128x128), the
    padding mask keeps it out of the E=3 ensemble (or, reference-exact, the
    members are cropped first), and the maps are cropped and held at the
    shared-noise tolerances (ATOL at E=1, ENS_ATOL at E=3)."""
    jpipe, tpipe = pipes
    img = _image(10, 72, 100)
    kw = dict(denoising_steps=2, ensemble_size=ensemble_size, processing_res=0,
              seed=6, color_map=None, ensemble_kwargs=ens, shape_bucketing=True)
    ref = jpipe(img, batch_size=2, **kw)
    shapes = []

    def noise(n, h, w, seed):
        shapes.append((h, w))
        return _nchw(_correlated_noise((n, h, w, 4)))

    monkeypatch.setattr(tpipe, "_noise", noise)
    got = tpipe(img, batch_size=2, **kw)
    ds = tpipe.core.vae_cfg.downscale_factor
    assert shapes == [(128 // ds, 128 // ds)]
    assert got.depth_np.shape == (72, 100)
    atol = ATOL if ensemble_size == 1 else ENS_ATOL
    np.testing.assert_allclose(got.depth_np, ref.depth_np, atol=atol, rtol=0)
    if ensemble_size == 1:
        assert got.uncertainty is None and ref.uncertainty is None
    else:
        np.testing.assert_allclose(got.uncertainty, ref.uncertainty,
                                   atol=atol, rtol=0)


def test_call_takes_the_jax_keywords(pipes):
    """show_progress_bar is accepted and changes nothing (the JAX __call__
    takes it and passes it nowhere); spatial=False is accepted and
    spatial=True, the mesh-sharded mode, raises without a mesh, as the JAX
    __call__ does."""
    _, tpipe = pipes
    img = _image(11, 30, 44)
    kw = dict(denoising_steps=1, seed=2, color_map=None)
    a = tpipe(img, show_progress_bar=False, spatial=False, **kw)
    b = tpipe(img, show_progress_bar=True, **kw)
    np.testing.assert_array_equal(a.depth_np, b.depth_np)
    with pytest.raises(ValueError, match="needs a pipeline built with a mesh"):
        tpipe(img, spatial=True, **kw)


def test_from_pretrained_needs_a_device_or_the_cpu(ckpt):
    """No silent CPU fallback: without a CUDA device the caller must pass
    device="cpu", and batch sizing without a device raises too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDepth.from_pretrained(ckpt, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbs.find_batch_size(10, 768)


def test_lcm_checkpoint_loads_as_lcm(pipes, ckpt, tmp_path):
    """A checkpoint whose scheduler config names LCMScheduler loads with
    core.lcm set (original_inference_steps from the config, the base schedule
    from the same config), as the JAX package's loader builds it."""
    from marigold_tpu.pipelines.base import load_pipeline_components as jload

    lcm = tmp_path / "lcm"
    lcm.mkdir()
    for sub in ("unet", "vae", "text_encoder"):
        os.symlink(os.path.join(ckpt, sub), lcm / sub)
    cfg = tbase.W.read_config(os.path.join(ckpt, "scheduler"),
                              "scheduler_config.json")
    cfg.update(_class_name="LCMScheduler", original_inference_steps=40)
    tbase.W.write_config(cfg, str(lcm / "scheduler"), "scheduler_config.json")
    pipe = TorchDepth.from_pretrained(str(lcm), dtype=torch.float32, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MARIGOLD_TPU_FASTLOAD", "0")
        jcore, _ = jload(str(lcm), dtype=jnp.float32)
    assert pipe.core.lcm.original_inference_steps == 40
    assert jcore.lcm.original_inference_steps == 40
    np.testing.assert_array_equal(pipe.core.lcm.inference_timesteps(4),
                                  jcore.lcm.inference_timesteps(4))
    np.testing.assert_array_equal(pipe.core.lcm.base.alphas_cumprod,
                                  jcore.lcm.base.alphas_cumprod)
    assert pipes[1].core.lcm is None


# ------------------------------------------------------------------ #
# host-side helpers


@pytest.mark.parametrize("kind", ["uint8", "float01", "float255", "gray", "chw"])
def test_image_to_array_matches_jax(kind):
    rng = np.random.default_rng(0)
    img = {
        "uint8": rng.integers(0, 256, (6, 5, 3), dtype=np.uint8),
        "float01": rng.random((6, 5, 3)).astype(np.float32),
        "float255": (rng.random((6, 5, 3)) * 255).astype(np.float32),
        "gray": rng.integers(0, 256, (6, 5), dtype=np.uint8),
        "chw": rng.random((3, 6, 5)).astype(np.float32),
    }[kind]
    np.testing.assert_array_equal(tbase.image_to_array(img), jbase.image_to_array(img))


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("src,dst", [((40, 56), (22, 32)), ((22, 32), (40, 57)),
                                     ((30, 30), (30, 17))])
def test_resize_np_matches_jax(src, dst, method):
    img = np.random.default_rng(1).uniform(-1, 1, src + (3,)).astype(np.float32)
    ref = jiu.resize_np(img, dst, method)
    got = tiu.resize_np(img, dst, method)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    dev = tiu.resize_torch(torch.from_numpy(img).permute(2, 0, 1)[None], dst, method)
    np.testing.assert_allclose(dev[0].permute(1, 2, 0).numpy(), got, atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("dst", [(17, 23), (50, 70)])
def test_resize_host_matches_jax(dst, method):
    img = np.random.default_rng(2).random((24, 32, 1)).astype(np.float32)
    np.testing.assert_allclose(tiu.resize_host(img, dst, method),
                               jiu.resize_host(img, dst, method), atol=1e-6, rtol=0)


def test_shapes_padding_and_sizing_match_jax():
    for h, w, m in [(480, 640, 768), (375, 1242, 768), (768, 768, 768), (7, 3, 32)]:
        assert tiu.resize_max_res_shape(h, w, m) == jiu.resize_max_res_shape(h, w, m)
    x = np.random.default_rng(3).random((2, 13, 9, 3)).astype(np.float32)
    for mult in (8, 64):
        got, ref = tbase.pad_to_multiple_of(x, mult), jbase.pad_to_multiple_of(x, mult)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]
    for total, hw in [(1, (768, 768)), (30, (768, 768)), (7, (1536, 1536))]:
        assert tbase.DiffusionCore.decode_chunking(total, hw) == \
            jbase.DiffusionCore.decode_chunking(total, hw, "depth", 1)
    # normals decode one image per row; IID n_targets per row (the cap
    # counts decoded images)
    for total, hw, mode, n in [(30, (768, 768), "normals", 1),
                               (10, (768, 768), "normals", 1),
                               (16, (640, 640), "iid", 2),
                               (16, (640, 640), "iid", 3),
                               (24, (640, 640), "iid", 3),
                               (1, (768, 768), "iid", 3),
                               (7, (1536, 1536), "iid", 2)]:
        assert tbase.DiffusionCore.decode_chunking(
            total, hw, mode=mode, n_targets=n) == \
            jbase.DiffusionCore.decode_chunking(total, hw, mode, n)
    # a CPU device reports no memory limit to either package: both budget
    # their 16 GiB default
    for e, res in [(1, 768), (10, 768), (30, 512)]:
        assert tbs.find_batch_size(e, res, device="cpu") == \
            jbs.find_batch_size(e, res, device=jax.devices("cpu")[0])


def test_import_pulls_in_no_jax():
    code = ("import sys, marigold_tpu_torch, marigold_tpu_torch.ops.conv, "
            "marigold_tpu_torch.ops.winograd, "
            "marigold_tpu_torch.pipelines.ensemble, "
            "marigold_tpu_torch.pipelines.normals, "
            "marigold_tpu_torch.pipelines.iid, marigold_tpu_torch.core.lcm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'marigold_tpu')]; print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert res.returncode == 0, res.stdout + res.stderr
