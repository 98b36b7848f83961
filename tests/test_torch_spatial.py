"""Spatial parallelism in the port, one image's H rows over 2 gloo ranks,
against the JAX package's spatial path on a 2-device mesh (fp32, CPU):
gather-KV attention, the UNet forward (halo convs, all-reduced GroupNorm,
gathered K/V at every level), the VAE encode and decode, and
`__call__(spatial=True)` for depth and normals.

As in tests/test_torch_parallel.py the ranks are spawned processes that
import this module (and that one) to find their functions, so JAX is
imported only inside the tests. The halo rows reproduce the zero padding
only where the edges meet, so every check compares whole maps. One spawn
of two ranks runs every rank-side case of the module."""

import os

import numpy as np
import pytest
import torch

from marigold_tpu_torch.models import weights as W
from marigold_tpu_torch.parallel import mesh as M
from test_torch_parallel import jax_noise, serve_cases, write_port_ckpt

torch.set_num_threads(1)  # as the other model test modules do

ATTN_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_mesh.py:275
UNET_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_mesh.py:335
PIPE_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_mesh.py:380, 422
# the port's sharded VAE against its unsharded one: fp32 sums reassociated
VAE_TOL = dict(atol=1e-5, rtol=1e-4)

HEADS = 4
UNET_X = (1, 8, 32, 24)  # NCHW: H 32 = 2 ranks x 16 rows; 4 rows at level 3
VAE_X = (1, 3, 32, 24)   # three VAE blocks: two asymmetric-pad downsamples


def unet_config():
    """The JAX spatial test's UNet (tests/test_mesh.py:302-310)."""
    from marigold_tpu_torch.models.unet import UNetConfig

    return UNetConfig(sample_size=32, in_channels=8, out_channels=4,
                      block_out_channels=(32, 32, 32, 32),
                      attention_head_dim=(2, 2, 2, 2), cross_attention_dim=16,
                      norm_num_groups=4)


def vae_config():
    from marigold_tpu_torch.models.vae import VAEConfig

    return VAEConfig(block_out_channels=(8, 16, 16), layers_per_block=1,
                     latent_channels=4, norm_num_groups=4)


def write_model(path: str, cls, cfg, seed: int) -> str:
    with torch.device("meta"):
        model = cls(cfg)
    W.save_component(cfg.to_dict(),
                     W.random_state_dict(model, torch.Generator().manual_seed(seed)),
                     path, "diffusion_pytorch_model.safetensors")
    return path


def rank_work(mesh, inputs: dict) -> dict:
    """Every rank-side case of the module in one rank."""
    from marigold_tpu_torch.ops.sharded_attention import spatial_sharded_attention
    from marigold_tpu_torch.parallel.spatial import spatial_unet_apply

    out = {}
    q, k, v = (torch.from_numpy(a) for a in inputs["qkv"])
    with torch.no_grad():
        out["attn_plain"] = spatial_sharded_attention(q, k, v, HEADS, mesh,
                                                      use_flash=False)
        out["attn_flash"] = spatial_sharded_attention(q, k, v, HEADS, mesh)
    unet = W.load_unet(inputs["unet"], torch.float32, "cpu")
    x, ctx = (torch.from_numpy(a) for a in inputs["unet_x"])
    out["unet"] = spatial_unet_apply(unet, x, 3, ctx, mesh)
    vae = W.load_vae(inputs["vae"], torch.float32, "cpu")
    img, lat = (torch.from_numpy(a) for a in inputs["vae_x"])
    with torch.no_grad():
        enc = vae.encode_mean_scaled(img[:, :, mesh.rows(img.shape[2])], mesh)
        dec = vae.decode_scaled(lat[:, :, mesh.rows(lat.shape[2])], mesh)
    out["encode"] = mesh.all_gather(enc, 2)
    out["decode"] = mesh.all_gather(dec, 2)
    out["pipe"] = serve_cases(mesh, inputs["ckpts"], inputs["cases"])
    return out


SPATIAL_CASES = [  # name, mode, image (H, W), E, seed, ensemble_kwargs
    # H 60 pads to 64 (the 8-px grid of 2 ranks), W 56 stays
    ("depth_pad_e2", "depth", (60, 56), 2, 3,
     dict(scale_invariant=False, shift_invariant=False)),
    # "mean": "closest" flips between equal-up-to-rounding members
    # (tests/test_mesh.py:399-402)
    ("normals_pad_e2", "normals", (60, 56), 2, 9, dict(reduction="mean")),
]
# on the grid, E=1: rows sharded against members sharded, in the port alone
ALIGNED = ("depth_e1", "depth", (64, 48), 1, 7, None)


def _image(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), dtype=np.uint8)


def _call_kw(e, seed, ens):
    return dict(denoising_steps=2, ensemble_size=e, processing_res=0, seed=seed,
                ensemble_kwargs=ens)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("spatial")
    from marigold_tpu_torch.models.unet import UNet2DConditionModel
    from marigold_tpu_torch.models.vae import AutoencoderKL

    inputs = {
        "qkv": [rng.standard_normal((2, 1024, 64)).astype(np.float32)
                for _ in range(3)],
        "unet": write_model(str(root / "unet"), UNet2DConditionModel,
                            unet_config(), 1),
        "unet_x": [rng.standard_normal(UNET_X).astype(np.float32),
                   rng.standard_normal((1, 2, 16)).astype(np.float32)],
        "vae": write_model(str(root / "vae"), AutoencoderKL, vae_config(), 2),
        "vae_x": [rng.uniform(-1, 1, VAE_X).astype(np.float32),
                  rng.standard_normal((1, 4, 8, 6)).astype(np.float32)],
        "ckpts": {mode: write_port_ckpt(str(root / mode), mode)
                  for mode in ("depth", "normals")},
    }
    cases = []
    for name, mode, hw, e, seed, ens in SPATIAL_CASES + [ALIGNED]:
        hp = -(-hw[0] // 8) * 8
        noise = jax_noise(seed, (e, hp // 2, hw[1] // 2, 4))
        kw = _call_kw(e, seed, ens)
        cases.append((name, mode, _image(hw, seed), noise,
                      dict(kw, spatial=True, color_map=None)
                      if mode == "depth" else dict(kw, spatial=True)))
    # the grid-aligned case with the members sharded instead of the rows
    name, mode, hw, e, seed, ens = ALIGNED
    cases.append(("depth_e1_sharded", mode, _image(hw, seed), cases[-1][3],
                  dict(_call_kw(e, seed, ens), color_map=None)))
    inputs["cases"] = cases
    ranks = M.run_on_ranks(rank_work, 2, (inputs,),
                                store_dir=str(tmp_path_factory.mktemp("store")))
    return inputs, ranks


def _jax_mesh():
    from marigold_tpu.parallel.mesh import get_mesh

    return get_mesh(2)


def _both_ranks(ranks, key):
    a, b = (r[key] for r in ranks)
    assert torch.equal(a, b), key  # every rank returns the same tensor
    return a.numpy()


def test_sharded_attention_matches_jax(setup):
    import jax.numpy as jnp

    from marigold_tpu.ops.sharded_attention import spatial_sharded_attention

    inputs, ranks = setup
    ref = np.asarray(spatial_sharded_attention(
        *(jnp.asarray(a) for a in inputs["qkv"]), HEADS, _jax_mesh(),
        use_flash=False))
    for key in ("attn_plain", "attn_flash"):
        np.testing.assert_allclose(_both_ranks(ranks, key), ref, **ATTN_TOL)


def test_sharded_attention_rejects_an_indivisible_token_count():
    from marigold_tpu_torch.ops.sharded_attention import spatial_sharded_attention

    two = M.Mesh(0, 2, torch.device("cpu"))  # raises before any collective
    q = torch.zeros(1, 101, 16)
    with pytest.raises(ValueError, match="must divide"):
        spatial_sharded_attention(q, q, q, 2, two, use_flash=False)


def test_spatial_unet_matches_jax(setup):
    import jax.numpy as jnp

    from marigold_tpu.models import weights as JW
    from marigold_tpu.parallel.spatial import spatial_unet_apply

    inputs, ranks = setup
    cfg, params = JW.load_unet(inputs["unet"], jnp.float32)
    x, ctx = inputs["unet_x"]
    ref = np.asarray(spatial_unet_apply(
        params, cfg, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(3),
        jnp.asarray(ctx), _jax_mesh()))
    got = _both_ranks(ranks, "unet")
    assert got.shape == UNET_X[:1] + (4,) + UNET_X[2:]
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, **UNET_TOL)


def test_spatial_unet_rejects_an_indivisible_height(setup):
    from marigold_tpu_torch.parallel.spatial import spatial_unet_apply

    inputs, _ = setup
    unet = W.load_unet(inputs["unet"], torch.float32, "cpu")
    two = M.Mesh(0, 2, torch.device("cpu"))
    x = torch.zeros(1, 8, 40, 24)  # 40 % (8 x 2) != 0
    with pytest.raises(ValueError, match="divisible by 16"):
        spatial_unet_apply(unet, x, 0, torch.zeros(1, 2, 16), two)


@pytest.mark.parametrize("what", ["encode", "decode"])
def test_spatial_vae_matches_the_unsharded_one(setup, what):
    inputs, ranks = setup
    vae = W.load_vae(inputs["vae"], torch.float32, "cpu")
    img, lat = (torch.from_numpy(a) for a in inputs["vae_x"])
    with torch.no_grad():
        ref = (vae.encode_mean_scaled(img) if what == "encode"
               else vae.decode_scaled(lat)).numpy()
    got = _both_ranks(ranks, what)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **VAE_TOL)


@pytest.mark.parametrize("case", SPATIAL_CASES, ids=[c[0] for c in SPATIAL_CASES])
def test_spatial_call_matches_jax(setup, case):
    """__call__(spatial=True) on 2 ranks against the JAX pipeline's on a
    2-device mesh, on the JAX noise; H padded to the 8-px grid where the
    image is off it, the padding masked out of the ensemble and cropped."""
    import jax.numpy as jnp

    from marigold_tpu import MarigoldDepthPipeline, MarigoldNormalsPipeline

    inputs, ranks = setup
    name, mode, hw, e, seed, ens = case
    cls = MarigoldDepthPipeline if mode == "depth" else MarigoldNormalsPipeline
    jpipe = cls.from_pretrained(inputs["ckpts"][mode], dtype=jnp.float32,
                                mesh=_jax_mesh())
    kw = dict(_call_kw(e, seed, ens), spatial=True, show_progress_bar=False)
    if mode == "depth":
        res = jpipe(_image(hw, seed), color_map=None, **kw)
        ref = (res.depth_np, res.uncertainty)
    else:
        res = jpipe(_image(hw, seed), **kw)
        ref = (res.normals_np, res.uncertainty)
    r0, r1 = (r["pipe"][name] for r in ranks)
    for a, b in zip(r0, r1):
        np.testing.assert_array_equal(a, b)
    assert r0[0].shape[:2] == hw
    np.testing.assert_allclose(r0[0], ref[0], **PIPE_TOL)
    if e > 1:
        np.testing.assert_allclose(r0[1], ref[1], **PIPE_TOL)
    else:
        assert r0[1] is None and ref[1] is None
    if mode == "normals":
        np.testing.assert_allclose(np.linalg.norm(r0[0], axis=-1), 1.0, atol=1e-3)


def test_spatial_equals_the_member_sharded_call(setup):
    """On the 8-px grid with no padding the rows sharded and the members
    sharded give one map (fp32 sums reassociated)."""
    _, ranks = setup
    pipe = ranks[0]["pipe"]
    assert pipe["depth_e1"][0].shape == ALIGNED[2]
    assert pipe["depth_e1"][1] is None
    np.testing.assert_allclose(pipe["depth_e1"][0], pipe["depth_e1_sharded"][0],
                               **PIPE_TOL)


def test_spatial_needs_a_mesh_and_no_lcm(setup):
    from marigold_tpu_torch import MarigoldDepthPipeline, MarigoldNormalsPipeline
    from marigold_tpu_torch.core.lcm import LCMSchedule

    inputs, _ = setup
    img = _image((64, 48), 0)
    pipe = MarigoldNormalsPipeline.from_pretrained(
        inputs["ckpts"]["normals"], dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        pipe(img, spatial=True, processing_res=0, denoising_steps=1)
    one = M.Mesh(0, 1, torch.device("cpu"))
    pipe = MarigoldDepthPipeline.from_pretrained(
        inputs["ckpts"]["depth"], dtype=torch.float32, mesh=one)
    pipe.core.lcm = LCMSchedule.create(base=pipe.core.schedule,
                                       original_inference_steps=50)
    with pytest.raises(ValueError, match="does not support LCM"):
        pipe(img, spatial=True, processing_res=0, denoising_steps=1,
             color_map=None)
    assert os.path.isdir(inputs["ckpts"]["depth"])
