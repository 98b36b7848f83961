"""The port's device mesh on torch.distributed and the ensemble members
sharded over it, against the JAX package's 2-device mesh (fp32, CPU).

The port's ranks are processes: `parallel.mesh.run_on_ranks` spawns
them on the CPU, a gloo group meeting through a FileStore in the test's
tmp_path. Each spawned rank imports this module to find its function, so
the module imports JAX and the JAX package only inside the tests and
fixtures, never at the top: a rank runs the port alone. The JAX side runs
on the conftest's virtual CPU devices. Both packages load one tiny
checkpoint, written with the port's random weights, and the port is handed
the JAX programs' own noise."""

import json
import os

import numpy as np
import pytest
import torch

from marigold_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)  # as the other model test modules do

ATOL = 2e-3  # tests/test_mesh.py:61, the JAX package's sharded-vs-single bound
# invariances off: the BFGS alignment amplifies reduction-order differences
# between uncorrelated tiny-model members (tests/test_mesh.py:44-47)
CALL_KW = dict(denoising_steps=2, processing_res=32, color_map=None,
               ensemble_kwargs=dict(scale_invariant=False,
                                    shift_invariant=False))


def write_port_ckpt(root: str, mode: str = "depth", seed: int = 0) -> str:
    """The fixtures' tiny depth or normals checkpoint (tests/fixtures.py),
    its weights drawn by the port (`weights.random_state_dict`) so that no
    JAX init runs, in diffusers layout."""
    from fixtures import TINY_CLIP, TINY_VAE, tiny_unet_config

    from marigold_tpu_torch.core.scheduler import DiffusionSchedule
    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
    from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    gen = torch.Generator().manual_seed(seed)
    parts = [
        ("unet", UNet2DConditionModel,
         UNetConfig.from_dict(tiny_unet_config().to_dict()),
         "diffusion_pytorch_model.safetensors", ""),
        ("vae", AutoencoderKL, VAEConfig.from_dict(TINY_VAE.to_dict()),
         "diffusion_pytorch_model.safetensors", ""),
        ("text_encoder", CLIPTextModel,
         CLIPTextConfig.from_dict(TINY_CLIP.to_dict()), "model.safetensors",
         "text_model."),
    ]
    for sub, cls, cfg, fname, prefix in parts:
        with torch.device("meta"):
            model = cls(cfg)
        W.save_component(cfg.to_dict(), W.random_state_dict(model, gen),
                         os.path.join(root, sub), fname, prefix)
    DiffusionSchedule.create().save_pretrained(os.path.join(root, "scheduler"))
    index = {"_class_name": {"depth": "MarigoldDepthPipeline",
                             "normals": "MarigoldNormalsPipeline"}[mode],
             "default_denoising_steps": 1 if mode == "depth" else 4,
             "default_processing_resolution": 32}
    if mode == "depth":
        index.update(scale_invariant=True, shift_invariant=True)
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump(index, f)
    return root


def jax_noise(seed: int, shape: tuple) -> np.ndarray:
    """The JAX programs' initial noise [E, h, w, C] as the port's NCHW."""
    import jax
    import jax.numpy as jnp

    n = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                     jnp.float32))
    return np.ascontiguousarray(n.transpose(0, 3, 1, 2))


def serve_cases(mesh, ckpt: str, cases: list, with_mesh: bool = True) -> dict:
    """In each rank: the pipelines of `ckpt` built with the mesh (without
    one when with_mesh is False) on the CPU, then each case (name, mode,
    image, noise NCHW or None, __call__ keywords) with `_noise` handing the
    port that noise -> {name: (map, uncertainty)}."""
    from marigold_tpu_torch import MarigoldDepthPipeline, MarigoldNormalsPipeline

    classes = {"depth": MarigoldDepthPipeline, "lcm": MarigoldDepthPipeline,
               "normals": MarigoldNormalsPipeline}
    pipes, out = {}, {}
    for name, mode, image, noise, kw in cases:
        if mode not in pipes:
            pipes[mode] = classes[mode].from_pretrained(
                ckpt[mode], dtype=torch.float32, device="cpu",
                mesh=mesh if with_mesh else None)
        pipe = pipes[mode]
        if noise is not None:
            def fixed(n, h, w, seed, _z=noise):
                assert (n, h, w) == (_z.shape[0],) + _z.shape[2:], (n, h, w)
                return torch.from_numpy(_z)
            pipe._noise = fixed
        res = pipe(image, **kw)
        arr = res.normals_np if mode == "normals" else res.depth_np
        out[name] = (arr, res.uncertainty)
    return out


def serve_with_and_without_mesh(mesh, ckpt: str, cases: list) -> tuple:
    return (serve_cases(mesh, ckpt, cases),
            serve_cases(mesh, ckpt, cases, with_mesh=False))


def mesh_checks(mesh) -> dict:
    """The mesh helpers in each rank of a 2-rank group."""
    out = {"rank": mesh.rank, "shape": mesh.shape, "axis_names": mesh.axis_names}
    with pytest.raises(RuntimeError, match="only 2 rank"):
        M.get_mesh(3, device="cpu")
    batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "y": [torch.arange(4.0)]}
    out["shard"] = M.shard_batch(mesh, batch)
    out["spec"] = M.data_parallel_sharding(mesh, 3)
    with pytest.raises(ValueError, match="do not split"):
        M.shard_batch(mesh, np.zeros((3, 2)))
    torch.manual_seed(mesh.rank)  # rank-dependent weights before replicate
    lin = torch.nn.Linear(3, 2)
    lin.register_buffer("stat", torch.full((2,), float(mesh.rank)))
    M.replicate(mesh, lin)
    out["replicated"] = {k: v.clone() for k, v in lin.state_dict().items()}
    local = np.full((2, 3), 10.0 * mesh.rank, np.float32)
    glob = M.global_batch_from_local(mesh, local)
    out["local"] = glob
    out["gathered"] = mesh.all_gather(glob, 0)
    out["reduced"] = mesh.all_reduce(torch.full((2,), mesh.rank + 1.0))
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(1, 2, 3, 4)
    out["halo"] = mesh.halo_rows(x + 100 * mesh.rank)
    return out


# the LCM depth checkpoint's scheduler (chip_smoke.py:LCM_SCHEDULER)
LCM_SCHEDULER = {"_class_name": "LCMScheduler", "num_train_timesteps": 1000,
                 "beta_start": 0.00085, "beta_end": 0.012,
                 "beta_schedule": "scaled_linear", "prediction_type": "epsilon",
                 "timestep_spacing": "leading", "steps_offset": 1,
                 "rescale_betas_zero_snr": False, "set_alpha_to_one": True,
                 "original_inference_steps": 50}


def fails_on_rank_1(mesh, how: str):
    if mesh.rank == 1:
        if how == "raise":
            raise ValueError("rank 1 gives up")
        os._exit(3)  # dies without a word
    return mesh.all_reduce(torch.ones(1))  # rank 0 waits for rank 1


@pytest.mark.parametrize("how,match", [
    ("raise", "(?s)rank 1:.*rank 1 gives up"),
    ("exit", r"ranks \[1\] exited with codes \[3\]")])
def test_a_failed_rank_fails_the_call_at_once(tmp_path, how, match):
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        M.run_on_ranks(fails_on_rank_1, 2, (how,), store_dir=str(tmp_path),
                       timeout_s=300)
    assert time.monotonic() - t0 < 60  # not the timeout


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {mode: write_port_ckpt(str(tmp_path_factory.mktemp(mode)), mode)
           for mode in ("depth", "normals")}
    out["lcm"] = write_port_ckpt(str(tmp_path_factory.mktemp("lcm")), "depth")
    with open(os.path.join(out["lcm"], "scheduler",
                           "scheduler_config.json"), "w") as f:
        json.dump(LCM_SCHEDULER, f)
    return out


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).integers(0, 256, (40, 48, 3), dtype=np.uint8)


def _latent_hw(image, processing_res=32, ds=2):
    """(h, w) of the latent the pipelines give `image` at processing_res
    (the tiny VAE downscales by 2)."""
    from marigold_tpu_torch.pipelines.image_util import resize_max_res_shape

    h, w = resize_max_res_shape(*image.shape[:2], processing_res)
    return -(-h // ds), -(-w // ds)


# E=4 divides the two ranks; E=3 pads one member, dropped after the gather
SHARDED = [("e4", 4, 5), ("e3", 3, 6)]


@pytest.fixture(scope="module")
def sharded_runs(ckpts, image, tmp_path_factory):
    h, w = _latent_hw(image)
    cases = [(name, "depth", image, jax_noise(seed, (e, h, w, 4)),
              dict(CALL_KW, ensemble_size=e, seed=seed))
             for name, e, seed in SHARDED]
    # batch_size 1: two member chunks on each rank at E=4
    cases.append(("e4_chunked", "depth", image, cases[0][3],
                  dict(CALL_KW, ensemble_size=4, seed=5, batch_size=1)))
    # LCM, 2 steps, both members from one initial noise: only the fresh
    # noise of the second step tells them apart
    one = jax_noise(3, (1, h, w, 4))
    cases.append(("lcm_e2", "lcm", image, np.concatenate([one, one]),
                  dict(CALL_KW, ensemble_size=2, seed=3)))
    store = str(tmp_path_factory.mktemp("store"))
    # (with the mesh, without it) in each rank
    return M.run_on_ranks(serve_with_and_without_mesh, 2, (ckpts, cases),
                          store_dir=store)


def test_get_mesh_needs_a_process_group_of_enough_ranks():
    with pytest.raises(RuntimeError, match="initialised process group"):
        M.get_mesh(2, device="cpu")


INIT_SCRIPT = """
import os, socket, sys
import torch.distributed as dist
from marigold_tpu_torch.parallel import mesh as M
with socket.socket() as s:  # a free loopback port for each launch
    s.bind(("127.0.0.1", 0)); port1 = s.getsockname()[1]
os.environ.update(MARIGOLD_TPU_COORDINATOR=f"127.0.0.1:{port1}",
                  MARIGOLD_TPU_NUM_PROCESSES="1", MARIGOLD_TPU_PROCESS_ID="0")
n = M.init_distributed(device="cpu")
m = M.get_mesh(device="cpu")
print(n, dist.get_backend(), m.size, m.rank, m.device)
dist.destroy_process_group()
for k in ("MARIGOLD_TPU_COORDINATOR", "MARIGOLD_TPU_NUM_PROCESSES",
          "MARIGOLD_TPU_PROCESS_ID"):
    del os.environ[k]
with socket.socket() as s:
    s.bind(("127.0.0.1", 0)); port2 = s.getsockname()[1]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port2),
                  WORLD_SIZE="1", RANK="0")
n = M.init_distributed(device="cpu")
print(n, dist.get_backend(), M.init_distributed())
dist.destroy_process_group()
"""


def test_init_distributed_reads_the_launch_variables(monkeypatch):
    """The JAX package's MARIGOLD_TPU_* variables, then torchrun's, in a
    fresh interpreter (this process keeps no process group); gloo for CPU
    ranks; a second call is a no-op."""
    import subprocess
    import sys

    for k in ("MARIGOLD_TPU_COORDINATOR", "MARIGOLD_TPU_NUM_PROCESSES",
              "MARIGOLD_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert M.init_distributed() == 1  # nothing names a cluster: a no-op
    monkeypatch.setenv("MARIGOLD_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        M.init_distributed(device="cpu")
    monkeypatch.delenv("MARIGOLD_TPU_NUM_PROCESSES")
    out = subprocess.run([sys.executable, "-c", INIT_SCRIPT], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split("\n")
    assert out[0] == "1 gloo 1 0 cpu" and out[1] == "1 gloo 1"


def test_mesh_helpers_on_two_ranks(tmp_path):
    ranks = M.run_on_ranks(mesh_checks, 2, store_dir=str(tmp_path))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["shape"] == {"data": 2}
        assert out["axis_names"] == ("data",)
        assert out["spec"] == ("data", None, None)
        np.testing.assert_array_equal(out["shard"]["x"].numpy(), x[4 * r:4 * r + 4])
        np.testing.assert_array_equal(out["shard"]["y"][0].numpy(),
                                      [2.0 * r, 2.0 * r + 1])
        for k, v in out["replicated"].items():  # rank 0's, bit for bit
            assert torch.equal(v, ranks[0]["replicated"][k]), k
        assert (out["replicated"]["stat"] == 0).all()
        np.testing.assert_array_equal(out["local"].numpy(), 10.0 * r)
        np.testing.assert_array_equal(out["gathered"].numpy(),
                                      np.repeat([0.0, 10.0], 2)[:, None]
                                      * np.ones((4, 3)))
        np.testing.assert_array_equal(out["reduced"].numpy(), [3.0, 3.0])
        prev, nxt = out["halo"]
        xs = torch.arange(24.0).reshape(1, 2, 3, 4)
        want_prev = torch.zeros(1, 2, 1, 4) if r == 0 else xs[:, :, -1:]
        want_next = xs[:, :, :1] + 100 if r == 0 else torch.zeros(1, 2, 1, 4)
        assert torch.equal(prev, want_prev) and torch.equal(nxt, want_next)


@pytest.mark.parametrize("name,e,seed", SHARDED)
def test_sharded_call_matches_the_jax_mesh(sharded_runs, ckpts, image, name,
                                           e, seed):
    """__call__ with the members over 2 ranks against the JAX pipeline on a
    2-device mesh, on the JAX noise: every rank returns the same map and
    uncertainty, within the JAX package's own sharded-vs-single bound."""
    import jax.numpy as jnp

    from marigold_tpu import MarigoldDepthPipeline as JaxDepth
    from marigold_tpu.parallel.mesh import get_mesh

    jpipe = JaxDepth.from_pretrained(ckpts["depth"], dtype=jnp.float32,
                                     mesh=get_mesh(2))
    ref = jpipe(image, ensemble_size=e, seed=seed, show_progress_bar=False,
                **CALL_KW)
    r0, r1 = (ranks[0][name] for ranks in sharded_runs)
    for a, b in zip(r0, r1):
        np.testing.assert_array_equal(a, b)
    assert r0[0].shape == (40, 48)
    np.testing.assert_allclose(r0[0], ref.depth_np, atol=ATOL, rtol=0)
    np.testing.assert_allclose(r0[1], ref.uncertainty, atol=ATOL, rtol=0)


def test_member_chunks_on_each_rank_change_nothing(sharded_runs):
    """batch_size 1 (two chunks per rank) against one chunk per rank: the
    CPU kernels' summation order follows the batch, within fp32 rounding."""
    for ranks, _ in sharded_runs:
        for a, b in zip(ranks["e4_chunked"], ranks["e4"]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_sharded_lcm_members_take_distinct_fresh_noise(sharded_runs):
    """LCM over 2 ranks: each rank draws every member's fresh noise and
    keeps its own rows, so the map is the single process's one-chunk map,
    whose two members (one initial noise) differ by their fresh noise
    alone; ranks drawing the same rows would give two equal members, whose
    median is not that map."""
    (r0, single), (r1, _) = sharded_runs
    for a, b in zip(r0["lcm_e2"], r1["lcm_e2"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r0["lcm_e2"], single["lcm_e2"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_a_one_rank_mesh_is_no_mesh(ckpts, image, tmp_path):
    h, w = _latent_hw(image)
    cases = [("e3", "depth", image, jax_noise(1, (3, h, w, 4)),
              dict(CALL_KW, ensemble_size=3, seed=1))]
    (with_mesh, without), = M.run_on_ranks(
        serve_with_and_without_mesh, 1, (ckpts, cases), store_dir=str(tmp_path))
    for a, b in zip(with_mesh["e3"], without["e3"]):
        np.testing.assert_array_equal(a, b)


def test_from_pretrained_takes_the_mesh_device(ckpts):
    from marigold_tpu_torch import MarigoldDepthPipeline

    one = M.Mesh(0, 1, torch.device("cpu"))
    pipe = MarigoldDepthPipeline.from_pretrained(ckpts["depth"],
                                                 dtype=torch.float32, mesh=one)
    assert pipe.core.mesh is one and pipe.core.device == torch.device("cpu")
    with pytest.raises(ValueError, match="is not the mesh's"):
        MarigoldDepthPipeline.from_pretrained(ckpts["depth"], device="cuda",
                                              mesh=one)


@pytest.mark.parametrize("e,n,model_bytes", [
    (e, n, mb) for e in (1, 3, 10, 20) for n in (1, 2, 3, 8)
    for mb in (0, 2 * 10**9, 14 * 10**9)])
def test_find_batch_size_matches_jax(e, n, model_bytes):
    import jax

    from marigold_tpu.pipelines import batchsize as jbs
    from marigold_tpu_torch.pipelines import batchsize as tbs

    for res in (64, 768, 2048):
        assert tbs.find_batch_size(e, res, 2, n, model_bytes, device="cpu") == \
            jbs.find_batch_size(e, res, 2, n, model_bytes,
                                device=jax.devices("cpu")[0])
        assert tbs.find_batch_size(e, res, dtype_bytes=4, n_devices=n,
                                   model_bytes=model_bytes, device="cpu") == \
            jbs.find_batch_size(e, res, dtype_bytes=4, n_devices=n,
                                model_bytes=model_bytes,
                                device=jax.devices("cpu")[0])
