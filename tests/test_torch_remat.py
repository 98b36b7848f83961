"""Remat block by block (`train/train_step.py`, `models/unet.py`'s
`block_runner`): under "full" and "save_heavy" each down block, the mid
block and each up block of the UNet is its own checkpoint region, so that
the backward holds one region's activations at a time.

On the CPU in fp32, on a tiny UNet and VAE with random weights drawn by the
port (no JAX init): the loss and every gradient of both modes against remat
"none" at rtol 1e-5 (fp32 rounding: the recomputed forward is the same
computation), the regions' forward run once per step and again in the
backward, and the recomputed regions running on the masters handed to the
step, not on the module's own parameters. The lse launch counts per mode
stay in `test_torch_train_options.py`."""

import numpy as np
import pytest
import torch

from fixtures import TINY_VAE, tiny_unet_config
from marigold_tpu_torch.core.scheduler import DiffusionSchedule
from marigold_tpu_torch.models import unet as tunet
from marigold_tpu_torch.models import weights as W
from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from marigold_tpu_torch.train import train_step as tts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def parts():
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, cls, cfg in (
            ("unet", tunet.UNet2DConditionModel,
             tunet.UNetConfig.from_dict(tiny_unet_config(8, 4).to_dict())),
            ("vae", AutoencoderKL, VAEConfig.from_dict(TINY_VAE.to_dict()))):
        with torch.device("meta"):
            model = cls(cfg)
        sd = W.random_state_dict(model, gen)
        out[name] = W.build_module(cls, cfg, sd, torch.float32, "cpu")
        out[name + "_sd"] = sd
    out["schedule"] = DiffusionSchedule.create()
    return out


def _step(parts, remat, seed=0):
    """One depth micro-step (masked, annealed multi-resolution noise) on
    masters that differ from the module's own parameters."""
    rng = np.random.default_rng(seed)
    hw = (32, 40)

    def arr(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))

    batch = {"rgb_norm": arr(2, 3, *hw), "gt_norm": arr(2, 3, *hw),
             "valid_mask": torch.from_numpy(rng.uniform(size=(2, 1, *hw)) > 0.1)}
    unet = parts["unet"]
    text = arr(1, 2, unet.cfg.cross_attention_dim)
    ds = parts["vae"].cfg.downscale_factor
    lat = (2, 4, hw[0] // ds, hw[1] // ds)
    noise = torch.from_numpy(rng.standard_normal(lat).astype(np.float32))
    t = torch.tensor([17, 611])
    loss_and_grad = tts.make_loss_and_grad(
        unet, parts["vae"], parts["schedule"], "mse_loss",
        {"strength": 0.9, "annealed": True, "downscale_strategy": "original"},
        True, compute_dtype=torch.float32, remat=remat)
    masters = {n: (v + 0.01).requires_grad_() for n, v in parts["unet_sd"].items()}
    return loss_and_grad(masters, text, batch, timesteps=t, noise=noise)


@pytest.mark.parametrize("remat", ["full", "save_heavy"])
def test_blockwise_remat_gives_the_loss_and_gradients_of_no_remat(parts, remat):
    loss_n, grads_n = _step(parts, "none")
    loss_r, grads_r = _step(parts, remat)
    np.testing.assert_allclose(float(loss_r), float(loss_n), rtol=1e-5)
    assert grads_r.keys() == grads_n.keys()
    for n, g in grads_n.items():
        assert g.abs().max() > 0, n  # every parameter reached, masters included
        np.testing.assert_allclose(grads_r[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()) + 1e-12,
                                   err_msg=n)


@pytest.mark.parametrize("remat,runs", [("none", 1), ("full", 2),
                                        ("save_heavy", 2)])
def test_each_block_is_a_region_run_again_in_the_backward(parts, remat, runs,
                                                          monkeypatch):
    """Every down, mid and up block runs once in the forward, and under
    remat once more in the backward: one region each, recomputed when the
    backward reaches it (one down and one up block per level)."""
    calls = []
    for fn in ("_down_block", "_mid_block", "_up_block"):
        orig = getattr(tunet, fn)
        monkeypatch.setattr(tunet, fn, lambda blk, *a, _f=orig, _n=fn: (
            calls.append(_n), _f(blk, *a))[1])
    _step(parts, remat)
    cfg = parts["unet"].cfg
    n = len(cfg.block_out_channels)
    assert calls.count("_down_block") == n * runs
    assert calls.count("_mid_block") == runs
    assert calls.count("_up_block") == n * runs


def test_block_runner_matches_the_plain_forward(parts):
    """The UNet forward through a block runner that calls each region
    plainly gives the forward's bits."""
    rng = np.random.default_rng(3)
    unet = parts["unet"]
    x = torch.from_numpy(rng.standard_normal((1, 8, 9, 11)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal(
        (1, 2, unet.cfg.cross_attention_dim)).astype(np.float32))
    with torch.no_grad():
        ref = unet(x, 500, ctx)
        got = unet(x, 500, ctx,
                   block_runner=lambda fn, blk, *a: blk(fn, *a))
    assert torch.equal(got, ref)
