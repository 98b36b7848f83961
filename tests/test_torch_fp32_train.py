"""fp32 fine-tuning through the training attention route: the port's
MarigoldDepthTrainer on a tiny fp32 pipeline with every attention on the
lse forward and the dQ, dK/dV backward (FlashAttentionFunction; on the CPU
their plain versions, on the card the kernels of
csrc/flash_fwd_d64_f32_sm90.cu, csrc/flash_bwd_dq_f32_sm90.cu and
csrc/flash_bwd_dkv_f32_sm90.cu), one effective iteration of 2 micro-steps in each
remat mode, against the JAX package's MarigoldDepthTrainer in fp32 with
its flash dispatch forced on, the Pallas lse forward and backward kernels
in interpret mode (as tests/test_flash_attention.py forces them).

The frameworks draw different random numbers from one seed, so the port
is handed the JAX trainer's draws: both pop the same seed sequence, and the
timesteps and multi-resolution noise the JAX step draws from each seed's
key are reproduced here in JAX (as test_torch_train_step.py does)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marigold_tpu import MarigoldDepthPipeline as JPipeline
from marigold_tpu.config import Config as JConfig
from marigold_tpu.ops import attention as JA
from marigold_tpu.ops import flash_attention as JF
from marigold_tpu.train.multi_res_noise import multi_res_noise_like
from marigold_tpu.train.trainer import MarigoldDepthTrainer as JTrainer
from marigold_tpu.utils.seeding import key_from_seed
from marigold_tpu_torch import MarigoldDepthPipeline
from marigold_tpu_torch.config import Config
from marigold_tpu_torch.models import weights as TW
from marigold_tpu_torch.ops import attention as TA
from marigold_tpu_torch.ops import flash_attention as fa
from marigold_tpu_torch.train.trainer import MarigoldDepthTrainer
from test_torch_train_cli import write_port_sd2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores several
    times over (tiny models gain nothing from it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ACCUM = 2
LR = 1e-3
MRN = {"strength": 0.9, "annealed": True, "downscale_strategy": "original"}
# the tiny UNet's heads are 4 wide: admitted to the lse/backward route
TINY_HEAD_DIMS = (4,)


def _cfg(cls, remat="none"):
    return cls(
        lr=LR,
        lr_scheduler=cls(name="IterExponential", kwargs=cls(
            total_iter=100, final_ratio=0.01, warmup_steps=0)),
        loss=cls(name="mse_loss", kwargs=cls(reduction="mean")),
        trainer=cls(name="MarigoldDepthTrainer", init_seed=2024, save_period=0,
                    backup_period=0, validation_period=0,
                    visualization_period=0, remat=remat),
        multi_res_noise=cls(MRN),
        gt_depth_type="depth_raw_norm",
        gt_mask_type="valid_mask_raw",
        max_epoch=10, max_iter=1,
        validation=cls(denoising_steps=1, ensemble_size=1, processing_res=0,
                       match_input_res=False, resample_method="bilinear",
                       main_val_metric="abs_relative_difference",
                       main_val_metric_goal="minimize", init_seed=2024),
        eval=cls(alignment="least_square", align_max_res=None,
                 eval_metrics=["abs_relative_difference", "delta1_acc"]),
    )


def _batches(bsz=2, hw=(32, 32)):
    """The trainers' batch layout (NHWC numpy), some pixels invalid."""
    rng = np.random.default_rng(17)
    return [{
        "rgb_norm": rng.uniform(-1, 1, (bsz, *hw, 3)).astype(np.float32),
        "depth_raw_norm": rng.uniform(-1, 1, (bsz, *hw, 1)).astype(np.float32),
        "valid_mask_raw": rng.uniform(size=(bsz, *hw, 1)) > 0.1,
    } for _ in range(ACCUM)]


def _spy_seeds(trainer) -> list:
    """The seeds `trainer` pops, in order."""
    seeds, pop = [], trainer._next_seed

    def spy():
        seeds.append(pop())
        return seeds[-1]

    trainer._next_seed = spy
    return seeds


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_port_sd2(str(tmp_path_factory.mktemp("sd2")))


@pytest.fixture(scope="module")
def jax_iteration(ckpt, tmp_path_factory):
    """One effective iteration (2 micro-steps) of the JAX trainer in fp32,
    every attention through flash_attention_dt in interpret mode: the
    seeds it popped, each micro-step's loss, the masters before and
    after."""
    out = tmp_path_factory.mktemp("jax_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "_FLASH_MIN_SEQ", 1)
        mp.setattr(JA, "_on_tpu", lambda: True)
        mp.setattr(JF, "flash_attention_dt", functools.partial(
            JF.flash_attention_dt, block_q=128, block_k=128, interpret=True))
        pipe = JPipeline.from_pretrained(ckpt, dtype=jnp.float32)
        trainer = JTrainer(
            cfg=_cfg(JConfig), model=pipe, train_dataloader=_batches(),
            out_dir_ckpt=str(out / "ckpt"), out_dir_eval=str(out / "eval"),
            out_dir_vis=str(out / "vis"), accumulation_steps=ACCUM)
        start = TW.from_jax_tree(trainer.state.params)
        seeds, losses, step = _spy_seeds(trainer), [], trainer.train_step

        def spy_step(*args):
            state, metrics = step(*args)
            losses.append(float(metrics["loss"]))
            return state, metrics

        trainer.train_step = spy_step
        trainer.train()
    assert trainer.effective_iter == 1 and len(losses) == ACCUM
    return {"seeds": seeds, "losses": losses, "start": start,
            "params": TW.from_jax_tree(trainer.state.params)}


def _jax_draws(seed: int, bsz: int, latent_nhwc: tuple):
    """(timesteps, noise NCHW) as the JAX step draws them from the key of
    `seed` (annealed multi-resolution noise; they depend on the latent's
    shape only)."""
    k_t, k_noise = jax.random.split(key_from_seed(seed))
    t = jax.random.randint(k_t, (bsz,), 0, 1000)
    strength = MRN["strength"] * (t.astype(jnp.float32) / 1000)
    noise = multi_res_noise_like(k_noise, jnp.zeros(latent_nhwc, jnp.float32),
                                 strength, MRN["downscale_strategy"])
    return (torch.from_numpy(np.array(t)),
            torch.from_numpy(np.array(noise).transpose(0, 3, 1, 2).copy()))


def _port_trainer(ckpt, out, remat):
    pipe = MarigoldDepthPipeline.from_pretrained(ckpt, dtype=torch.float32,
                                                 device="cpu")
    return MarigoldDepthTrainer(
        cfg=_cfg(Config, remat), model=pipe, train_dataloader=_batches(),
        out_dir_ckpt=str(out / "ckpt"), out_dir_eval=str(out / "eval"),
        out_dir_vis=str(out / "vis"), accumulation_steps=ACCUM)


@pytest.fixture
def flash_route(monkeypatch):
    """Every attention of the port on the flash dispatch, the tiny heads on
    the lse/backward route; -> the routes FlashAttentionFunction took."""
    routes = []
    fwd = fa.FlashAttentionFunction.forward

    def spy(ctx, *args):
        out = fwd(ctx, *args)
        routes.append(ctx.kernel_bwd)
        return out

    monkeypatch.setattr(TA, "use_flash", lambda q, nk: True)
    monkeypatch.setattr(fa, "TRAIN_HEAD_DIMS", TINY_HEAD_DIMS)
    monkeypatch.setattr(fa.FlashAttentionFunction, "forward", staticmethod(spy))
    return routes


@pytest.mark.parametrize("remat", ["none", "full", "save_heavy"])
def test_fp32_iteration_matches_the_jax_trainer(ckpt, jax_iteration,
                                                flash_route, tmp_path, remat):
    trainer = _port_trainer(ckpt, tmp_path, remat)
    assert trainer.core.dtype == torch.float32
    start = {n: p.detach().clone() for n, p in trainer.state.params.items()}
    for n, t in jax_iteration["start"].items():
        assert torch.equal(start[n], t), n
    seeds, losses, step = _spy_seeds(trainer), [], trainer.train_step
    ds = trainer.core.vae_cfg.downscale_factor
    lat_c = trainer.core.vae_cfg.latent_channels

    def with_jax_draws(state, text_embed, batch, generator):
        b, _, h, w = batch["rgb_norm"].shape
        t, noise = _jax_draws(seeds[-1], b, (b, h // ds, w // ds, lat_c))
        metrics = step(state, text_embed, batch, timesteps=t, noise=noise)
        losses.append(float(metrics["loss"]))
        return metrics

    trainer.train_step = with_jax_draws
    trainer.train()
    assert trainer.effective_iter == 1 and trainer.state.count == 1
    assert seeds == jax_iteration["seeds"]
    # every attention took the lse forward and the backward route
    assert flash_route and all(flash_route)
    # fp32 forwards of the same model, attention summed in another order
    np.testing.assert_allclose(losses, jax_iteration["losses"], rtol=1e-5)
    ref = jax_iteration["params"]
    assert ref.keys() == trainer.state.params.keys()
    for n, p in trainer.state.params.items():
        want = ref[n].numpy()
        # one Adam update moves each parameter by up to ~lr; it divides each
        # gradient by its own magnitude, so a gradient near eps magnifies
        # the packages' ~1e-4-relative difference: atol 5e-5 (5% of lr)
        np.testing.assert_allclose(p.detach().numpy(), want, atol=5e-5,
                                   rtol=1e-3, err_msg=n)
        assert np.abs(want - start[n].numpy()).max() > 0.5 * LR, n


@pytest.mark.parametrize("remat,again", [("none", 0), ("full", 1),
                                         ("save_heavy", 0)])
def test_lse_forward_runs_once_per_attention_in_fp32(ckpt, flash_route,
                                                     monkeypatch, tmp_path,
                                                     remat, again):
    """One fp32 micro-step of the trainer: the lse op runs exactly once per
    attention in the forward; in the backward it runs again for every
    attention under remat "full" and for none under "save_heavy", whose
    policy keeps its fp32 outputs (the recompute still runs each
    FlashAttentionFunction.forward). CPU tensors run the plain version,
    counted through the module function the op calls."""
    trainer = _port_trainer(ckpt, tmp_path, remat)
    phase, lse_calls, lse = ["forward"], [], fa.flash_attention_lse

    def count_lse(q, k, v, num_heads):
        out, l = lse(q, k, v, num_heads)
        assert out.dtype == l.dtype == torch.float32
        lse_calls.append(phase[0])
        return out, l

    grad = torch.autograd.grad

    def backward(*args, **kwargs):
        phase[0] = "backward"
        return grad(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_lse", count_lse)
    monkeypatch.setattr(torch.autograd, "grad", backward)
    batch = trainer._assemble_batch(_batches()[0])
    metrics = trainer.train_step(trainer.state, trainer.text_embed, batch,
                                 trainer._step_generator())
    assert np.isfinite(float(metrics["loss"]))
    n_attn = len(flash_route) // (2 if remat != "none" else 1)
    # the tiny UNet: 6 transformer blocks, a self- and a cross-attention each
    assert n_attn == 12
    assert lse_calls.count("forward") == n_attn
    assert lse_calls.count("backward") == again * n_attn
