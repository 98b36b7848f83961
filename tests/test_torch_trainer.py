"""The port's depth trainer (marigold_tpu_torch.train.trainer) on the tiny
SD2-layout checkpoint of tests/fixtures.py (4-channel UNet, fp32, CPU) with
in-memory batches: surgery, accumulation, callbacks and checkpoints, a
resume that restores every tensor bit for bit, the overfit sanity check of
tests/test_trainer.py, and a saved UNet that the JAX package loads with
equal values. The step itself is held against JAX in
test_torch_train_step.py."""

import os

import numpy as np
import pytest
import torch

from fixtures import make_tiny_checkpoint
from marigold_tpu.models import weights as JW
from marigold_tpu_torch import MarigoldDepthPipeline
from marigold_tpu_torch.config import Config
from marigold_tpu_torch.models import weights as TW
from marigold_tpu_torch.train.trainer import MarigoldDepthTrainer


def _cfg(max_iter=2, **trainer):
    return Config(
        lr=1e-4,
        lr_scheduler=Config(name="IterExponential", kwargs=Config(
            total_iter=100, final_ratio=0.01, warmup_steps=0)),
        loss=Config(name="mse_loss", kwargs=Config(reduction="mean")),
        trainer=Config(dict(dict(
            name="MarigoldDepthTrainer", init_seed=2024, save_period=1,
            backup_period=2, validation_period=2, visualization_period=0),
            **trainer)),
        multi_res_noise=Config(strength=0.9, annealed=True,
                               downscale_strategy="original"),
        gt_depth_type="depth_raw_norm",
        gt_mask_type="valid_mask_raw",
        max_epoch=100,
        max_iter=max_iter,
        validation=Config(
            denoising_steps=1, ensemble_size=1, processing_res=0,
            match_input_res=False, resample_method="bilinear",
            main_val_metric="abs_relative_difference",
            main_val_metric_goal="minimize", init_seed=2024),
        eval=Config(alignment="least_square", align_max_res=None,
                    eval_metrics=["abs_relative_difference", "delta1_acc"]),
    )


def _train_batches(n=3, bsz=2, hw=(32, 32)):
    """The JAX trainer's batch layout (NHWC numpy), some pixels invalid."""
    rng = np.random.default_rng(7)
    return [{
        "rgb_norm": rng.uniform(-1, 1, (bsz, *hw, 3)).astype(np.float32),
        "depth_raw_norm": rng.uniform(-1, 1, (bsz, *hw, 1)).astype(np.float32),
        "valid_mask_raw": rng.uniform(size=(bsz, *hw, 1)) > 0.1,
    } for _ in range(n)]


def _val_batches(n=2, hw=(32, 40)):
    rng = np.random.default_rng(8)
    return [{
        "rgb_int": rng.integers(0, 256, (1, *hw, 3), dtype=np.uint8),
        "depth_raw_linear": rng.uniform(0.5, 10.0, (1, *hw, 1)).astype(np.float32),
        "valid_mask_raw": np.ones((1, *hw, 1), bool),
    } for _ in range(n)]


@pytest.fixture(scope="module")
def sd2_ckpt(tmp_path_factory):
    return make_tiny_checkpoint(str(tmp_path_factory.mktemp("sd2")), mode="sd2")


def _trainer(sd2_ckpt, out, max_iter=2, **trainer_cfg):
    pipe = MarigoldDepthPipeline.from_pretrained(sd2_ckpt, dtype=torch.float32,
                                                 device="cpu")
    return MarigoldDepthTrainer(
        cfg=_cfg(max_iter, **trainer_cfg), model=pipe,
        train_dataloader=_train_batches(),
        out_dir_ckpt=str(out / "ckpt"), out_dir_eval=str(out / "eval"),
        out_dir_vis=str(out / "vis"), accumulation_steps=2,
        val_dataloaders=[_val_batches()], vis_dataloaders=[])


def test_depth_trainer_end_to_end(sd2_ckpt, tmp_path):
    trainer = _trainer(sd2_ckpt, tmp_path)
    # surgery: 4 -> 8 input channels, the kernel duplicated and halved
    assert trainer.core.unet_cfg.in_channels == 8
    w = trainer.state.params["conv_in.weight"].detach()
    torch.testing.assert_close(w[:, :4], w[:, 4:], rtol=0, atol=0)
    before = {n: p.detach().clone() for n, p in trainer.state.params.items()}

    trainer.train()
    assert trainer.effective_iter == 2
    assert trainer.state.step == 4 and trainer.state.count == 2
    losses = [e["loss"] for e in trainer.metrics_log if "loss" in e]
    assert len(losses) == 2 and np.isfinite(losses).all()
    moved = [n for n, p in trainer.state.params.items()
             if not torch.equal(p.detach(), before[n])]
    assert len(moved) == len(before)
    # the pipeline's UNet serves the trained parameters
    for n, p in trainer.core.unet.named_parameters():
        assert torch.equal(p, trainer.state.params[n].detach())
    ckpt = tmp_path / "ckpt"
    assert (ckpt / "latest" / "opt_state.safetensors").exists()
    assert (ckpt / "iter_000002" / "unet" / "config.json").exists()
    assert not (ckpt / "iter_000002" / "opt_state.safetensors").exists()
    assert (ckpt / "best" / "unet").is_dir()
    assert not any(p.name.startswith("_old_") for p in ckpt.iterdir())


def test_resume_restores_state_bit_for_bit(sd2_ckpt, tmp_path):
    t1 = _trainer(sd2_ckpt, tmp_path / "a")
    t1.train()
    t2 = _trainer(sd2_ckpt, tmp_path / "b", max_iter=4)
    t2.load_checkpoint(str(tmp_path / "a" / "ckpt" / "latest"))
    assert t2.effective_iter == 2 and t2.best_metric == t1.best_metric
    assert t2.global_seed_sequence == t1.global_seed_sequence
    s1, s2 = t1.state, t2.state
    assert (s2.step, s2.count, s2.mini_step) == (s1.step, s1.count, s1.mini_step)
    for group in ("params", "mu", "nu"):
        a, b = getattr(s1, group), getattr(s2, group)
        assert a.keys() == b.keys()
        for n in a:
            assert torch.equal(a[n].detach(), b[n].detach()), (group, n)
    t2.train()
    assert t2.effective_iter == 4


def test_loss_decreases_on_overfit(sd2_ckpt, tmp_path):
    """Sanity, as tests/test_trainer.py::test_loss_decreases_on_overfit: 8
    effective iterations on the same batches do not blow up."""
    trainer = _trainer(sd2_ckpt, tmp_path, max_iter=8, validation_period=0,
                       backup_period=0, save_period=0)
    losses = []
    step = trainer.train_step

    def spy(*a, **k):
        metrics = step(*a, **k)
        losses.append(float(metrics["loss"]))
        return metrics

    trainer.train_step = spy
    trainer.train()
    assert len(losses) == 16  # 8 effective iterations x 2 accumulation
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) * 1.5


def test_saved_unet_loads_in_the_jax_package(sd2_ckpt, tmp_path):
    trainer = _trainer(sd2_ckpt, tmp_path, max_iter=1, validation_period=0)
    trainer.train()
    cfg, tree = JW.load_unet(str(tmp_path / "ckpt" / "iter_000001" / "unet"))
    assert cfg.in_channels == 8
    jax_sd = TW.from_jax_tree(tree)
    assert jax_sd.keys() == trainer.state.params.keys()
    for n, p in trainer.state.params.items():
        assert torch.equal(jax_sd[n], p.detach()), n


@pytest.mark.parametrize("what,cfg", [
    ("Adafactor", {"optimizer": Config(name="Adafactor")}),
    ("accum_dtype", {"optimizer": Config(name="Adam", accum_dtype="bfloat16")}),
    ("grad_dtype", {"optimizer": Config(name="Adam", grad_dtype="bfloat16")}),
    ("shard_states", {"optimizer": Config(name="Adam", shard_states=True)}),
    ("save_heavy", {"trainer": None}),
])
def test_unported_options_raise(sd2_ckpt, tmp_path, what, cfg):
    pipe = MarigoldDepthPipeline.from_pretrained(sd2_ckpt, dtype=torch.float32,
                                                 device="cpu")
    full = _cfg()
    if what == "save_heavy":
        full.trainer["remat"] = "save_heavy"
    else:
        full.update(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MarigoldDepthTrainer(full, pipe, [], str(tmp_path), str(tmp_path),
                             str(tmp_path), accumulation_steps=2)
