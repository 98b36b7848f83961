"""Depth fine-tuning trainer on one GPU.

Counterpart of `marigold_tpu/train/trainer.py` (`MarigoldTrainerBase`,
`MarigoldDepthTrainer`) without a mesh or multiple hosts: conv_in surgery
of the loaded SD2 UNet, fp32 master parameters with Adam and k-step
gradient accumulation (train_step.py), per-micro-step seeded randomness
from a pre-generated global seed sequence (deterministic resume), the
effective-iteration callbacks (backup checkpoint / validation / latest
checkpoint / visualization), best-checkpoint gating on the first
validation set's main metric, a time budget, and save/resume.

The train loader is any iterable of dict batches in the JAX trainer's
layout: NHWC arrays (numpy or torch) `rgb_norm` [B, H, W, 3] in [-1, 1],
the depth target under `cfg.gt_depth_type` [B, H, W, 1] and the mask under
`cfg.gt_mask_type` [B, H, W, 1]. Validation loaders yield `rgb_int`,
`depth_raw_linear` and `valid_mask_raw` for one image; validation runs the
port's pipeline at ensemble size 1. Visualization writes PNGs and runs only
where PIL and matplotlib are installed. Metrics go to the `logging` module
and to `metrics_log` (there is no TensorBoard writer in the port).

Not ported (ROADMAP queue 1, "Training"): the normals and IID trainers,
`cli/train.py` and the data layer, mesh/ZeRO/multi-host, Adafactor,
`save_heavy`, `grad_dtype`/`accum_dtype`.
"""

from __future__ import annotations

import importlib.util
import logging
import os
from datetime import datetime
from typing import List, Optional

import numpy as np
import torch

from marigold_tpu_torch.eval import metrics as M
from marigold_tpu_torch.eval.alignment import align_depth_least_square
from marigold_tpu_torch.models import surgery
from marigold_tpu_torch.models import weights as W
from marigold_tpu_torch.models.unet import UNet2DConditionModel
from marigold_tpu_torch.pipelines import image_util
from marigold_tpu_torch.train.checkpoints import (
    load_train_state,
    save_train_state as save_train_ckpt,
)
from marigold_tpu_torch.train.lr_schedule import iter_exponential
from marigold_tpu_torch.train.train_step import (
    TrainState,
    make_optimizer,
    make_train_step,
    not_ported,
)
from marigold_tpu_torch.utils.seeding import (
    generate_seed_sequence,
    generator_from_seed,
)

logger = logging.getLogger(__name__)


def _nchw(x, device, dtype=torch.float32) -> torch.Tensor:
    """NHWC array or tensor -> contiguous NCHW tensor on `device`."""
    t = torch.as_tensor(np.asarray(x))
    return t.permute(0, 3, 1, 2).contiguous().to(device=device, dtype=dtype)


class MarigoldTrainerBase:
    modality = "depth"

    def __init__(
        self,
        cfg,
        model,  # a pipelines.BasePipeline (with .core)
        train_dataloader,
        out_dir_ckpt: str,
        out_dir_eval: str,
        out_dir_vis: str,
        accumulation_steps: int,
        val_dataloaders: Optional[List] = None,
        vis_dataloaders: Optional[List] = None,
    ):
        self.cfg = cfg
        self.model = model
        self.core = model.core
        self.device = self.core.device
        self.train_loader = train_dataloader
        self.out_dir_ckpt = out_dir_ckpt
        self.out_dir_eval = out_dir_eval
        self.out_dir_vis = out_dir_vis
        self.accumulation_steps = int(accumulation_steps)
        self.val_loaders = val_dataloaders or []
        self.vis_loaders = vis_dataloaders or []

        self._apply_surgery()

        opt_cfg = cfg.get("optimizer") or {}
        if opt_cfg.get("shard_states"):
            raise not_ported("ZeRO-sharded optimizer state (shard_states)")
        lrs = cfg.lr_scheduler.kwargs
        self.lr_schedule_fn = iter_exponential(
            int(lrs.total_iter), float(lrs.final_ratio), int(lrs.warmup_steps))
        # optimizer.split_accum needs no setting: accumulation always runs
        # as micro steps, then the update at the window boundary
        # (train_step.py)
        self.optimizer = make_optimizer(
            float(cfg.lr), self.lr_schedule_fn, self.accumulation_steps,
            name=opt_cfg.get("name", "adam"),
            accum_dtype=opt_cfg.get("accum_dtype"),
        )
        self.state = self.optimizer.init(self._master_params())
        # the conditioning, out of inference mode so autograd may save it
        self.text_embed = self.core.empty_text_embed.clone()
        self._build_train_step()

        self.effective_iter = 0
        self.epoch = 1
        self.n_batch_in_epoch = 0
        self.in_evaluation = False
        self.best_metric = (
            1e8 if cfg.validation.main_val_metric_goal == "minimize" else -1e8)
        self.max_iter = int(cfg.max_iter)
        self.max_epoch = int(cfg.max_epoch)
        self.save_period = int(cfg.trainer.save_period)
        self.backup_period = int(cfg.trainer.backup_period)
        self.val_period = int(cfg.trainer.validation_period)
        self.vis_period = int(cfg.trainer.visualization_period)
        self.gt_mask_type = cfg.get("gt_mask_type")
        self.metrics_log: list = []

        init_seed = cfg.trainer.get("init_seed")
        self._seed_refills = 0
        self.global_seed_sequence: list = (
            generate_seed_sequence(init_seed, self.max_iter * max(
                self.accumulation_steps, 1))
            if init_seed is not None else []
        )

    # ------------------------------------------------------------------ #

    def _apply_surgery(self):
        raise NotImplementedError

    def _master_params(self) -> dict:
        """fp32 copies of the pipeline UNet's parameters, as autograd
        leaves."""
        return {n: p.detach().float().clone().requires_grad_()
                for n, p in self.core.unet.named_parameters()}

    def _set_unet(self, cfg, state_dict) -> None:
        """Rebuild the pipeline's UNet module (compute dtype, frozen) for
        `cfg` from `state_dict`."""
        self.core.unet = W.build_module(
            UNet2DConditionModel, cfg,
            {n: t.to(self.core.dtype) for n, t in state_dict.items()},
            self.core.dtype, self.device)
        self.core.unet_cfg = cfg

    def _step_kwargs(self) -> dict:
        cfg = self.cfg
        mrn = cfg.get("multi_res_noise")
        return dict(
            loss_name=cfg.loss.name,
            multi_res_noise_cfg=dict(mrn) if mrn else None,
            use_mask=cfg.get("gt_mask_type") is not None,
            compute_dtype=self.core.dtype,
            remat=cfg.trainer.get("remat", False),
            grad_dtype=(cfg.get("optimizer") or {}).get("grad_dtype"),
        )

    def _build_train_step(self):
        """(Re)build the step from the current core UNet and schedule,
        called at init and after load_checkpoint."""
        self.train_step, self.apply_step = make_train_step(
            self.core.unet, self.core.vae, self.core.schedule, self.optimizer,
            **self._step_kwargs())

    def _assemble_batch(self, batch) -> dict:
        """-> {rgb_norm [B,3,H,W], gt_norm [B,3k,H,W], valid_mask?} on the
        device."""
        raise NotImplementedError

    def _next_seed(self) -> int:
        if not self.global_seed_sequence:
            # regenerate deterministically from init_seed, as the JAX trainer
            base = self.cfg.trainer.get("init_seed") or 0
            self._seed_refills += 1
            chunk = max(self.max_iter, 1) * max(self.accumulation_steps, 1)
            self.global_seed_sequence = generate_seed_sequence(
                int(base) + 1_000_003 * self._seed_refills, chunk)
        return self.global_seed_sequence.pop()

    def _step_generator(self) -> torch.Generator:
        return generator_from_seed(self._next_seed(), self.device)

    # ------------------------------------------------------------------ #

    def train(self, t_end: Optional[datetime] = None) -> None:
        logger.info("Start training")
        if self.in_evaluation:
            logger.info("Resumed during validation: re-running validation.")
            self.validate()
            self.in_evaluation = False
            self.save_checkpoint("latest", save_train_state=True)

        accumulated_step = 0
        self._sync_params_to_core()
        while self.epoch <= self.max_epoch:
            logger.info(f"epoch: {self.epoch}")
            loader = self.train_loader
            if self.n_batch_in_epoch > 0 and hasattr(loader, "skip_first_batches"):
                loader.skip_first_batches(self.n_batch_in_epoch)

            for batch in loader:
                batch_dev = self._assemble_batch(batch)
                step_metrics = self.train_step(
                    self.state, self.text_embed, batch_dev,
                    self._step_generator())
                # summed on the device (no host sync per micro-batch); the
                # logged loss is the effective-batch mean
                window_loss = (step_metrics["loss"] if accumulated_step == 0
                               else window_loss + step_metrics["loss"])
                accumulated_step += 1
                self.n_batch_in_epoch += 1

                if accumulated_step >= self.accumulation_steps:
                    self.apply_step(self.state)
                    loss = float(window_loss) / accumulated_step
                    accumulated_step = 0
                    self.effective_iter += 1
                    if not np.isfinite(loss):
                        logger.warning(f"non-finite loss at iter {self.effective_iter}")
                    entry = {
                        "iter": self.effective_iter, "loss": loss,
                        "grad_norm": float(step_metrics["grad_norm"]),
                        "lr": self.optimizer.learning_rate(self.effective_iter),
                        "n_batch_in_epoch": self.n_batch_in_epoch,
                    }
                    self.metrics_log.append(entry)
                    logger.info(f"iter {self.effective_iter:5d} (epoch "
                                f"{self.epoch:2d}): loss={loss:.5f}")

                    self._train_step_callback()

                    if self.max_iter > 0 and self.effective_iter >= self.max_iter:
                        self.save_checkpoint(self._get_backup_ckpt_name(),
                                             save_train_state=False)
                        logger.info("Training ended.")
                        return
                    if t_end is not None and datetime.now() >= t_end:
                        self.save_checkpoint("latest", save_train_state=True)
                        logger.info("Time is up, training paused.")
                        return
            self.epoch += 1
            self.n_batch_in_epoch = 0
        # epoch budget exhausted before max_iter: persist the final state
        self.save_checkpoint("latest", save_train_state=True)
        logger.info("Training ended (max_epoch reached).")

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _sync_params_to_core(self):
        """Copy the fp32 masters into the pipeline's UNet (its dtype)."""
        for n, p in self.core.unet.named_parameters():
            p.copy_(self.state.params[n])

    def _train_step_callback(self):
        if self.backup_period > 0 and 0 == self.effective_iter % self.backup_period:
            self.save_checkpoint(self._get_backup_ckpt_name(), save_train_state=False)

        _is_latest_saved = False
        if self.val_period > 0 and 0 == self.effective_iter % self.val_period:
            self.in_evaluation = True
            self.save_checkpoint("latest", save_train_state=True)
            _is_latest_saved = True
            self.validate()
            self.in_evaluation = False
            self.save_checkpoint("latest", save_train_state=True)

        if (self.save_period > 0 and 0 == self.effective_iter % self.save_period
                and not _is_latest_saved):
            self.save_checkpoint("latest", save_train_state=True)

        if self.vis_period > 0 and 0 == self.effective_iter % self.vis_period:
            self.visualize()

    def _get_backup_ckpt_name(self):
        return f"iter_{self.effective_iter:06d}"

    # ------------------------------------------------------------------ #
    # validation / visualization

    def validate(self):
        self._sync_params_to_core()
        for i, val_loader in enumerate(self.val_loaders):
            val_name = getattr(getattr(val_loader, "dataset", None), "disp_name",
                               f"val_{i}")
            result = self.validate_single_dataset(val_loader)
            main_metric = self.cfg.validation.main_val_metric
            logger.info(f"Iter {self.effective_iter}. Validation metrics on "
                        f"{val_name}: {result}")
            self.metrics_log.append({"iter": self.effective_iter,
                                     "val": val_name, **result})
            if i == 0:  # best-checkpoint gate on the first val dataset
                value = result[main_metric]
                goal = self.cfg.validation.main_val_metric_goal
                better = (value < self.best_metric if goal == "minimize"
                          else value > self.best_metric)
                if better:
                    self.best_metric = value
                    logger.info(f"Best metric: {main_metric} = {value}")
                    self.save_checkpoint("best", save_train_state=False)

    def validate_single_dataset(self, val_loader) -> dict:
        raise NotImplementedError

    def visualize(self):
        if not all(importlib.util.find_spec(m) for m in ("PIL", "matplotlib")):
            logger.warning("visualization needs PIL and matplotlib; skipped")
            return
        self._sync_params_to_core()
        for vis_loader in self.vis_loaders:
            name = getattr(getattr(vis_loader, "dataset", None), "disp_name", "vis")
            out_dir = os.path.join(self.out_dir_vis, name)
            os.makedirs(out_dir, exist_ok=True)
            self._visualize_dataset(vis_loader, out_dir)

    def _visualize_dataset(self, vis_loader, out_dir):
        pass

    def _val_pipe_kwargs(self):
        v = self.cfg.validation
        return dict(
            denoising_steps=int(v.denoising_steps),
            ensemble_size=int(v.ensemble_size),
            processing_res=int(v.processing_res),
            match_input_res=bool(v.match_input_res),
            seed=v.get("init_seed"),
        )

    # ------------------------------------------------------------------ #
    # checkpointing

    def save_checkpoint(self, ckpt_name: str, save_train_state: bool = True):
        ckpt_dir = os.path.join(self.out_dir_ckpt, ckpt_name)
        logger.info(f"Saving checkpoint to {ckpt_dir}")
        st: TrainState = self.state
        trainer_state = {
            "effective_iter": self.effective_iter,
            "epoch": self.epoch,
            "n_batch_in_epoch": self.n_batch_in_epoch,
            "best_metric": float(self.best_metric),
            "in_evaluation": self.in_evaluation,
            "global_seed_sequence": self.global_seed_sequence,
            "step": st.step,
            "process_count": 1,
        }
        opt_state = None
        if save_train_state:
            opt_state = {"mu": st.mu, "nu": st.nu, "acc": st.acc,
                         "count": st.count, "mini_step": st.mini_step}
        save_train_ckpt(ckpt_dir, self.core.unet_cfg, st.params,
                        self.core.schedule, trainer_state, opt_state)

    def load_checkpoint(self, ckpt_dir: str, load_trainer_state: bool = True):
        logger.info(f"Loading checkpoint from {ckpt_dir}")
        unet_cfg, params, schedule, trainer_state, opt_state = load_train_state(
            ckpt_dir, load_opt_state=load_trainer_state)
        if unet_cfg != self.core.unet_cfg:
            self._set_unet(unet_cfg, params)
        # the checkpoint's scheduler config is authoritative on resume
        self.core.schedule = schedule
        dev = self.device
        masters = {n: t.to(dev).requires_grad_() for n, t in params.items()}
        self.state = self.optimizer.init(masters) if opt_state is None else TrainState(
            params=masters,
            mu={n: t.to(dev) for n, t in opt_state["mu"].items()},
            nu={n: t.to(dev) for n, t in opt_state["nu"].items()},
            count=opt_state["count"], mini_step=opt_state["mini_step"],
            acc=(None if opt_state["acc"] is None else
                 {n: t.to(dev) for n, t in opt_state["acc"].items()}),
        )
        self.state.step = int(trainer_state.get("step", 0))
        self._build_train_step()
        if load_trainer_state:
            self.effective_iter = trainer_state["effective_iter"]
            self.epoch = trainer_state["epoch"]
            self.n_batch_in_epoch = trainer_state["n_batch_in_epoch"]
            self.best_metric = trainer_state["best_metric"]
            self.in_evaluation = trainer_state["in_evaluation"]
            self.global_seed_sequence = list(trainer_state["global_seed_sequence"])
        self._sync_params_to_core()


# ------------------------------------------------------------------ #


class MarigoldDepthTrainer(MarigoldTrainerBase):
    modality = "depth"

    def _apply_surgery(self):
        if self.core.unet_cfg.in_channels == 4:
            cfg, sd = surgery.replace_conv_in(
                self.core.unet_cfg, self.core.unet.state_dict(), 8)
            self._set_unet(cfg, sd)

    def _assemble_batch(self, batch):
        gt_type = self.cfg.get("gt_depth_type", "depth_raw_norm")
        depth = _nchw(batch[gt_type], self.device)  # [B, 1, H, W]
        out = {
            "rgb_norm": _nchw(batch["rgb_norm"], self.device),
            "gt_norm": depth.expand(-1, 3, -1, -1).contiguous(),
        }
        if self.gt_mask_type is not None:
            out["valid_mask"] = _nchw(batch[self.gt_mask_type], self.device,
                                      torch.bool)
        return out

    def validate_single_dataset(self, val_loader) -> dict:
        tracker = M.MetricTracker(*self.cfg.eval.eval_metrics)
        kwargs = self._val_pipe_kwargs()
        ds = getattr(val_loader, "dataset", None)
        for batch in val_loader:
            rgb_int = np.asarray(batch["rgb_int"][0], np.uint8)
            depth_pred = self.model(rgb_int, color_map=None, **kwargs).depth_np
            gt = np.asarray(batch["depth_raw_linear"][0, ..., 0])
            valid = np.asarray(batch["valid_mask_raw"][0, ..., 0], bool)
            if depth_pred.shape != gt.shape:
                depth_pred = image_util.resize_np(
                    depth_pred[..., None], gt.shape, "bilinear")[..., 0]
            aligned, _, _ = align_depth_least_square(gt, depth_pred, valid)
            aligned = np.clip(aligned, getattr(ds, "min_depth", 0),
                              getattr(ds, "max_depth", np.inf))
            for name in self.cfg.eval.eval_metrics:
                tracker.update(name, M.DEPTH_METRICS[name](aligned, gt, valid))
        return tracker.result()

    def _visualize_dataset(self, vis_loader, out_dir):
        kwargs = self._val_pipe_kwargs()
        for batch in vis_loader:
            rgb_int = np.asarray(batch["rgb_int"][0], np.uint8)
            out = self.model(rgb_int, color_map="Spectral", **kwargs)
            name = os.path.splitext(
                os.path.basename(batch["rgb_relative_path"][0]))[0]
            out.depth_colored.save(os.path.join(
                out_dir, f"iter_{self.effective_iter:06d}_{name}.png"))

