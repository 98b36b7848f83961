"""Fine-tuning trainers: depth, normals and IID, on one GPU or across ranks.

Counterpart of `marigold_tpu/train/trainer.py` (`MarigoldTrainerBase`, the
depth, normals and IID trainers, `get_trainer_cls`): conv surgery of the
loaded SD2 UNet (conv_in to 8 channels for depth and normals; conv_in to
4 * (n + 1) and conv_out to 4 * n for IID's n targets), fp32 master
parameters with Adam or Adafactor and k-step gradient accumulation
(train_step.py), per-micro-step seeded randomness from a pre-generated
global seed sequence (deterministic resume), the
effective-iteration callbacks (backup checkpoint / validation / latest
checkpoint / visualization), best-checkpoint gating on the first
validation set's main metric, a time budget, and save/resume.

The train loader is any iterable of dict batches in the JAX trainer's
layout, NHWC arrays (numpy or torch): depth takes `rgb_norm` [B, H, W, 3]
in [-1, 1], the target under `cfg.gt_depth_type` [B, H, W, 1] and the mask
under `cfg.gt_mask_type`; normals `rgb_norm` and `cfg.gt_normals_type`
[B, H, W, 3]; IID `rgb` and each target [B, H, W, 3] in [0, 1]. Validation
loaders yield one image per batch, as the data layer's eval datasets do;
validation runs the port's pipeline. Visualization writes PNGs (depth in
the port's own Spectral colours). The JAX trainer's scalars go to
`utils/logging_util.py:tb_logger`, to the `logging` module and to
`metrics_log`.

Across ranks (`mesh`, a `parallel.mesh.Mesh` of several ranks, every rank
running the trainer at once): data parallel as `train_step.py` sets out,
with ZeRO-1 under `optimizer.shard_states`. A loader that strides the
stream over the ranks (`shard_count` > 1, multi-host) yields each rank's
part of the global batch, which is their concatenation in rank order; any
other loader yields the global batch, of which each rank keeps its rows.
Rank 0 alone validates, visualizes and writes checkpoints; the others wait
at the mesh's barrier after each of its passes, and every rank joins a save
that gathers ZeRO-1 state. Rank 0's clock decides `t_end` for all.
"""

from __future__ import annotations

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
    broadcast_params,
    make_optimizer,
    make_train_step,
)
from marigold_tpu_torch.utils.logging_util import tb_logger
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
        mesh=None,
    ):
        self.cfg = cfg
        self.model = model
        self.core = model.core
        self.device = self.core.device
        # a mesh of one rank is no mesh
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and self.mesh.device != self.device:
            raise ValueError(f"the model is on {self.device}, the mesh's rank "
                             f"on {self.mesh.device}")
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.train_loader = train_dataloader
        self.out_dir_ckpt = out_dir_ckpt
        self.out_dir_eval = out_dir_eval
        self.out_dir_vis = out_dir_vis
        self.accumulation_steps = int(accumulation_steps)
        self.val_loaders = val_dataloaders or []
        self.vis_loaders = vis_dataloaders or []

        self._apply_surgery()

        opt_cfg = cfg.get("optimizer") or {}
        lrs = cfg.lr_scheduler.kwargs
        self.lr_schedule_fn = iter_exponential(
            int(lrs.total_iter), float(lrs.final_ratio), int(lrs.warmup_steps))
        # optimizer.split_accum needs no setting: accumulation always runs
        # as micro steps, then the update at the window boundary
        # (train_step.py)
        self.optimizer = make_optimizer(
            float(cfg.lr), self.lr_schedule_fn, self.accumulation_steps,
            name=opt_cfg.get("name", "adam"),
            # e.g. "bfloat16": the running sum in that dtype (opt-in)
            accum_dtype=opt_cfg.get("accum_dtype"),
            # ZeRO-1 over the mesh (ignored without one, as in JAX)
            mesh=self.mesh, shard_states=bool(opt_cfg.get("shard_states")),
        )
        self.state = self.optimizer.init(self._replicated(self._master_params()))
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

    def _replicated(self, params: dict) -> dict:
        """params with rank 0's values on every rank (in place)."""
        return params if self.mesh is None else broadcast_params(self.mesh, params)

    def _barrier(self) -> None:
        """After a pass of rank 0 alone: the others wait here, on the
        mesh's long host deadline, before their next collective."""
        if self.mesh is not None:
            self.mesh.barrier()

    def _time_is_up(self, t_end: Optional[datetime]) -> bool:
        """Rank 0's reading of its clock, on every rank (the JAX trainer
        lets each process read its own, so one may enter the save's gather
        while another enters the next micro-step's reduction)."""
        if t_end is None:
            return False
        up = datetime.now() >= t_end
        return self.mesh.broadcast_object(up) if self.mesh is not None else up

    def _local_batch(self, batch: dict) -> dict:
        """This rank's part of the global batch (module docstring)."""
        if self.mesh is None:
            return batch
        n_proc = int(getattr(self.train_loader, "shard_count", 1))
        if n_proc not in (1, self.mesh.size):
            raise ValueError(f"the loader strides over {n_proc} ranks, the "
                             f"mesh has {self.mesh.size}")
        lead = len(next(iter(batch.values()))) * n_proc
        if lead % self.mesh.size:
            raise ValueError(
                f"global batch ({lead}) must be a multiple of the mesh size "
                f"({self.mesh.size}) for data-parallel training")
        if n_proc > 1:
            return batch
        rows = self.mesh.rows(lead)
        return {k: v[rows] for k, v in batch.items()}

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
            # bool (yaml true/false) or "none" / "full" / "save_heavy"
            remat=cfg.trainer.get("remat", False),
            # e.g. "bfloat16": gradients stored in that dtype (opt-in)
            grad_dtype=(cfg.get("optimizer") or {}).get("grad_dtype"),
        )

    def _build_train_step(self):
        """(Re)build the step from the current core UNet and schedule,
        called at init and after load_checkpoint."""
        self.train_step, self.apply_step = make_train_step(
            self.core.unet, self.core.vae, self.core.schedule, self.optimizer,
            mesh=self.mesh, **self._step_kwargs())

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
            if self.is_main:
                self.validate()
            self._barrier()
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
                batch_dev = self._assemble_batch(self._local_batch(batch))
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
                    tb_logger.log_dict(
                        {"train/loss": loss, "train/grad_norm": entry["grad_norm"]},
                        global_step=self.effective_iter)
                    tb_logger.log_scalar("lr", entry["lr"], self.effective_iter)
                    tb_logger.log_scalar("n_batch_in_epoch", self.n_batch_in_epoch,
                                         self.effective_iter)
                    logger.info(f"iter {self.effective_iter:5d} (epoch "
                                f"{self.epoch:2d}): loss={loss:.5f}")

                    self._train_step_callback()

                    if self.max_iter > 0 and self.effective_iter >= self.max_iter:
                        self.save_checkpoint(self._get_backup_ckpt_name(),
                                             save_train_state=False)
                        logger.info("Training ended.")
                        return
                    if self._time_is_up(t_end):
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
            # rank 0 alone validates; its "best" save inside gathers
            # nothing, and the saves around it stay every rank's
            if self.is_main:
                self.validate()
            self._barrier()
            self.in_evaluation = False
            self.save_checkpoint("latest", save_train_state=True)

        if (self.save_period > 0 and 0 == self.effective_iter % self.save_period
                and not _is_latest_saved):
            self.save_checkpoint("latest", save_train_state=True)

        if self.vis_period > 0 and 0 == self.effective_iter % self.vis_period:
            if self.is_main:
                self.visualize()
            self._barrier()

    @property
    def n_ranks(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

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
            tb_logger.log_dict({f"val/{val_name}/{k}": v for k, v in result.items()},
                               global_step=self.effective_iter)
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
        """Rank 0 writes; with the optimizer state under ZeRO-1, every rank
        calls it (the state is gathered), in the one-rank file format."""
        st: TrainState = self.state
        opt_state = self.optimizer.export(st) if save_train_state else None
        if not self.is_main:
            return
        ckpt_dir = os.path.join(self.out_dir_ckpt, ckpt_name)
        logger.info(f"Saving checkpoint to {ckpt_dir}")
        trainer_state = {
            "effective_iter": self.effective_iter,
            "epoch": self.epoch,
            "n_batch_in_epoch": self.n_batch_in_epoch,
            "best_metric": float(self.best_metric),
            "in_evaluation": self.in_evaluation,
            "global_seed_sequence": self.global_seed_sequence,
            "step": st.step,
            # n_batch_in_epoch counts the batches of this rank count's
            # loader stream: a mid-epoch resume needs the same count
            "process_count": self.n_ranks,
        }
        save_train_ckpt(ckpt_dir, self.core.unet_cfg, st.params,
                        self.core.schedule, trainer_state, opt_state)

    def load_checkpoint(self, ckpt_dir: str, load_trainer_state: bool = True):
        logger.info(f"Loading checkpoint from {ckpt_dir}")
        unet_cfg, params, schedule, trainer_state, opt_state = load_train_state(
            ckpt_dir, load_opt_state=load_trainer_state)
        saved_n = int(trainer_state.get("process_count", 1))
        if load_trainer_state and saved_n != self.n_ranks and \
                int(trainer_state["n_batch_in_epoch"]) > 0:
            raise ValueError(
                f"checkpoint was saved mid-epoch by {saved_n} process(es) but "
                f"this run has {self.n_ranks}; resume with the same process "
                "count, or restart from an epoch boundary")
        if unet_cfg != self.core.unet_cfg:
            self._set_unet(unet_cfg, params)
        # the checkpoint's scheduler config is authoritative on resume
        self.core.schedule = schedule
        # every rank reads the file rank 0 wrote: the masters agree
        masters = {n: t.to(self.device).requires_grad_() for n, t in params.items()}
        self.state = self.optimizer.restore(masters, opt_state, self.device)
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


class MarigoldNormalsTrainer(MarigoldTrainerBase):
    modality = "normals"
    _apply_surgery = MarigoldDepthTrainer._apply_surgery  # conv_in to 8

    def _assemble_batch(self, batch):
        gt_type = self.cfg.get("gt_normals_type", "normals")
        return {"rgb_norm": _nchw(batch["rgb_norm"], self.device),
                "gt_norm": _nchw(batch[gt_type], self.device)}

    def validate_single_dataset(self, val_loader) -> dict:
        tracker = M.MetricTracker(*self.cfg.eval.eval_metrics)
        kwargs = self._val_pipe_kwargs()
        for batch in val_loader:
            rgb_int = np.asarray(batch["rgb_int"][0], np.uint8)
            pred = self.model(rgb_int, **kwargs).normals_np
            gt = np.asarray(batch["normals"][0])
            if pred.shape != gt.shape:
                pred = image_util.resize_np(pred, gt.shape[:2], "bilinear")
                pred /= np.clip(np.linalg.norm(pred, axis=-1, keepdims=True),
                                1e-6, None)
            err = M.compute_cosine_error(pred, gt, masked=True)
            for name in self.cfg.eval.eval_metrics:
                tracker.update(name, M.NORMALS_METRICS[name](err))
        return tracker.result()

    def _visualize_dataset(self, vis_loader, out_dir):
        kwargs = self._val_pipe_kwargs()
        for batch in vis_loader:
            rgb_int = np.asarray(batch["rgb_int"][0], np.uint8)
            out = self.model(rgb_int, **kwargs)
            name = os.path.splitext(
                os.path.basename(batch["rgb_relative_path"][0]))[0]
            out.normals_img.save(os.path.join(
                out_dir, f"iter_{self.effective_iter:06d}_{name}.png"))


class MarigoldIIDTrainer(MarigoldTrainerBase):
    modality = "iid"

    def _apply_surgery(self):
        if self.core.unet_cfg.in_channels == 4:
            cfg, sd = surgery.replace_conv_in_out_multimodal(
                self.core.unet_cfg, self.core.unet.state_dict(),
                len(self.model.target_names), self.core.vae_cfg.latent_channels)
            self._set_unet(cfg, sd)

    def _assemble_batch(self, batch):
        # rgb and each target: [0, 1] -> [-1, 1] (reference :286-288)
        rgb = _nchw(batch["rgb"], self.device) * 2.0 - 1.0
        targets = [_nchw(batch[t], self.device) * 2.0 - 1.0
                   for t in self.model.target_names]
        out = {"rgb_norm": rgb, "gt_norm": torch.cat(targets, dim=1)}
        if self.gt_mask_type is not None:
            out["valid_mask"] = _nchw(batch[self.gt_mask_type], self.device,
                                      torch.bool)
        return out

    def validate_single_dataset(self, val_loader) -> dict:
        tracker = M.MetricTracker()
        kwargs = self._val_pipe_kwargs()
        use_mask = bool(self.cfg.validation.get("use_mask", False))
        for batch in val_loader:
            rgb01 = np.asarray(batch["rgb"][0], np.float32)
            out = self.model(rgb01, **kwargs)
            for t in self.model.target_names:
                pred = np.moveaxis(out[t].array, 0, -1)  # [H, W, 3]
                gt = np.asarray(batch[t][0])
                if pred.shape != gt.shape:
                    pred = image_util.resize_np(pred, gt.shape[:2], "bilinear")
                mask = None
                if use_mask and f"mask_{t}" in batch:
                    mask = np.asarray(batch[f"mask_{t}"][0], bool)
                tracker.update(f"psnr_{t}", M.compute_iid_metric(
                    pred, gt, t, M.psnr, valid_mask=mask, metric_name="psnr"))
        result = tracker.result()
        result["psnr"] = float(np.mean(list(result.values()))) if result else 0.0
        return result

    def _visualize_dataset(self, vis_loader, out_dir):
        kwargs = self._val_pipe_kwargs()
        for batch in vis_loader:
            rgb01 = np.asarray(batch["rgb"][0], np.float32)
            out = self.model(rgb01, **kwargs)
            name = os.path.splitext(
                os.path.basename(batch["rgb_relative_path"][0]))[0]
            for entry in out:
                entry.image.save(os.path.join(
                    out_dir, f"iter_{self.effective_iter:06d}_{name}_{entry.name}.png"))


trainer_name_class_dict = {
    "MarigoldDepthTrainer": MarigoldDepthTrainer,
    "MarigoldNormalsTrainer": MarigoldNormalsTrainer,
    "MarigoldIIDTrainer": MarigoldIIDTrainer,
}


def get_trainer_cls(trainer_name: str):
    """Registry (reference src/trainer/__init__.py:36-44)."""
    return trainer_name_class_dict[trainer_name]
