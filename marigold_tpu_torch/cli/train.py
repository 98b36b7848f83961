"""Training entry point.

Counterpart of `marigold_tpu/cli/train.py` (role parity:
script/{depth,normals,iid}/train.py): config, resume and output dirs,
logger and TensorBoard init, the mixed train dataset with its sampler and
loader, the val and vis loaders, the base-checkpoint load, the trainer
dispatch, the --exit_after time budget and resume from a run dir, on one
GPU (`--device cuda`, the default, which raises without a card) or on the
CPU when asked (`--device cpu`).

Example:
  python -m marigold_tpu_torch.cli.train \\
      --config config/train_marigold_depth.yaml \\
      --base_ckpt_dir ckpt/ --base_data_dir data/ --output_dir output/run1

The JAX CLI's multi-device flags: `--data_parallel` and
`--shard_optimizer` warn and train on one device when one GPU is visible;
with more than one, or with `--multihost`, they raise NotImplementedError
(ROADMAP queue 1, "Multi-GPU").
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import shutil
from datetime import datetime, timedelta

from marigold_tpu_torch.cli import add_device_argument

ROADMAP_MULTI_GPU = "ROADMAP queue 1, 'Multi-GPU'"
SNAPSHOT_SUFFIXES = (".py", ".cu", ".cuh")


def build_parser():
    parser = argparse.ArgumentParser(description="Train a Marigold model (PyTorch port)")
    parser.add_argument("--config", type=str,
                        default="config/train_marigold_depth.yaml")
    parser.add_argument("--resume_run", type=str, default=None,
                        help="Path of checkpoint to resume, e.g. "
                             "output/run/checkpoint/latest")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--base_data_dir", type=str, default=None,
                        help="Defaults to $BASE_DATA_DIR")
    parser.add_argument("--base_ckpt_dir", type=str, default=None,
                        help="Defaults to $BASE_CKPT_DIR")
    parser.add_argument("--exit_after", type=int, default=-1,
                        help="Save and exit after this many minutes")
    parser.add_argument("--no_val", action="store_true")
    parser.add_argument("--no_wandb", action="store_true",
                        help="disable wandb tracking (reference --no_wandb; "
                             "noop when wandb is not installed)")
    parser.add_argument("--add_datetime_prefix", action="store_true",
                        help="prefix the run dir name with the start "
                             "datetime (reference --add_datetime_prefix)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="data parallelism over the visible GPUs: with "
                             "one GPU, trains on it (with a warning); with "
                             "more, not ported yet")
    parser.add_argument("--shard_optimizer", action="store_true",
                        help="ZeRO-1 with --data_parallel: not ported yet; "
                             "without a multi-GPU mesh it has no effect")
    parser.add_argument("--do_not_copy_data", action="store_true",
                        help="(Slurm) do not copy data to local scratch")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host training: not ported yet")
    add_device_argument(parser, help="device the trainer runs on (default "
                                     "cuda; cpu runs the kernels' plain "
                                     "versions)")
    return parser


def _check_devices(args) -> None:
    """The multi-device flags on one device: warn, as the JAX CLI does with
    one chip; on several GPUs, or multi-host, raise."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a GPU and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to train on the CPU")
    if args.multihost:
        raise NotImplementedError(
            f"--multihost is not ported yet: {ROADMAP_MULTI_GPU}")
    n_dev = torch.cuda.device_count() if args.device == "cuda" else 1
    if args.data_parallel:
        if n_dev > 1:
            raise NotImplementedError(
                f"--data_parallel over {n_dev} GPUs is not ported yet: "
                f"{ROADMAP_MULTI_GPU}")
        logging.warning("--data_parallel requested but only one device "
                        "is available; training single-device")
    if args.shard_optimizer:
        logging.warning("--shard_optimizer has no effect without a "
                        ">1-device --data_parallel mesh")


def _write_code_snapshot(out_dir_run: str) -> None:
    """The port's sources (.py and the CUDA .cu/.cuh) as
    code_snapshot.tar in the run dir (reference train.py:217-231)."""
    import tarfile

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    snap = os.path.join(out_dir_run, "code_snapshot.tar")
    with tarfile.open(snap, "w") as tar:
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", "_build"))
            for fn in sorted(filenames):
                if fn.endswith(SNAPSHOT_SUFFIXES):
                    full = os.path.join(dirpath, fn)
                    tar.add(full, arcname=os.path.relpath(
                        full, os.path.dirname(pkg_dir)))
    logging.info(f"code snapshot: {snap}")


def setup(argv=None):
    """Everything of `main` up to the training loop: -> (trainer, t_end)."""
    args = build_parser().parse_args(argv)
    _check_devices(args)

    import torch

    from marigold_tpu_torch import (
        MarigoldDepthPipeline,
        MarigoldIIDPipeline,
        MarigoldNormalsPipeline,
    )
    from marigold_tpu_torch.config import recursive_load_config
    from marigold_tpu_torch.data import (
        ConcatDataset,
        DataLoader,
        DatasetMode,
        MixedBatchSampler,
        get_dataset,
    )
    from marigold_tpu_torch.train.trainer import get_trainer_cls
    from marigold_tpu_torch.utils.depth_transform import get_depth_normalizer
    from marigold_tpu_torch.utils.logging_util import (
        config_logging,
        get_local_scratch_dir,
        init_wandb,
        is_on_slurm,
        load_wandb_job_id,
        log_slurm_job_id,
        save_wandb_job_id,
        tb_logger,
    )
    from marigold_tpu_torch.utils.seeding import seed_all

    t_start = datetime.now()
    base_data_dir = args.base_data_dir or os.environ.get("BASE_DATA_DIR")
    base_ckpt_dir = args.base_ckpt_dir or os.environ.get("BASE_CKPT_DIR")

    resume_run = args.resume_run
    if resume_run is not None:
        out_dir_run = os.path.dirname(os.path.dirname(resume_run))
        cfg = recursive_load_config(os.path.join(out_dir_run, "config.yaml"))
    else:
        cfg = recursive_load_config(args.config)
        run_name = os.path.splitext(os.path.basename(args.config))[0]
        if args.add_datetime_prefix:
            run_name = f"{t_start.strftime('%y_%m_%d-%H_%M_%S')}-{run_name}"
        out_dir_run = os.path.join(args.output_dir or "output", run_name)
        # exist_ok=False like the reference (train.py:163): a rerun of the
        # same config must not write into the previous run's directory
        os.makedirs(out_dir_run, exist_ok=False)

    out_dir_ckpt = os.path.join(out_dir_run, "checkpoint")
    out_dir_tb = os.path.join(out_dir_run, "tensorboard")
    out_dir_eval = os.path.join(out_dir_run, "evaluation")
    out_dir_vis = os.path.join(out_dir_run, "visualization")
    for d in (out_dir_ckpt, out_dir_tb, out_dir_eval, out_dir_vis):
        os.makedirs(d, exist_ok=True)

    config_logging(cfg.get("logging", {}), out_dir=out_dir_run)
    logging.info(f"config: {args.config}; output: {out_dir_run}")
    tb_logger.set_dir(out_dir_tb)

    # wandb wrapping tensorboard, with run-ID persistence across resume
    # (reference train.py:185-210; noop without the package)
    wandb_kwargs = dict(cfg.get("wandb", {}) or {})
    wandb_kwargs.setdefault("project", "marigold_tpu")
    wandb_kwargs.update(name=os.path.basename(out_dir_run), dir=out_dir_run,
                        config={"entry": "train", "config": args.config})
    if resume_run is not None:
        prev_id = load_wandb_job_id(out_dir_run)
        if prev_id is not None:
            wandb_kwargs.update(id=prev_id, resume="must")
    wandb_run = init_wandb(enable=not args.no_wandb, **wandb_kwargs)
    if not args.no_wandb:
        # only a real run id may be persisted: a disabled-mode run's id
        # would poison a later resume="must"
        save_wandb_job_id(wandb_run, out_dir_run)
    log_slurm_job_id()

    if resume_run is None:
        import yaml

        with open(os.path.join(out_dir_run, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg.to_dict(), f)
        try:
            _write_code_snapshot(out_dir_run)
        except Exception:
            logging.exception("code snapshot failed (continuing)")

    # Slurm local-scratch data copy (reference train.py:233-252)
    if is_on_slurm() and not args.do_not_copy_data and base_data_dir:
        scratch = get_local_scratch_dir()
        if scratch:
            local = os.path.join(scratch, "train_data")
            logging.info(f"copying data to local scratch: {local}")
            shutil.copytree(base_data_dir, local, dirs_exist_ok=True)
            base_data_dir = local

    loader_seed = cfg.dataloader.get("seed")
    if loader_seed is not None:
        seed_all(loader_seed)

    # effective batch / accumulation (reference train.py:254-262)
    eff_bs = int(cfg.dataloader.effective_batch_size)
    max_bs = int(cfg.dataloader.max_train_batch_size)
    if eff_bs % max_bs:
        raise ValueError(f"effective_batch_size {eff_bs} must be divisible by "
                         f"max_train_batch_size {max_bs}")
    accumulation_steps = eff_bs // max_bs
    logging.info(f"effective batch size: {eff_bs}, accumulation steps: "
                 f"{accumulation_steps}")

    extra_kwargs = {}
    if cfg.get("depth_normalization") is not None:
        extra_kwargs["depth_transform"] = get_depth_normalizer(
            cfg.depth_normalization.to_dict())
    train_datasets = get_dataset(
        cfg.dataset.train, base_data_dir=base_data_dir, mode=DatasetMode.TRAIN,
        augmentation_args=dict(cfg.get("augmentation") or {}), **extra_kwargs)
    if not isinstance(train_datasets, list):
        train_datasets = [train_datasets]
    sampler = MixedBatchSampler(
        train_datasets, batch_size=max_bs, shuffle=True,
        prob=list(cfg.dataset.train.get("prob_ls") or []) or None,
        generator=random.Random(loader_seed))
    train_loader = DataLoader(
        ConcatDataset(train_datasets), batch_sampler=sampler,
        num_workers=int(cfg.dataloader.get("num_workers", 0)),
        # the per-batch augmentation seeds derive from it (loader.py)
        seed=loader_seed)

    def _mk_eval_loaders(split):
        return [DataLoader(get_dataset(c, base_data_dir=base_data_dir,
                                       mode=DatasetMode.EVAL, **extra_kwargs),
                           batch_size=1)
                for c in cfg.dataset.get(split) or []]

    val_loaders = [] if args.no_val else _mk_eval_loaders("val")
    vis_loaders = _mk_eval_loaders("vis")

    # the base pipeline checkpoint (vanilla SD2 for fresh runs)
    pipe_cls = {
        "MarigoldDepthPipeline": MarigoldDepthPipeline,
        "MarigoldNormalsPipeline": MarigoldNormalsPipeline,
        "MarigoldIIDPipeline": MarigoldIIDPipeline,
    }[cfg.pipeline.name]
    ckpt_path = os.path.join(base_ckpt_dir or "", cfg.model.pretrained_path)
    pipe = pipe_cls.from_pretrained(ckpt_path, dtype=torch.bfloat16,
                                    device=args.device)
    # pipeline kwargs from the training config override the base checkpoint
    pipe.pipe_cfg.update(dict(cfg.pipeline.get("kwargs") or {}))
    pipe.default_denoising_steps = pipe.pipe_cfg.get("default_denoising_steps")
    pipe.default_processing_resolution = pipe.pipe_cfg.get(
        "default_processing_resolution")
    if cfg.pipeline.name == "MarigoldIIDPipeline":
        pipe.target_properties = pipe.pipe_cfg.get("target_properties") or {}
        pipe.target_names = pipe.target_properties["target_names"]
        pipe.n_targets = len(pipe.target_names)

    trainer = get_trainer_cls(cfg.trainer.name)(
        cfg=cfg, model=pipe, train_dataloader=train_loader,
        out_dir_ckpt=out_dir_ckpt, out_dir_eval=out_dir_eval,
        out_dir_vis=out_dir_vis, accumulation_steps=accumulation_steps,
        val_dataloaders=val_loaders, vis_dataloaders=vis_loaders)
    if resume_run is not None:
        trainer.load_checkpoint(resume_run, load_trainer_state=True)

    t_end = (t_start + timedelta(minutes=args.exit_after)
             if args.exit_after > 0 else None)
    return trainer, t_end


def run(trainer, t_end=None) -> int:
    """The training loop of `main` on a trainer from `setup`."""
    try:
        trainer.train(t_end=t_end)
    except Exception:
        logging.exception("training failed")
        raise
    return 0


def main(argv=None):
    return run(*setup(argv))


if __name__ == "__main__":
    raise SystemExit(main())
