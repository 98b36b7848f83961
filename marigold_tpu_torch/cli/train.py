"""Training entry point.

Counterpart of `marigold_tpu/cli/train.py` (role parity:
script/{depth,normals,iid}/train.py): config, resume and output dirs,
logger and TensorBoard init, the mixed train dataset with its sampler and
loader, the val and vis loaders, the base-checkpoint load, the trainer
dispatch, the --exit_after time budget and resume from a run dir, on one
GPU (`--device cuda`, the default, which raises without a card), across
GPUs, or on the CPU when asked (`--device cpu`, gloo ranks across
processes).

Example:
  python -m marigold_tpu_torch.cli.train \\
      --config config/train_marigold_depth.yaml \\
      --base_ckpt_dir ckpt/ --base_data_dir data/ --output_dir output/run1

Across GPUs, the JAX CLI's flags with their meaning, one rank (process) per
GPU (`train/trainer.py`):
  --data_parallel: under torchrun (`torchrun --nproc_per_node N -m
    marigold_tpu_torch.cli.train --data_parallel ...`), or in a process
    group already made, the CLI joins it; with several GPUs visible and no
    group, it spawns one rank per GPU itself over NCCL. Every rank reads the
    whole seeded loader stream and keeps its rows of each batch, so the
    batch and the effective batch are the config's. With one GPU it warns
    and trains on it.
  --multihost --data_parallel: the group from MARIGOLD_TPU_COORDINATOR
    (host:port), MARIGOLD_TPU_NUM_PROCESSES and MARIGOLD_TPU_PROCESS_ID, or
    from torchrun's variables; each rank takes every N-th batch of the
    shared stream and the global batch is their concatenation, N times the
    config's batch (and effective batch).
  --shard_optimizer: ZeRO-1 with either (Adam's moments and the
    accumulator split over the ranks); without a mesh it warns.
Rank 0 creates the run dir and writes a marker with its run token, which
the other ranks wait for; it alone logs to the run dir, TensorBoard and
wandb. A rank that fails fails the run.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import shutil
import sys
import time
from datetime import datetime, timedelta

from marigold_tpu_torch.cli import add_device_argument

SNAPSHOT_SUFFIXES = (".py", ".cu", ".cuh")
_RUN_MARKER = ".run_marker"


def _wait_for_dir(path: str, token: str, timeout_s: float = 120.0) -> None:
    """Block until rank 0 has created `path` for this run: a directory left
    by an earlier run is not enough (the other ranks would train into it
    while rank 0 fails with FileExistsError), so rank 0 writes the
    broadcast run token into a marker file and this waits for a matching
    one."""
    marker = os.path.join(path, _RUN_MARKER)
    deadline = time.monotonic() + timeout_s
    while True:
        if os.path.isfile(marker):
            try:
                with open(marker) as f:
                    if f.read().strip() == token:
                        return
            except OSError:
                pass
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"run dir {path} was not created by rank 0 (marker with token "
                f"{token!r}) within {timeout_s:.0f}s; if the dir exists from "
                "an earlier run, rank 0 has failed with FileExistsError: "
                "remove it or use --add_datetime_prefix")
        time.sleep(0.5)


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
                        help="one rank per GPU, each on its rows of every "
                             "batch, gradients summed over the ranks: joins "
                             "torchrun's (or an existing) process group, else "
                             "spawns one rank per visible GPU; the effective "
                             "batch is the config's. Requires "
                             "max_train_batch_size % n_ranks == 0.")
    parser.add_argument("--shard_optimizer", action="store_true",
                        help="ZeRO-1 with --data_parallel: Adam's m and v and "
                             "the accumulation buffer split over the ranks "
                             "(the same parameters as the replicated update)")
    parser.add_argument("--do_not_copy_data", action="store_true",
                        help="(Slurm) do not copy data to local scratch")
    parser.add_argument("--multihost", action="store_true",
                        help="with --data_parallel: ranks on several hosts, "
                             "from MARIGOLD_TPU_COORDINATOR/NUM_PROCESSES/"
                             "PROCESS_ID or torchrun's variables; each rank "
                             "takes every N-th batch of the shared stream")
    add_device_argument(parser, help="device the trainer runs on (default "
                                     "cuda; cpu runs the kernels' plain "
                                     "versions)")
    return parser


def _check_device(args) -> None:
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a GPU and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to train on the CPU")


def _ranks_to_spawn(args) -> int:
    """The ranks `main` spawns itself: one per visible GPU under
    --data_parallel on one host when several are visible, no process group
    exists and no launcher names a cluster; else 0."""
    import torch
    import torch.distributed as dist

    from marigold_tpu_torch.parallel.mesh import cluster_named

    if not args.data_parallel or args.multihost or args.device != "cuda" or \
            dist.is_initialized() or cluster_named():
        return 0
    n = torch.cuda.device_count()
    return n if n > 1 else 0


def _join(args):
    """This rank's mesh under --data_parallel: the process group that exists,
    or one initialised from the launch variables; None for one process
    (with the JAX CLI's warnings)."""
    import torch.distributed as dist

    from marigold_tpu_torch.parallel.mesh import get_mesh, init_distributed

    mesh = None
    if args.data_parallel or args.multihost:
        device = "cpu" if args.device == "cpu" else None
        init_distributed(device=device)
        if args.multihost and not dist.is_initialized():
            raise ValueError(
                "coordinator_address should be defined: --multihost needs "
                "MARIGOLD_TPU_COORDINATOR, MARIGOLD_TPU_NUM_PROCESSES and "
                "MARIGOLD_TPU_PROCESS_ID, or torchrun's variables")
        if args.multihost and not args.data_parallel:
            raise ValueError("--multihost trains with --data_parallel: without "
                             "it every rank would train a model of its own")
        if dist.is_initialized() and dist.get_world_size() > 1:
            mesh = get_mesh(device=device)
            logging.info(f"data-parallel training over {mesh.size} ranks, "
                         f"rank {mesh.rank} on {mesh.device}")
        else:
            logging.warning("--data_parallel requested but only one device "
                            "is available; training single-device")
    if args.shard_optimizer and mesh is None:
        logging.warning("--shard_optimizer has no effect without a "
                        ">1-device --data_parallel mesh")
    return mesh


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
    """Everything of `main` up to the training loop, in this process (one
    rank of the group when one exists): -> (trainer, t_end)."""
    args = build_parser().parse_args(argv)
    _check_device(args)

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

    # before any file or wandb side effect, so that rank 0 alone makes them
    mesh = _join(args)
    is_main = mesh is None or mesh.rank == 0
    device = args.device if mesh is None else str(mesh.device)
    if mesh is not None and mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    # every rank's run token is rank 0's: it prefixes the run dir under
    # --add_datetime_prefix and marks the dir as this run's
    run_token = t_start.strftime("%y_%m_%d-%H_%M_%S")
    if mesh is not None:
        run_token = mesh.broadcast_object(run_token)

    resume_run = args.resume_run
    if resume_run is not None:
        out_dir_run = os.path.dirname(os.path.dirname(resume_run))
        cfg = recursive_load_config(os.path.join(out_dir_run, "config.yaml"))
    else:
        cfg = recursive_load_config(args.config)
        run_name = os.path.splitext(os.path.basename(args.config))[0]
        if args.add_datetime_prefix:
            run_name = f"{run_token}-{run_name}"
        out_dir_run = os.path.join(args.output_dir or "output", run_name)
        if is_main:
            # exist_ok=False like the reference (train.py:163): a rerun of
            # the same config must not write into the previous run's dir
            os.makedirs(out_dir_run, exist_ok=False)
            if mesh is not None:
                with open(os.path.join(out_dir_run, _RUN_MARKER), "w") as f:
                    f.write(run_token)
        else:
            _wait_for_dir(out_dir_run, run_token)

    out_dir_ckpt = os.path.join(out_dir_run, "checkpoint")
    out_dir_tb = os.path.join(out_dir_run, "tensorboard")
    out_dir_eval = os.path.join(out_dir_run, "evaluation")
    out_dir_vis = os.path.join(out_dir_run, "visualization")
    for d in (out_dir_ckpt, out_dir_tb, out_dir_eval, out_dir_vis):
        os.makedirs(d, exist_ok=True)

    # the other ranks log to the console only
    config_logging(cfg.get("logging", {}),
                   out_dir=out_dir_run if is_main else None)
    logging.info(f"config: {args.config}; output: {out_dir_run}")
    if is_main:
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
    wandb_run = init_wandb(enable=is_main and not args.no_wandb, **wandb_kwargs)
    if is_main and not args.no_wandb:
        # only a real run id may be persisted: a disabled-mode run's id
        # would poison a later resume="must"
        save_wandb_job_id(wandb_run, out_dir_run)
    log_slurm_job_id()

    if resume_run is None and is_main:
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
    # --multihost: the ranks share the seeded stream and each takes its
    # stride; else every rank reads the whole stream and keeps its rows
    n_shard, i_shard = ((mesh.size, mesh.rank) if args.multihost and mesh
                        else (1, 0))
    if n_shard > 1:
        logging.info(f"data sharding: rank {i_shard}/{n_shard} takes every "
                     f"{n_shard}-th batch")
    train_loader = DataLoader(
        ConcatDataset(train_datasets), batch_sampler=sampler,
        num_workers=int(cfg.dataloader.get("num_workers", 0)),
        # the per-batch augmentation seeds derive from it (loader.py)
        seed=loader_seed, shard_count=n_shard, shard_index=i_shard)

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
    # without the mesh: rank 0 validates alone, a whole request per image
    pipe = pipe_cls.from_pretrained(ckpt_path, dtype=torch.bfloat16,
                                    device=device)
    # pipeline kwargs from the training config override the base checkpoint
    pipe.pipe_cfg.update(dict(cfg.pipeline.get("kwargs") or {}))
    pipe.default_denoising_steps = pipe.pipe_cfg.get("default_denoising_steps")
    pipe.default_processing_resolution = pipe.pipe_cfg.get(
        "default_processing_resolution")
    if cfg.pipeline.name == "MarigoldIIDPipeline":
        pipe.target_properties = pipe.pipe_cfg.get("target_properties") or {}
        pipe.target_names = pipe.target_properties["target_names"]
        pipe.n_targets = len(pipe.target_names)

    if args.shard_optimizer and mesh is not None:
        # a plain dict: Config.__getattr__ wraps nested dicts in a fresh
        # object, so an attribute write would not persist into cfg
        cfg["optimizer"] = dict(cfg.get("optimizer") or {}, shard_states=True)

    trainer = get_trainer_cls(cfg.trainer.name)(
        cfg=cfg, model=pipe, train_dataloader=train_loader,
        out_dir_ckpt=out_dir_ckpt, out_dir_eval=out_dir_eval,
        out_dir_vis=out_dir_vis, accumulation_steps=accumulation_steps,
        val_dataloaders=val_loaders, vis_dataloaders=vis_loaders, mesh=mesh)
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


def _spawned_rank(mesh, argv: list) -> int:
    """One rank that `main` spawned: the group exists, so setup joins it."""
    return run(*setup(argv))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _check_device(args)
    n = _ranks_to_spawn(args)
    if n:
        from marigold_tpu_torch.parallel.mesh import run_on_ranks

        logging.info(f"--data_parallel: spawning one rank per GPU, {n} over NCCL")
        return max(run_on_ranks(_spawned_rank, n, (argv,), device="cuda",
                                backend="nccl", timeout_s=None))
    return run(*setup(argv))


if __name__ == "__main__":
    raise SystemExit(main())
