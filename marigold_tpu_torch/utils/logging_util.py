"""Logging & experiment tracking.

Copy of `marigold_tpu/utils/logging_util.py` for the PyTorch port
(framework free; `wandb` and the TensorBoard writer are imported lazily).

Behavioral reference: src/util/logging_util.py — root-logger file+console
config from YAML (:39-66), a TensorBoard wrapper with a module-global
`tb_logger` (:69-91), `eval_dict_to_text` tabulation (:123-129), Slurm
job-id logging (:103-109). (wandb is not available in this image; the
tracking role is covered by TensorBoard event files.)
"""

from __future__ import annotations

import logging
import os
from typing import Optional


def config_logging(cfg_logging, out_dir: Optional[str] = None) -> None:
    file_level = cfg_logging.get("file_level", 10)
    console_level = cfg_logging.get("console_level", 20)
    fmt = cfg_logging.get(
        "format",
        "%(asctime)s - %(levelname)s - %(name)s >> %(message)s",
    )
    formatter = logging.Formatter(fmt)
    root = logging.getLogger()
    root.setLevel(min(file_level, console_level))

    console = logging.StreamHandler()
    console.setFormatter(formatter)
    console.setLevel(console_level)
    root.addHandler(console)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        fpath = os.path.join(out_dir, cfg_logging.get("filename", "logging.log"))
        fh = logging.FileHandler(fpath)
        fh.setFormatter(formatter)
        fh.setLevel(file_level)
        root.addHandler(fh)


class TrainingLogger:
    """TensorBoard wrapper (reference MyTrainingLogger). Writer is created
    lazily; absence of tensorboard degrades to logging only."""

    def __init__(self):
        self._writer = None
        self.log_dir = None

    def set_dir(self, log_dir: str):
        self.log_dir = log_dir
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:
            try:
                from tensorboardX import SummaryWriter  # type: ignore

                self._writer = SummaryWriter(log_dir)
            except Exception:
                logging.warning("tensorboard unavailable; scalar logging only")
                self._writer = None

    @property
    def writer(self):
        return self._writer

    def log_scalar(self, tag, value, global_step=None):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, global_step=global_step)

    def log_dict(self, scalar_dict, global_step=None, walltime=None):
        for k, v in scalar_dict.items():
            self.log_scalar(k, v, global_step)

    def log_image(self, tag, img_hwc, global_step=None):
        if self._writer is not None:
            self._writer.add_image(tag, img_hwc, global_step=global_step,
                                   dataformats="HWC")

    def flush(self):
        if self._writer is not None:
            self._writer.flush()


# module-global, like the reference's tb_logger (logging_util.py:91)
tb_logger = TrainingLogger()


# -------------- wandb tools (reference logging_util.py:95-120) -------- #
# wandb is optional: absent from this image, every call degrades to a noop
# so training runs identically with TensorBoard-only tracking.


def init_wandb(enable: bool, **kwargs):
    """Reference init_wandb: wandb.init(sync_tensorboard=True, **kwargs)
    when enabled, disabled-mode run otherwise. Returns None when the
    package is unavailable."""
    try:
        import wandb  # type: ignore
    except ImportError:
        if enable:
            logging.warning("wandb requested but not installed; tracking "
                            "continues via TensorBoard only")
        return None
    if enable:
        return wandb.init(sync_tensorboard=True, **kwargs)
    return wandb.init(mode="disabled")


def save_wandb_job_id(run, out_dir: str) -> None:
    """Persist the run id so --resume_run reattaches to the same wandb run
    (reference save_wandb_job_id)."""
    if run is None:
        return
    with open(os.path.join(out_dir, "WANDB_ID"), "w+") as f:
        f.write(run.id)


def load_wandb_job_id(out_dir: str) -> Optional[str]:
    path = os.path.join(out_dir, "WANDB_ID")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def eval_dict_to_text(val_metrics: dict, dataset_name: str, sample_list_path: str) -> str:
    from tabulate import tabulate

    text = f"Evaluation metrics:\n\
     on dataset: {dataset_name}\n\
     over samples in: {sample_list_path}\n"
    text += tabulate([val_metrics.keys(), val_metrics.values()])
    return text


def log_slurm_job_id(step=0) -> None:
    job_id = os.environ.get("SLURM_JOB_ID")
    if job_id is not None:
        tb_logger.log_scalar("slurm_job_id", float(job_id), step)
        logging.info(f"Slurm job ID: {job_id}")


def is_on_slurm() -> bool:
    return "SLURM_JOB_ID" in os.environ


def get_local_scratch_dir() -> Optional[str]:
    return os.environ.get("TMPDIR")
