"""Crash-safe training checkpoints.

Counterpart of `marigold_tpu/train/checkpoints.py`. A checkpoint dir holds
  * unet/ in diffusers layout (config.json + diffusion_pytorch_model
    .safetensors, fp32), so composed pipeline checkpoints stay loadable by
    the JAX package and the reference stack;
  * scheduler/scheduler_config.json;
  * opt_state.safetensors (optional): the optimizer state as named tensors,
    "<group>.<param>" for the update rule's groups (Adam "mu", "nu";
    Adafactor "v_row", "v_col", "v") and "acc" (mid-window only), and the
    0-d int64 counters "count", "mini_step";
  * trainer.json: the trainer's position (effective iter, epoch, batch in
    epoch, best metric, in_evaluation, seed sequence, micro-step count).
No pickle. An existing dir is renamed `_old_<name>` before the write and
removed only after it succeeded; on a failure the old dir is restored.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch

from marigold_tpu_torch.core.scheduler import DiffusionSchedule
from marigold_tpu_torch.models import weights as W
from marigold_tpu_torch.models.unet import UNetConfig

UNET_FILE = "diffusion_pytorch_model.safetensors"
OPT_FILE = "opt_state.safetensors"
_COUNTERS = ("count", "mini_step")


def flatten_opt_state(opt_state: dict) -> dict[str, torch.Tensor]:
    """{<group>: {param: tensor}, "acc": {...} or None, "count": int,
    "mini_step": int} -> named tensors."""
    flat = {}
    for group, tensors in opt_state.items():
        if group not in _COUNTERS:
            for name, t in (tensors or {}).items():
                flat[f"{group}.{name}"] = t
    for c in _COUNTERS:
        flat[c] = torch.tensor(int(opt_state[c]), dtype=torch.int64)
    return flat


def unflatten_opt_state(flat: dict[str, torch.Tensor]) -> dict:
    out: dict[str, Any] = {"acc": {}}
    for key, t in flat.items():
        if key in _COUNTERS:
            out[key] = int(t)
        else:
            group, name = key.split(".", 1)
            out.setdefault(group, {})[name] = t
    out["acc"] = out["acc"] or None
    return out


def save_train_state(ckpt_dir: str, unet_cfg: UNetConfig, unet_params: dict,
                     schedule: DiffusionSchedule, trainer_state: dict,
                     opt_state: Optional[dict] = None) -> None:
    """Write ckpt_dir/{unet/, scheduler/, opt_state.safetensors,
    trainer.json}, keeping the old dir as _old_* during the write."""
    parent = os.path.dirname(ckpt_dir.rstrip("/")) or "."
    name = os.path.basename(ckpt_dir.rstrip("/"))
    os.makedirs(parent, exist_ok=True)
    tmp_old = os.path.join(parent, f"_old_{name}")
    if os.path.exists(ckpt_dir):
        if os.path.exists(tmp_old):
            shutil.rmtree(tmp_old)
        os.rename(ckpt_dir, tmp_old)
    try:
        os.makedirs(ckpt_dir, exist_ok=True)
        W.save_component(unet_cfg.to_dict(),
                         {n: p.detach().float() for n, p in unet_params.items()},
                         os.path.join(ckpt_dir, "unet"), UNET_FILE)
        schedule.save_pretrained(os.path.join(ckpt_dir, "scheduler"))
        if opt_state is not None:
            W.write_safetensors(flatten_opt_state(opt_state),
                                os.path.join(ckpt_dir, OPT_FILE))
        with open(os.path.join(ckpt_dir, "trainer.json"), "w") as f:
            json.dump(trainer_state, f, indent=2)
    except BaseException:
        if os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        if os.path.exists(tmp_old):
            os.rename(tmp_old, ckpt_dir)
        raise
    if os.path.exists(tmp_old):
        shutil.rmtree(tmp_old)


def load_train_state(ckpt_dir: str, load_opt_state: bool = True):
    """-> (unet_cfg, unet_params name -> fp32 CPU tensor, schedule,
    trainer_state dict, opt_state dict or None)."""
    unet_dir = os.path.join(ckpt_dir, "unet")
    unet_cfg = UNetConfig.from_dict(W.read_config(unet_dir))
    params = {n: t.float() for n, t in W.load_state_dict(unet_dir).items()}
    schedule = DiffusionSchedule.from_pretrained(os.path.join(ckpt_dir, "scheduler"))
    with open(os.path.join(ckpt_dir, "trainer.json")) as f:
        trainer_state = json.load(f)
    opt_state = None
    opt_path = os.path.join(ckpt_dir, OPT_FILE)
    if load_opt_state and os.path.exists(opt_path):
        opt_state = unflatten_opt_state(W.read_safetensors(opt_path))
    return unet_cfg, params, schedule, trainer_state, opt_state
