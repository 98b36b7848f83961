"""DDIM schedule (trailing spacing, zero-terminal-SNR) for the PyTorch port.

Mirrors `marigold_tpu/core/scheduler.py`: the tables are numpy (fp32
alphas_cumprod built in float64 and rounded once), and `ddim_step` runs on
tensors with fp32 scalar math, so a bf16 latent is stepped in fp32 and
stored back in its own dtype. Deterministic DDIM (eta = 0), as the
reference pipelines use it. The training forward process (`add_noise`,
`velocity`, `training_target`) runs in fp32 with `t` a [B] tensor
broadcast over the batch.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import numpy as np
import torch


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
) -> np.ndarray:
    """Beta table. `scaled_linear` is the SD2 schedule."""
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps, dtype=np.float64)

        def f(u):
            return np.cos((u / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2

        return np.clip(1.0 - f(t + 1) / f(t), 0.0, 0.999)
    raise ValueError(f"unknown beta_schedule: {beta_schedule}")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal SNR is exactly zero (Lin et al.)."""
    abar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    first, last = abar_sqrt[0].copy(), abar_sqrt[-1].copy()
    abar_sqrt = (abar_sqrt - last) * first / (first - last)
    abar = abar_sqrt**2
    alphas = np.empty_like(abar)
    alphas[0] = abar[0]
    alphas[1:] = abar[1:] / abar[:-1]
    return 1.0 - alphas


def trailing_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """Trailing spacing: the first step is always t = T-1."""
    step = num_train_timesteps / num_inference_steps
    return np.round(np.arange(num_train_timesteps, 0, -step)).astype(np.int64) - 1


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int,
                      steps_offset: int = 0) -> np.ndarray:
    step = num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * step).round()[::-1].astype(np.int64)
    return ts + steps_offset


def linspace_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    return (np.linspace(0, num_train_timesteps - 1, num_inference_steps)
            .round()[::-1].astype(np.int64))


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Schedule tables + config (diffusers DDIMScheduler's inference role)."""

    alphas_cumprod: np.ndarray  # [T] fp32
    final_alpha_cumprod: np.float32  # alpha for "step -1"
    num_train_timesteps: int
    prediction_type: str
    timestep_spacing: str
    steps_offset: int
    rescaled_zero_snr: bool
    beta_schedule: str
    beta_start: float
    beta_end: float
    clip_sample: bool = False
    clip_sample_range: float = 1.0

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "v_prediction",
        timestep_spacing: str = "trailing",
        steps_offset: int = 1,
        rescale_betas_zero_snr: bool = True,
        set_alpha_to_one: bool = False,
        clip_sample: bool = False,
        clip_sample_range: float = 1.0,
    ) -> "DiffusionSchedule":
        betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        alphas_cumprod = np.cumprod(1.0 - betas)
        final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
        return cls(
            alphas_cumprod=alphas_cumprod.astype(np.float32),
            final_alpha_cumprod=np.float32(final),
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
            timestep_spacing=timestep_spacing,
            steps_offset=steps_offset,
            rescaled_zero_snr=bool(rescale_betas_zero_snr),
            beta_schedule=beta_schedule,
            beta_start=beta_start,
            beta_end=beta_end,
            clip_sample=bool(clip_sample),
            clip_sample_range=float(clip_sample_range),
        )

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any]) -> "DiffusionSchedule":
        """From a diffusers scheduler_config.json dict."""
        return cls.create(
            num_train_timesteps=int(cfg.get("num_train_timesteps", 1000)),
            beta_start=float(cfg.get("beta_start", 0.00085)),
            beta_end=float(cfg.get("beta_end", 0.012)),
            beta_schedule=str(cfg.get("beta_schedule", "scaled_linear")),
            prediction_type=str(cfg.get("prediction_type", "v_prediction")),
            timestep_spacing=str(cfg.get("timestep_spacing", "trailing")),
            steps_offset=int(cfg.get("steps_offset", 1)),
            rescale_betas_zero_snr=bool(cfg.get("rescale_betas_zero_snr", True)),
            set_alpha_to_one=bool(cfg.get("set_alpha_to_one", False)),
            clip_sample=bool(cfg.get("clip_sample", False)),
            clip_sample_range=float(cfg.get("clip_sample_range", 1.0)),
        )

    @classmethod
    def from_pretrained(cls, path: str) -> "DiffusionSchedule":
        with open(os.path.join(path, "scheduler_config.json")) as f:
            return cls.from_config(json.load(f))

    def to_config(self) -> dict:
        return {
            "_class_name": "DDIMScheduler",
            "num_train_timesteps": self.num_train_timesteps,
            "beta_start": self.beta_start,
            "beta_end": self.beta_end,
            "beta_schedule": self.beta_schedule,
            "prediction_type": self.prediction_type,
            "timestep_spacing": self.timestep_spacing,
            "steps_offset": self.steps_offset,
            "rescale_betas_zero_snr": self.rescaled_zero_snr,
            "set_alpha_to_one": bool(self.final_alpha_cumprod == 1.0),
            "clip_sample": self.clip_sample,
            "clip_sample_range": self.clip_sample_range,
        }

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "scheduler_config.json"), "w") as f:
            json.dump(self.to_config(), f, indent=2)

    # ------------------------------------------------------------------ #
    # inference (DDIM, eta = 0)

    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending timestep sequence."""
        T = self.num_train_timesteps
        if num_inference_steps > T:
            raise ValueError(f"steps {num_inference_steps} > train timesteps {T}")
        if self.timestep_spacing == "trailing":
            return trailing_timesteps(T, num_inference_steps)
        if self.timestep_spacing == "leading":
            return leading_timesteps(T, num_inference_steps, self.steps_offset)
        if self.timestep_spacing == "linspace":
            return linspace_timesteps(T, num_inference_steps)
        raise ValueError(f"unknown timestep_spacing: {self.timestep_spacing}")

    def prev_timesteps(self, timesteps: np.ndarray) -> np.ndarray:
        """Previous timestep per DDIM step (negative => final alpha)."""
        return timesteps - self.num_train_timesteps // len(timesteps)

    def _alpha_at(self, t: int) -> np.float32:
        t = int(t)
        return self.final_alpha_cumprod if t < 0 else self.alphas_cumprod[t]

    def ddim_step(self, model_output: torch.Tensor, t: int, prev_t: int,
                  sample: torch.Tensor) -> torch.Tensor:
        """Deterministic DDIM update x_t -> x_{prev_t} (diffusers
        DDIMScheduler.step, eta = 0). Math in fp32, result in sample's dtype."""
        a_t = self._alpha_at(t)
        one = np.float32(1.0)
        sqrt_a, sqrt_b = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
        x = sample.float()
        m = model_output.float()
        if self.prediction_type == "epsilon":
            x0 = (x - sqrt_b * m) / max(sqrt_a, 1e-12)
            eps = m
        elif self.prediction_type == "sample":
            x0 = m
            eps = (x - sqrt_a * m) / max(sqrt_b, 1e-12)
        elif self.prediction_type == "v_prediction":
            x0 = sqrt_a * x - sqrt_b * m
            eps = sqrt_a * m + sqrt_b * x
        else:
            raise ValueError(f"unknown prediction_type: {self.prediction_type}")
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)
            eps = (x - sqrt_a * x0) / max(sqrt_b, 1e-12)
        a_prev = self._alpha_at(prev_t)
        prev = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(one - a_prev)) * eps
        return prev.to(sample.dtype)

    # ------------------------------------------------------------------ #
    # training forward process (DDPM role)

    def _alpha_bcast(self, t: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """alphas_cumprod[t] in fp32, shaped to broadcast against x0
        ([B] against [B, ...])."""
        table = torch.from_numpy(self.alphas_cumprod).to(x0.device)
        a = table[t.to(x0.device).long()]
        return a.reshape(a.shape + (1,) * (x0.ndim - a.ndim))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, in fp32,
        stored in x0's dtype."""
        a = self._alpha_bcast(t, x0)
        out = torch.sqrt(a) * x0.float() + torch.sqrt(1.0 - a) * noise.float()
        return out.to(x0.dtype)

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        """v-prediction target: v = sqrt(abar_t) eps - sqrt(1 - abar_t) x0."""
        a = self._alpha_bcast(t, x0)
        out = torch.sqrt(a) * noise.float() - torch.sqrt(1.0 - a) * x0.float()
        return out.to(x0.dtype)

    def training_target(self, x0: torch.Tensor, noise: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """The regression target per prediction_type."""
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "sample":
            return x0
        if self.prediction_type == "v_prediction":
            return self.velocity(x0, noise, t)
        raise ValueError(f"unknown prediction_type: {self.prediction_type}")


def check_trailing_zero_snr(schedule: DiffusionSchedule, num_steps: int) -> list[str]:
    """The reference's inference-setting guardrails as warning strings
    (empty = all good)."""
    warnings = []
    if schedule.timestep_spacing != "trailing" or not schedule.rescaled_zero_snr:
        warnings.append(
            "scheduler is not configured with timestep_spacing='trailing' and "
            "rescale_betas_zero_snr=True; few-step inference quality will degrade"
        )
    if num_steps > 10:
        warnings.append(
            f"denoising_steps={num_steps}: more than 10 steps is unnecessary "
            "for v1-1 checkpoints and slows inference"
        )
    return warnings
