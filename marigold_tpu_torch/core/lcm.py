"""LCM (Latent Consistency Model) sampling for the deprecated v1-0 LCM depth
checkpoints, PyTorch port of `marigold_tpu/core/lcm.py`.

One step: the consistency boundary conditions
  scaled_t = timestep_scaling * t
  c_skip = sigma_data^2 / (scaled_t^2 + sigma_data^2)
  c_out  = scaled_t / sqrt(scaled_t^2 + sigma_data^2)
  denoised = c_out * pred_x0(model_output) + c_skip * sample
then re-noising to the next timestep with fresh noise that the caller
draws; the last step returns `denoised`. Timesteps come from the
`original_inference_steps`-point training grid, evenly strided. Scalars in
fp32 (numpy), tensor math in fp32, results in the sample's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from marigold_tpu_torch.core.scheduler import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    base: DiffusionSchedule
    original_inference_steps: int = 50
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0

    @classmethod
    def create(cls, base: Optional[DiffusionSchedule] = None, **kw) -> "LCMSchedule":
        if base is None:
            base = DiffusionSchedule.create(
                rescale_betas_zero_snr=False, timestep_spacing="leading",
                prediction_type="epsilon")
        return cls(base=base, **kw)

    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending timesteps. More steps than the grid holds raise, as
        diffusers' LCMScheduler.set_timesteps does."""
        if num_inference_steps > self.original_inference_steps:
            raise ValueError(
                f"num_inference_steps ({num_inference_steps}) cannot exceed "
                f"original_inference_steps ({self.original_inference_steps})")
        k = self.base.num_train_timesteps // self.original_inference_steps
        # training grid: t = k*i + k - 1 for i in 0..original_inference_steps-1
        grid = np.arange(1, self.original_inference_steps + 1) * k - 1
        skip = max(len(grid) // num_inference_steps, 1)
        return grid[::-1][::skip][:num_inference_steps].astype(np.int64)

    def prev_timesteps(self, timesteps: np.ndarray) -> np.ndarray:
        """The timestep each step re-noises to: the next one, -1 after the
        last (never used: the last step returns `denoised`)."""
        return np.concatenate([timesteps[1:], [-1]]).astype(np.int64)

    def boundary_scalings(self, t: int) -> tuple[np.float32, np.float32]:
        """(c_skip, c_out) at timestep t, in fp32."""
        st = np.float32(self.timestep_scaling) * np.float32(t)
        sd2 = np.float32(self.sigma_data) ** 2
        return sd2 / (st**2 + sd2), st / np.sqrt(st**2 + sd2)

    def step(self, model_output: torch.Tensor, t: int, prev_t: int,
             sample: torch.Tensor, noise: Optional[torch.Tensor],
             is_last: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """One LCM step. Returns (prev_sample, denoised); at the last step
        prev_sample is denoised and `noise` may be None."""
        x0, _ = self.base.pred_x0_and_eps(model_output, t, sample)
        c_skip, c_out = self.boundary_scalings(t)
        denoised = float(c_out) * x0 + float(c_skip) * sample.float()
        if is_last:
            prev = denoised
        else:
            a_prev = self.base._alpha_at(prev_t)
            prev = (float(np.sqrt(a_prev)) * denoised
                    + float(np.sqrt(np.float32(1.0) - a_prev)) * noise.float())
        return prev.to(sample.dtype), denoised.to(sample.dtype)
