from marigold_tpu_torch.core.scheduler import (
    DiffusionSchedule,
    leading_timesteps,
    linspace_timesteps,
    make_betas,
    rescale_zero_terminal_snr,
    trailing_timesteps,
)

__all__ = [
    "DiffusionSchedule",
    "make_betas",
    "rescale_zero_terminal_snr",
    "trailing_timesteps",
    "leading_timesteps",
    "linspace_timesteps",
]
