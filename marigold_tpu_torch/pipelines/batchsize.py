"""Inference batch-size selection from the device's memory.

Counterpart of `marigold_tpu/pipelines/batchsize.py`: the largest batch
whose activations fit next to the weights, from a per-latent-pixel
activation model, clamped to the ensemble size and balanced into equal
chunks as the reference's find_batch_size does. The device's memory comes
from `torch.cuda.mem_get_info` (the current CUDA device when none is
named; there is none to fall back to); an explicit CPU device assumes
16 GiB.
"""

from __future__ import annotations

import math

import torch

# activation bytes per latent pixel per sample for the SD2 UNet forward and
# VAE decode in bf16, from the JAX package's model (batchsize.py:46); fp32
# doubles it
_ACT_BYTES_PER_LATENT_PIXEL_BF16 = 6.5e4
_MODEL_BYTES = 2 * 10**9  # SD2 UNet + VAE + text encoder weights in bf16


def device_memory_bytes(device=None) -> int:
    """Total memory of `device`; None means the current CUDA device and
    raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device to size the batch for; pass device='cpu' for "
                "the CPU model")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return 16 * 1024**3


def find_batch_size(ensemble_size: int, input_res: int, dtype_bytes: int = 2,
                    device=None) -> int:
    """Largest batch that fits, clamped to the ensemble size."""
    budget = max(device_memory_bytes(device) - _MODEL_BYTES - 1024**3, 1024**3)
    latent_pixels = (max(input_res, 64) / 8) ** 2
    per_sample = _ACT_BYTES_PER_LATENT_PIXEL_BF16 * latent_pixels * (dtype_bytes / 2)
    bs = min(max(int(budget / per_sample), 1), ensemble_size)
    if ensemble_size > bs > ensemble_size / 2:  # two balanced chunks
        bs = math.ceil(ensemble_size / 2)
    return max(bs, 1)
