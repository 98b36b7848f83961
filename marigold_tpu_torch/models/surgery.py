"""UNet channel surgery for fine-tuning from Stable Diffusion 2.

Counterpart of `marigold_tpu/models/surgery.py`:
  * `replace_conv_in` (depth and normals trainers) duplicates the
    4-channel conv_in kernel to 8 input channels and divides it by the
    factor, so that the initial activations are unchanged for a duplicated
    input;
  * `replace_conv_in_out_multimodal` (IID trainer) widens conv_in to
    4 * (n + 1) input channels the same way and conv_out to 4 * n output
    channels, repeated and not scaled, its bias repeated too.
The port's convs are OIHW, so input channels are axis 1 and output
channels axis 0 (the JAX package's HWIO axes 2 and 3).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from marigold_tpu_torch.models.unet import UNetConfig


def replace_conv_in(cfg: UNetConfig, state_dict: Mapping[str, torch.Tensor],
                    new_in_channels: int):
    """-> (cfg with in_channels = new_in_channels, state dict with conv_in
    widened). new_in_channels must be a multiple of cfg.in_channels."""
    old = cfg.in_channels
    if new_in_channels % old != 0:
        raise ValueError(f"{new_in_channels} not a multiple of {old}")
    factor = new_in_channels // old
    w = state_dict["conv_in.weight"]  # [out, in, kh, kw]
    out = dict(state_dict)
    out["conv_in.weight"] = torch.cat([w] * factor, dim=1) / factor
    return dataclasses.replace(cfg, in_channels=new_in_channels), out


def replace_conv_in_out_multimodal(cfg: UNetConfig,
                                   state_dict: Mapping[str, torch.Tensor],
                                   n_targets: int, latent_channels: int = 4):
    """IID surgery: conv_in 4 -> 4 * (n + 1) input channels (scaled),
    conv_out 4 -> 4 * n output channels (repeated along dim 0, unscaled;
    the bias repeated). Raises ValueError when 4 * n is not a multiple of
    conv_out's channels (surgery on an already widened UNet)."""
    new_cfg, out = replace_conv_in(cfg, state_dict,
                                   latent_channels * (n_targets + 1))
    if (latent_channels * n_targets) % cfg.out_channels != 0:
        raise ValueError(
            f"target channels {latent_channels * n_targets} not a "
            f"multiple of conv_out channels {cfg.out_channels}")
    factor = (latent_channels * n_targets) // cfg.out_channels
    out["conv_out.weight"] = torch.cat([out["conv_out.weight"]] * factor, dim=0)
    if "conv_out.bias" in out:
        out["conv_out.bias"] = torch.cat([out["conv_out.bias"]] * factor)
    return dataclasses.replace(new_cfg, out_channels=latent_channels * n_targets), out
