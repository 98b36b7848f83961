"""UNet channel surgery for fine-tuning from Stable Diffusion 2.

Counterpart of `marigold_tpu/models/surgery.py:replace_conv_in`: the depth
and normals trainers duplicate the 4-channel conv_in kernel to 8 input
channels and divide it by the factor, so that the initial activations are
unchanged for a duplicated input. The port's convs are OIHW, so input
channels are axis 1 (the JAX package's HWIO axis 2). The IID surgery
(`replace_conv_in_out_multimodal`) comes with the IID trainer.
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
