"""AutoencoderKL (SD2 VAE), NCHW, diffusers module names.

Counterpart of `marigold_tpu/models/vae.py`: posterior-mean encode (the
pipelines never sample) scaled by 0.18215, and decode. Encoder downsampling
is diffusers' asymmetric (0, 1) pad + stride-2 VALID conv; the mid block's
single 512-wide attention head goes through `ops/attention.py`, which takes
the flash kernel at >= 1024 tokens on CUDA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from marigold_tpu_torch.models.layers import Conv2d, GroupNorm, upsample_nearest_2x
from marigold_tpu_torch.models.unet import Attention
from marigold_tpu_torch.ops.attention import dispatch_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "VAEConfig":
        return cls(
            in_channels=d.get("in_channels", 3),
            out_channels=d.get("out_channels", 3),
            block_out_channels=tuple(d.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=d.get("layers_per_block", 2),
            latent_channels=d.get("latent_channels", 4),
            norm_num_groups=d.get("norm_num_groups", 32),
            scaling_factor=d.get("scaling_factor", 0.18215),
        )

    def to_dict(self) -> dict:
        n = len(self.block_out_channels)
        return {
            "_class_name": "AutoencoderKL",
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "block_out_channels": list(self.block_out_channels),
            "down_block_types": ["DownEncoderBlock2D"] * n,
            "up_block_types": ["UpDecoderBlock2D"] * n,
            "layers_per_block": self.layers_per_block,
            "latent_channels": self.latent_channels,
            "norm_num_groups": self.norm_num_groups,
            "scaling_factor": self.scaling_factor,
            "act_fn": "silu",
        }

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D without time embedding (GN eps 1e-6)."""

    def __init__(self, c_in: int, c_out: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, c_in)
        self.conv1 = Conv2d(c_in, c_out, 3, padding=1)
        self.norm2 = GroupNorm(groups, c_out)
        self.conv2 = Conv2d(c_out, c_out, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, act="silu"))
        h = self.conv2(self.norm2(h, act="silu"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(Attention):
    """The mid block's single-head attention with its own GroupNorm."""

    def __init__(self, c: int, groups: int):
        super().__init__(c, heads=1, bias=True)
        self.group_norm = GroupNorm(groups, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        o = dispatch_attention(
            self.to_q(t), self.to_k(t), self.to_v(t), num_heads=1)
        return x + self.to_out[0](o).transpose(1, 2).reshape(b, c, h, w)


class MidBlock(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(c, c, groups), ResnetBlock(c, c, groups)])
        self.attentions = nn.ModuleList([AttentionBlock(c, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _Sampler(nn.Module):
    def __init__(self, c: int, stride: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=stride, padding=1 if stride == 1 else 0)


class _Block(nn.Module):
    def __init__(self, resnets):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        b, g = list(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, b[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        c = b[0]
        for i, bc in enumerate(b):
            blk = _Block([ResnetBlock(c if j == 0 else bc, bc, g)
                          for j in range(cfg.layers_per_block)])
            c = bc
            if i < len(b) - 1:
                blk.downsamplers = nn.ModuleList([_Sampler(c, 2)])
            self.down_blocks.append(blk)
        self.mid_block = MidBlock(b[-1], g)
        self.conv_norm_out = GroupNorm(g, b[-1])
        self.conv_out = Conv2d(b[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                # diffusers Downsample2D in the VAE: (0, 1) pad, VALID stride 2
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(self.conv_norm_out(h, act="silu"))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        b, g = list(cfg.block_out_channels), cfg.norm_num_groups
        rev = list(reversed(b))
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList()
        c = rev[0]
        for i, bc in enumerate(rev):
            blk = _Block([ResnetBlock(c if j == 0 else bc, bc, g)
                          for j in range(cfg.layers_per_block + 1)])
            c = bc
            if i < len(b) - 1:
                blk.upsamplers = nn.ModuleList([_Sampler(c, 1)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(g, rev[-1])
        self.conv_out = Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(upsample_nearest_2x(h))
        return self.conv_out(self.conv_norm_out(h, act="silu"))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: [B, 3, H, W] in [-1, 1] -> (mean, logvar), each [B, 4, H/8, W/8]."""
        moments = self.quant_conv(self.encoder(x))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: [B, 4, h, w] (already divided by the scaling factor) ->
        [B, 3, 8h, 8w]."""
        return self.decoder(self.post_quant_conv(z))

    def encode_mean_scaled(self, x: torch.Tensor) -> torch.Tensor:
        """RGB -> posterior mean * scaling_factor."""
        return self.encode(x)[0] * self.cfg.scaling_factor

    def decode_scaled(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z / self.cfg.scaling_factor)
