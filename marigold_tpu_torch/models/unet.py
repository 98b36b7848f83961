"""SD2-class conditional UNet (diffusers UNet2DConditionModel role), NCHW.

Counterpart of `marigold_tpu/models/unet.py`. Module and parameter names are
the diffusers names, so a diffusers `unet/` state dict loads as it is.
Self-attention goes through `ops/attention.py` (the Hopper flash kernel at
>= 1024 tokens on CUDA), cross-attention over the length-2 empty-prompt
embedding through the plain attention.

The forward runs as regions, each down block, the mid block and each up
block, through an optional `block_runner(fn, *args)`: the training step's
remat modes make each region its own activation checkpoint
(`train/train_step.py:remat_runner`), so the backward recomputes and holds
one region's activations at a time. The skip connections cross regions as
the down blocks' saved outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from marigold_tpu_torch.models.layers import (
    GEGLU,
    Conv2d,
    GroupNorm,
    LayerNorm,
    timestep_embedding,
    upsample_nearest_2x,
)
from marigold_tpu_torch.ops.attention import dispatch_attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 96
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    # diffusers' `attention_head_dim` holds the number of heads for SD2
    # checkpoints; kept with that meaning
    attention_head_dim: Sequence[int] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    norm_eps: float = 1e-5  # resnets and conv_norm_out; transformer GN is 1e-6
    use_linear_projection: bool = True

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "UNetConfig":
        blocks = tuple(d.get("block_out_channels", (320, 640, 1280, 1280)))
        ahd = d.get("attention_head_dim", (5, 10, 20, 20))
        if isinstance(ahd, int):
            ahd = (ahd,) * len(blocks)
        return cls(
            sample_size=d.get("sample_size", 96),
            in_channels=d.get("in_channels", 8),
            out_channels=d.get("out_channels", 4),
            block_out_channels=blocks,
            down_block_types=tuple(d.get(
                "down_block_types",
                ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",))),
            up_block_types=tuple(d.get(
                "up_block_types", ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3)),
            layers_per_block=d.get("layers_per_block", 2),
            attention_head_dim=tuple(ahd),
            cross_attention_dim=d.get("cross_attention_dim", 1024),
            norm_num_groups=d.get("norm_num_groups", 32),
            norm_eps=d.get("norm_eps", 1e-5),
            use_linear_projection=d.get("use_linear_projection", True),
        )

    def to_dict(self) -> dict:
        return {
            "_class_name": "UNet2DConditionModel",
            "sample_size": self.sample_size,
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "block_out_channels": list(self.block_out_channels),
            "down_block_types": list(self.down_block_types),
            "up_block_types": list(self.up_block_types),
            "layers_per_block": self.layers_per_block,
            "attention_head_dim": list(self.attention_head_dim),
            "cross_attention_dim": self.cross_attention_dim,
            "norm_num_groups": self.norm_num_groups,
            "norm_eps": self.norm_eps,
            "use_linear_projection": self.use_linear_projection,
            "act_fn": "silu",
        }

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D with a time-embedding projection."""

    def __init__(self, c_in: int, c_out: int, temb_dim: int, groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, c_in, eps)
        self.conv1 = Conv2d(c_in, c_out, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, c_out)
        self.norm2 = GroupNorm(groups, c_out, eps)
        self.conv2 = Conv2d(c_out, c_out, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, act="silu"))
        t = self.time_emb_proj(F.silu(temb.float()).to(temb.dtype))
        h = h + t[:, :, None, None].to(h.dtype)
        h = self.conv2(self.norm2(h, act="silu"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """diffusers Attention: to_q/to_k/to_v, to_out.0. Self-attention when
    no context is given."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 bias: bool = False):
        super().__init__()
        context_dim = context_dim or dim
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=bias)
        self.to_k = nn.Linear(context_dim, dim, bias=bias)
        self.to_v = nn.Linear(context_dim, dim, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context.to(x.dtype)
        out = dispatch_attention(
            self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads)
        return self.to_out[0](out)


class FeedForward(nn.Module):
    """diffusers FeedForward: net.0 = GEGLU, net.2 = Linear."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """diffusers Transformer2DModel with one BasicTransformerBlock and linear
    projections (SD2)."""

    def __init__(self, dim: int, heads: int, cross_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, heads, cross_dim)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).reshape(b, c, h * w).transpose(1, 2))
        t = self.proj_out(self.transformer_blocks[0](t, ctx))
        return x + t.transpose(1, 2).reshape(b, c, h, w)


class _Conv(nn.Module):
    """Holder of one conv named `conv` (diffusers Downsample2D/Upsample2D)."""

    def __init__(self, c: int, stride: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=stride, padding=1)


class _Block(nn.Module):
    """A down, up or mid block: `resnets`, optional `attentions`, optional
    `downsamplers`/`upsamplers` (diffusers names)."""

    def __init__(self, resnets, attentions=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None

    def forward(self, region: Callable, *args):
        """region(self, *args): the UNet's `_down_block`, `_mid_block` or
        `_up_block` on this block, so that `torch.func.functional_call` can
        run a region on substituted parameters (the training step's remat
        regions, recomputed in the backward)."""
        return region(self, *args)


def _down_skip_channels(b: list, layers_per_block: int) -> list:
    skips = [b[0]]  # conv_in
    for i, bc in enumerate(b):
        skips += [bc] * layers_per_block
        if i < len(b) - 1:
            skips.append(bc)  # downsampler
    return skips


def _up_skip_channels(b: list, up_idx: int, layers_per_block: int) -> list:
    """Skip channels consumed by up block `up_idx` (popped in reverse)."""
    skips = _down_skip_channels(b, layers_per_block)
    per_block = layers_per_block + 1
    start = len(skips) - up_idx * per_block
    return list(reversed(skips[start - per_block: start]))


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        if not cfg.use_linear_projection:
            raise NotImplementedError(
                "1x1-conv proj_in/proj_out (SD1.x-class UNets) is not ported")
        self.cfg = cfg
        b = list(cfg.block_out_channels)
        g, eps, temb = cfg.norm_num_groups, cfg.norm_eps, cfg.time_embed_dim
        self.conv_in = Conv2d(cfg.in_channels, b[0], 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(b[0], temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)

        def xf(c, heads):
            return Transformer2DModel(c, heads, cfg.cross_attention_dim, g)

        self.down_blocks = nn.ModuleList()
        c = b[0]
        for i, (bt, bc) in enumerate(zip(cfg.down_block_types, b)):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(c, bc, temb, g, eps))
                c = bc
                if bt == "CrossAttnDownBlock2D":
                    attns.append(xf(bc, cfg.attention_head_dim[i]))
            blk = _Block(resnets, attns)
            if i < len(b) - 1:
                blk.downsamplers = nn.ModuleList([_Conv(c, 2)])
            self.down_blocks.append(blk)

        self.mid_block = _Block(
            [ResnetBlock(b[-1], b[-1], temb, g, eps),
             ResnetBlock(b[-1], b[-1], temb, g, eps)],
            [xf(b[-1], cfg.attention_head_dim[-1])],
        )

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(b))
        rev_heads = list(reversed(cfg.attention_head_dim))
        c = rev[0]
        for i, bt in enumerate(cfg.up_block_types):
            bc = rev[i]
            skip_chs = _up_skip_channels(b, i, cfg.layers_per_block)
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(c + skip_chs[j], bc, temb, g, eps))
                c = bc
                if bt == "CrossAttnUpBlock2D":
                    attns.append(xf(bc, rev_heads[i]))
            blk = _Block(resnets, attns)
            if i < len(b) - 1:
                blk.upsamplers = nn.ModuleList([_Conv(c, 1)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(g, b[0], eps)
        self.conv_out = Conv2d(b[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: Union[int, torch.Tensor],
                encoder_hidden_states: torch.Tensor,
                block_runner: Optional[Callable] = None) -> torch.Tensor:
        """sample: [B, in_ch, H, W]; timesteps: int, [] or [B];
        encoder_hidden_states: [1 or B, L, cross_dim] -> [B, out_ch, H, W].
        block_runner(fn, *args) -> fn(*args) runs each down, mid and up
        block (the training step's remat regions); None calls it."""
        run = block_runner or (lambda fn, *args: fn(*args))
        bsz = sample.shape[0]
        if isinstance(timesteps, torch.Tensor):
            t = timesteps.to(sample.device).expand(bsz)
        else:  # filled on the device: no host-to-device copy, no sync
            t = torch.full((bsz,), float(timesteps), device=sample.device)
        te = self.time_embedding
        temb = timestep_embedding(t, self.cfg.block_out_channels[0]).to(sample.dtype)
        temb = te.linear_1(temb)
        temb = te.linear_2(F.silu(temb.float()).to(temb.dtype))

        ctx = encoder_hidden_states
        if ctx.shape[0] == 1 and bsz > 1:
            ctx = ctx.expand(bsz, *ctx.shape[1:])

        h = self.conv_in(sample)
        skips = [h]
        for blk in self.down_blocks:
            outs = run(_down_block, blk, h, temb, ctx)
            skips.extend(outs)
            h = outs[-1]
        h = run(_mid_block, self.mid_block, h, temb, ctx)
        for blk in self.up_blocks:
            n = len(blk.resnets)
            block_skips = skips[-n:]
            del skips[-n:]
            # the next block's first skip sets the upsampled size
            out_hw = tuple(skips[-1].shape[2:]) if skips else None
            h = run(_up_block, blk, h, temb, ctx, out_hw, *block_skips)

        h = self.conv_norm_out(h, act="silu")
        return self.conv_out(h)


def _down_block(blk: _Block, h: torch.Tensor, temb: torch.Tensor,
                ctx: torch.Tensor) -> tuple:
    """One down block -> its outputs, each a skip connection (the last is
    the next block's input)."""
    outs = []
    for j, res in enumerate(blk.resnets):
        h = res(h, temb)
        if blk.attentions is not None:
            h = blk.attentions[j](h, ctx)
        outs.append(h)
    if hasattr(blk, "downsamplers"):
        h = blk.downsamplers[0].conv(h)
        outs.append(h)
    return tuple(outs)


def _mid_block(mid: _Block, h: torch.Tensor, temb: torch.Tensor,
               ctx: torch.Tensor) -> torch.Tensor:
    h = mid.resnets[0](h, temb)
    h = mid.attentions[0](h, ctx)
    return mid.resnets[1](h, temb)


def _up_block(blk: _Block, h: torch.Tensor, temb: torch.Tensor,
              ctx: torch.Tensor, out_hw: Optional[tuple],
              *skips: torch.Tensor) -> torch.Tensor:
    """One up block on its skips (in the down path's order, consumed from
    the last); `out_hw` is the size after the upsampler."""
    skips = list(skips)
    for j, res in enumerate(blk.resnets):
        h = res(torch.cat([h, skips.pop()], dim=1), temb)
        if blk.attentions is not None:
            h = blk.attentions[j](h, ctx)
    if hasattr(blk, "upsamplers"):
        h = upsample_nearest_2x(h)
        # odd sizes: stride-2 downsampling rounds up (11 -> 6), so 2x
        # overshoots (12); crop to the next skip's size
        h = h[:, :, :out_hw[0], :out_hw[1]]
        h = blk.upsamplers[0].conv(h)
    return h
