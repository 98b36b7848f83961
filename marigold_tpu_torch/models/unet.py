"""SD2- and SD1.x-class conditional UNet (diffusers UNet2DConditionModel
role), NCHW.

Counterpart of `marigold_tpu/models/unet.py`. Module and parameter names are
the diffusers names, so a diffusers `unet/` state dict loads as it is.
Self-attention goes through `ops/attention.py:self_attention_projected`
(the Hopper flash kernel at >= 1024 tokens on CUDA; with
MARIGOLD_TPU_PROJECTED_ATTN=1 its Q, K and V from one product), cross-
attention over the length-2 empty-prompt embedding through the plain
attention. The transformers' proj_in/proj_out (`Projection`) are linears in
SD2 and 1x1 convs in SD1.x-class checkpoints (diffusers'
`use_linear_projection` False): either weight loads, and the one given is
applied as a linear over channels, as the JAX package's `_proj` decides by
the weight's rank.

The forward runs as regions, each down block, the mid block and each up
block, through an optional `block_runner(fn, *args)`: the training step's
remat modes make each region its own activation checkpoint
(`train/train_step.py:remat_runner`), so the backward recomputes and holds
one region's activations at a time. The skip connections cross regions as
the down blocks' saved outputs.

`spatial` (a `parallel.mesh.Mesh`, None by default) runs the forward on one
rank's block of the latent's H rows, as the JAX package's `spatial_axis`:
it reaches the resnets' convs and GroupNorms, the transformers' GroupNorm
and self-attention, the samplers and the output convs; cross-attention,
GEGLU and the time embedding are token-local.
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
from marigold_tpu_torch.ops.attention import (
    dispatch_attention,
    self_attention_projected,
)


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

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                spatial=None) -> torch.Tensor:
        h = self.conv1(self.norm1(x, act="silu", spatial=spatial), spatial)
        t = self.time_emb_proj(F.silu(temb.float()).to(temb.dtype))
        h = h + t[:, :, None, None].to(h.dtype)
        h = self.conv2(self.norm2(h, act="silu", spatial=spatial), spatial)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


_QKV = ("to_q", "to_k", "to_v")


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

    def __getattr__(self, name: str):
        # `attn.to_q` fetched from outside is the way to a write through
        # `attn.to_q.weight.data`, which does not bump the weight's
        # `_version`: drop the stacked weight (as `layers.Conv2d` drops its
        # prepared weight). The module itself reads `_modules`.
        if name in _QKV:
            self.__dict__.pop("_qkv", None)
        return super().__getattr__(name)

    def qkv_weight(self) -> torch.Tensor:
        """[3C, C]: to_q's, to_k's and to_v's weights stacked, the weight of
        the projected self-attention's one product, built once and reused
        until one of them changes (keyed on each weight's `data_ptr()`,
        `_version`, dtype and device: a load, an in-place update and a
        conversion change it; a fetch of to_q/to_k/to_v drops it)."""
        ws = [self._modules[n]._parameters["weight"] for n in _QKV]
        key = tuple((w.data_ptr(), w._version, w.dtype, w.device) for w in ws)
        cached = self.__dict__.get("_qkv")
        if cached is None or cached[0] != key:
            with torch.no_grad():
                cached = self.__dict__["_qkv"] = (key, torch.cat(ws))
        return cached[1]

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                spatial=None) -> torch.Tensor:
        """spatial: the mesh over which x's tokens are sharded (self-attention
        only; cross-attention is token-local)."""
        if context is None:
            return self_attention_projected(x, self, self.heads, spatial)
        ctx = context.to(x.dtype)
        mods = self._modules
        out = dispatch_attention(mods["to_q"](x), mods["to_k"](ctx),
                                 mods["to_v"](ctx), self.heads)
        return mods["to_out"][0](out)


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

    def forward(self, x: torch.Tensor, ctx: torch.Tensor,
                spatial=None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), spatial=spatial)
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Projection(nn.Linear):
    """A transformer's proj_in/proj_out: a linear over channels on the token
    layout whatever the stored weight, [C, C] (diffusers'
    `use_linear_projection`, SD2) or a 1x1 conv's [C, C, 1, 1] (SD1.x-class
    checkpoints), as the JAX package's `_proj` (`marigold_tpu/models/
    unet.py:286`) decides by the weight's rank and not by the config flag;
    for a 1x1 kernel the conv before the token reshape and the linear after
    it commute. Built [C, C] (so the manifest's expected shapes are the JAX
    package's); a state dict's weight of the other rank replaces the
    parameter's shape on load, so that a loaded checkpoint saves back as it
    was."""

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        p = self._parameters["weight"]
        if w is not None and w.ndim != p.ndim and \
                w.shape[:2] == p.shape[:2] and w[0].numel() == p[0].numel():
            self.weight = nn.Parameter(
                torch.empty(w.shape, dtype=p.dtype, device=p.device),
                requires_grad=p.requires_grad)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return F.linear(x, w.flatten(1) if w.ndim == 4 else w, self.bias)


class Transformer2DModel(nn.Module):
    """diffusers Transformer2DModel with one BasicTransformerBlock; proj_in
    and proj_out linear (SD2) or 1x1 convs (SD1.x-class), see
    `Projection`."""

    def __init__(self, dim: int, heads: int, cross_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = Projection(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, heads, cross_dim)])
        self.proj_out = Projection(dim, dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor,
                spatial=None) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.norm(x, spatial=spatial).reshape(b, c, h * w).transpose(1, 2)
        t = self.proj_out(self.transformer_blocks[0](self.proj_in(t), ctx,
                                                     spatial))
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
                block_runner: Optional[Callable] = None,
                spatial=None) -> torch.Tensor:
        """sample: [B, in_ch, H, W]; timesteps: int, [] or [B];
        encoder_hidden_states: [1 or B, L, cross_dim] -> [B, out_ch, H, W].
        block_runner(fn, *args) -> fn(*args) runs each down, mid and up
        block (the training step's remat regions); None calls it.
        spatial: a `parallel.mesh.Mesh` when sample is this rank's block of
        H rows (`marigold_tpu/models/unet.py:apply` with spatial_axis):
        3x3 convs exchange halo rows, GroupNorm all-reduces its sums,
        self-attention gathers K/V; the global H must divide by
        2^(levels-1) x ranks (`parallel/spatial.py`)."""
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

        h = self.conv_in(sample, spatial)
        skips = [h]
        for blk in self.down_blocks:
            outs = run(_down_block, blk, h, temb, ctx, spatial)
            skips.extend(outs)
            h = outs[-1]
        h = run(_mid_block, self.mid_block, h, temb, ctx, spatial)
        for blk in self.up_blocks:
            n = len(blk.resnets)
            block_skips = skips[-n:]
            del skips[-n:]
            # the next block's first skip sets the upsampled size
            out_hw = tuple(skips[-1].shape[2:]) if skips else None
            h = run(_up_block, blk, h, temb, ctx, spatial, out_hw, *block_skips)

        h = self.conv_norm_out(h, act="silu", spatial=spatial)
        return self.conv_out(h, spatial)


def _down_block(blk: _Block, h: torch.Tensor, temb: torch.Tensor,
                ctx: torch.Tensor, spatial=None) -> tuple:
    """One down block -> its outputs, each a skip connection (the last is
    the next block's input)."""
    outs = []
    for j, res in enumerate(blk.resnets):
        h = res(h, temb, spatial)
        if blk.attentions is not None:
            h = blk.attentions[j](h, ctx, spatial)
        outs.append(h)
    if hasattr(blk, "downsamplers"):
        h = blk.downsamplers[0].conv(h, spatial)
        outs.append(h)
    return tuple(outs)


def _mid_block(mid: _Block, h: torch.Tensor, temb: torch.Tensor,
               ctx: torch.Tensor, spatial=None) -> torch.Tensor:
    h = mid.resnets[0](h, temb, spatial)
    h = mid.attentions[0](h, ctx, spatial)
    return mid.resnets[1](h, temb, spatial)


def _up_block(blk: _Block, h: torch.Tensor, temb: torch.Tensor,
              ctx: torch.Tensor, spatial, out_hw: Optional[tuple],
              *skips: torch.Tensor) -> torch.Tensor:
    """One up block on its skips (in the down path's order, consumed from
    the last); `out_hw` is the size after the upsampler."""
    skips = list(skips)
    for j, res in enumerate(blk.resnets):
        h = res(torch.cat([h, skips.pop()], dim=1), temb, spatial)
        if blk.attentions is not None:
            h = blk.attentions[j](h, ctx, spatial)
    if hasattr(blk, "upsamplers"):
        h = upsample_nearest_2x(h)
        # odd sizes: stride-2 downsampling rounds up (11 -> 6), so 2x
        # overshoots (12); crop to the next skip's size (sharded, every
        # level's local H is even and the crop is W's alone)
        h = h[:, :, :out_hw[0], :out_hw[1]]
        h = blk.upsamplers[0].conv(h, spatial)
    return h
