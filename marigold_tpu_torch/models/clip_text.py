"""CLIP text encoder (transformers CLIPTextModel role), transformers names
without the `text_model.` prefix.

Counterpart of `marigold_tpu/models/clip_text.py`. Marigold conditions on
the embedding of the empty prompt only, which tokenizes (do_not_pad) to
[BOS, EOS]; `encode_empty_prompt` embeds those two ids, so no tokenizer is
needed. SD2's tower is OpenCLIP ViT-H's text model: hidden 1024, 23 layers,
16 heads, GELU, causal mask; SD1.x's is CLIP ViT-L/14's: hidden 768, 12
layers, 12 heads, quick_gelu.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from marigold_tpu_torch.models.layers import LayerNorm
from marigold_tpu_torch.ops.attention import xla_attention

BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    bos_token_id: int = BOS_TOKEN_ID
    eos_token_id: int = EOS_TOKEN_ID

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CLIPTextConfig":
        return cls(**{f.name: d.get(f.name, f.default)
                      for f in dataclasses.fields(cls)})

    def to_dict(self) -> dict:
        return {"architectures": ["CLIPTextModel"], **dataclasses.asdict(self)}


class CLIPAttention(nn.Module):
    def __init__(self, h: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = xla_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                          self.heads, mask=mask)
        return self.out_proj(y)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    """The MLP's activation in fp32, cast back (`marigold_tpu/models/
    clip_text.py:_act`): "gelu" is the exact GELU (SD2's OpenCLIP tower),
    "quick_gelu" x * sigmoid(1.702 x) (CLIP ViT-L/14, SD1.x); any other
    name raises ValueError when the tower runs, as in the JAX package."""
    xf = x.float()
    if name == "gelu":
        y = F.gelu(xf, approximate="none")
    elif name == "quick_gelu":
        y = xf * torch.sigmoid(1.702 * xf)
    else:
        raise ValueError(f"unknown act: {name}")
    return y.to(x.dtype)


class CLIPMLP(nn.Module):
    """fc1 -> the activation in fp32 (`_act`) -> fc2."""

    def __init__(self, h: int, inner: int, act: str):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(h, inner)
        self.fc2 = nn.Linear(inner, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_act(self.fc1(x), self.act))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = LayerNorm(h, eps=eps)
        self.self_attn = CLIPAttention(h, cfg.num_attention_heads)
        self.layer_norm2 = LayerNorm(h, eps=eps)
        self.mlp = CLIPMLP(h, cfg.intermediate_size, cfg.hidden_act)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, h)
        self.embeddings.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, h)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.final_layer_norm = LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: [B, L] -> last_hidden_state [B, L, hidden]."""
        n = input_ids.shape[1]
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:n]
        causal = torch.full((n, n), -1e30, device=x.device).triu(1)
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)

    def encode_empty_prompt(self) -> torch.Tensor:
        """The Marigold conditioning: "" == [BOS, EOS] -> [1, 2, hidden]."""
        device = self.embeddings.token_embedding.weight.device
        ids = torch.tensor([[self.cfg.bos_token_id, self.cfg.eos_token_id]],
                           device=device)
        return self(ids)
