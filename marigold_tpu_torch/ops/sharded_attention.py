"""Self-attention with the token axis sharded over the mesh.

Counterpart of `marigold_tpu/ops/sharded_attention.py`, the gather-KV member
of the blockwise-attention family: each rank keeps its block of the query
tokens, K and V are all-gathered once, and the rank runs the local flash
kernel over its queries against all the keys, so scores and softmax never
cross ranks. It is optimal while N x D per image fits a card's memory.
The UNet and VAE run the same pattern inside their forwards
(`ops/attention.py:dispatch_attention` with `spatial`).
"""

from __future__ import annotations

import torch

from marigold_tpu_torch.ops import flash_attention as fa
from marigold_tpu_torch.ops.attention import xla_attention


def spatial_sharded_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, num_heads: int, mesh,
                              use_flash: bool = True) -> torch.Tensor:
    """Multi-head attention of q/k/v [B, N, C], the global tensors as every
    rank holds them (the JAX function takes global arrays), with N sharded
    over `mesh`: each rank takes its N/n query, key and value tokens,
    gathers the K/V blocks into one contiguous tensor each, attends locally
    and the output blocks are gathered back, so every rank returns the
    [B, N, C] result. The local call is `flash_attention` (the Hopper kernel
    on a CUDA tensor, its plain version on the CPU) in the shifted softmax,
    as the JAX local call takes `flash_attention_dt`'s default, or with
    use_flash=False the plain `xla_attention`. Raises ValueError when N
    does not divide the mesh size."""
    n = q.shape[1]
    if n % mesh.size:
        raise ValueError(f"token count {n} must divide mesh size {mesh.size}")
    rows = mesh.rows(n)
    kv = mesh.all_gather(torch.stack([k[:, rows], v[:, rows]]), dim=2)
    q_local = q[:, rows].contiguous()
    if use_flash:
        out = fa.flash_attention(q_local, kv[0], kv[1], num_heads)
    else:
        out = xla_attention(q_local, kv[0], kv[1], num_heads)
    return mesh.all_gather(out, dim=1)
