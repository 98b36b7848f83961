"""Spatially sharded UNet forward: one image's latent H axis over the mesh.

Counterpart of `marigold_tpu/parallel/spatial.py`. Ensemble members shard
over ranks embarrassingly (`pipelines/base.py`); above ~1k px with a small
ensemble, one trajectory's activations and its level-0 self-attention
(36 864 tokens at 1536 px) outgrow what members buy, so the latent's H rows
shard over the ranks instead:

  * every conv, norm, projection and attention runs on [B, C, H/n, W]
    blocks;
  * 3x3 convs take one halo row from each neighbour per call
    (`models/layers.py:Conv2d.spatial_forward`, an all_gather of the edge
    rows);
  * GroupNorm all-reduces its fp32 per-group sums (`models/layers.py:
    group_norm`);
  * self-attention all-gathers K/V once per layer and runs the local flash
    kernel over the query block (`ops/attention.py`, `ops/sharded_attention.
    py`);
  * cross-attention, GEGLU, projections and the time embedding are
    token-local.

The sharded forward is the unsharded one up to the order of fp32 sums (the
halo rows are the zero padding's exact stand-in).
"""

from __future__ import annotations

from typing import Union

import torch


def check_spatial_divisibility(h: int, mesh, n_levels: int = 4) -> None:
    """The latent H must split evenly at every UNet level: n_levels - 1
    stride-2 downsamples keep the shard-local H even only when H divides
    by 2^(n_levels-1) x the mesh size. Raises ValueError."""
    n = mesh.size
    need = (1 << (n_levels - 1)) * n
    if h % need:
        raise ValueError(
            f"spatial sharding over {n} ranks needs latent H divisible by "
            f"{need}, got {h} (pad the input to a multiple of {8 * need} px)")


@torch.no_grad()
def spatial_unet_apply(unet, sample: torch.Tensor,
                       timesteps: Union[int, torch.Tensor],
                       encoder_hidden_states: torch.Tensor, mesh
                       ) -> torch.Tensor:
    """The UNet forward of sample [B, in_ch, H, W] (the global tensor every
    rank holds) with H sharded over `mesh`: each rank runs its H/n rows and
    the output blocks are gathered back, so every rank returns
    [B, out_ch, H, W]. The weights are replicated."""
    check_spatial_divisibility(sample.shape[2], mesh,
                               len(unet.cfg.block_out_channels))
    rows = mesh.rows(sample.shape[2])
    out = unet(sample[:, :, rows].contiguous(), timesteps,
               encoder_hidden_states, spatial=mesh)
    return mesh.all_gather(out, dim=2)
