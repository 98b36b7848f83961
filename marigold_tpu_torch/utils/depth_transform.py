"""Depth normalization for training data.

Semantics defined by the reference's ScaleShiftDepthNormalizer
(src/util/depth_transform.py:77-130): map the [q, 1-q] quantile range of
valid depth linearly onto [norm_min, norm_max], optionally clipping.

Copy of `marigold_tpu/utils/depth_transform.py` for the PyTorch port. The
data path runs on the host (numpy, torch-free: the loader's forked workers
call it); `normalize_torch` is the on-device twin, the counterpart of
`normalize_jax`. torch is imported inside it, so the module stays
importable in a worker without touching torch.
"""

from __future__ import annotations

import numpy as np


def get_depth_normalizer(cfg):
    """Factory mirroring reference src/util/depth_transform.py:35-52.
    `cfg` is a mapping with keys type/norm_min/norm_max/min_max_quantile/clip,
    or None for identity."""
    if cfg is None:
        return lambda x, valid_mask=None, clip=None: x
    if cfg["type"] == "scale_shift_depth":
        return ScaleShiftDepthNormalizer(
            norm_min=cfg.get("norm_min", -1.0),
            norm_max=cfg.get("norm_max", 1.0),
            min_max_quantile=cfg.get("min_max_quantile", 0.02),
            clip=cfg.get("clip", True),
        )
    raise NotImplementedError(f"unknown depth normalizer: {cfg['type']}")


class ScaleShiftDepthNormalizer:
    """Affine-invariant depth normalizer: d' = (d - q_lo) / (q_hi - q_lo)
    mapped to [norm_min, norm_max]. Not invertible without GT."""

    is_absolute = False
    far_plane_at_max = True

    def __init__(self, norm_min=-1.0, norm_max=1.0, min_max_quantile=0.02, clip=True):
        self.norm_min = float(norm_min)
        self.norm_max = float(norm_max)
        self.norm_range = self.norm_max - self.norm_min
        self.min_quantile = float(min_max_quantile)
        self.max_quantile = 1.0 - self.min_quantile
        self.clip = bool(clip)

    def __call__(self, depth_linear, valid_mask=None, clip=None):
        clip = self.clip if clip is None else clip
        d = np.asarray(depth_linear, dtype=np.float32)
        if valid_mask is None:
            valid_mask = np.ones_like(d, dtype=bool)
        valid_mask = np.asarray(valid_mask, dtype=bool) & (d > 0)
        vals = d[valid_mask]
        if vals.size == 0:
            return np.zeros_like(d)
        lo = np.quantile(vals, self.min_quantile)
        hi = np.quantile(vals, self.max_quantile)
        rng = max(hi - lo, 1e-8)
        out = (d - lo) / rng * self.norm_range + self.norm_min
        if clip:
            out = np.clip(out, self.norm_min, self.norm_max)
        return out

    def scale_back(self, depth_norm):
        """[norm_min, norm_max] -> [0, 1]."""
        return (np.asarray(depth_norm) - self.norm_min) / self.norm_range

    def denormalize(self, depth_norm, **kwargs):
        return self.scale_back(depth_norm)

    # on-device twin for fused pipelines -------------------------------- #

    def normalize_torch(self, depth, valid_mask=None, clip=None):
        """`__call__` on a tensor, on its device: quantiles of the valid
        (masked, > 0) depth by a sort with the invalid entries pushed to
        +inf and linear interpolation between neighbouring ranks, as
        `normalize_jax` computes them."""
        import torch

        clip = self.clip if clip is None else clip
        d = torch.as_tensor(depth).float()
        mask = (torch.ones_like(d, dtype=torch.bool) if valid_mask is None
                else torch.as_tensor(valid_mask, device=d.device).bool())
        mask = mask & (d > 0)
        order = torch.sort(torch.where(mask, d, torch.inf).reshape(-1)).values
        n_valid = mask.sum().float()

        def q_at(q):
            fidx = ((n_valid - 1) * q).clamp(min=0)
            i0 = torch.floor(fidx).long()
            i1 = (i0 + 1).clamp(0, order.shape[0] - 1)
            w = fidx - i0.float()
            return order[i0] * (1 - w) + order[i1] * w

        lo, hi = q_at(self.min_quantile), q_at(self.max_quantile)
        rng = torch.clamp(hi - lo, min=1e-8)
        out = (d - lo) / rng * self.norm_range + self.norm_min
        if clip:
            out = torch.clamp(out, self.norm_min, self.norm_max)
        return out
