"""Least-squares depth alignment for affine-invariant evaluation.

Behavioral reference: src/util/alignment.py:35-99 — per-image closed-form
scale/shift via least squares over valid pixels (optionally at reduced
resolution), then applied at full resolution; plus depth<->disparity
helpers used by the disparity-space eval path (script/depth/eval.py:179-199).
"""

from __future__ import annotations

import numpy as np


def align_depth_least_square(
    gt_arr: np.ndarray,
    pred_arr: np.ndarray,
    valid_mask_arr: np.ndarray,
    return_scale_shift: bool = True,
    max_resolution: int | None = None,
):
    ori_shape = pred_arr.shape
    gt = np.asarray(gt_arr, np.float64).squeeze()
    pred = np.asarray(pred_arr, np.float64).squeeze()
    valid = np.asarray(valid_mask_arr, bool).squeeze()
    assert gt.shape == pred.shape == valid.shape, (
        gt.shape,
        pred.shape,
        valid.shape,
    )

    if max_resolution is not None and max(gt.shape) > max_resolution:
        scale = max_resolution / max(gt.shape)
        nh, nw = int(gt.shape[0] * scale), int(gt.shape[1] * scale)
        # nearest downsample (alignment only; applied at full res after)
        ri = (np.arange(nh) * gt.shape[0] / nh).astype(int)
        ci = (np.arange(nw) * gt.shape[1] / nw).astype(int)
        gt_s = gt[np.ix_(ri, ci)]
        pred_s = pred[np.ix_(ri, ci)]
        valid_s = valid[np.ix_(ri, ci)]
    else:
        gt_s, pred_s, valid_s = gt, pred, valid

    gt_m = gt_s[valid_s].reshape(-1, 1)
    pred_m = pred_s[valid_s].reshape(-1, 1)
    if gt_m.size == 0:
        # an empty lstsq silently returns scale=shift=0 and an all-zero
        # "aligned" map whose garbage metrics would enter the benchmark
        raise ValueError(
            "align_depth_least_square: no valid pixels in the mask"
        )

    A = np.concatenate([pred_m, np.ones_like(pred_m)], axis=-1)
    X = np.linalg.lstsq(A, gt_m, rcond=None)[0]
    scale, shift = float(X[0, 0]), float(X[1, 0])

    aligned = pred * scale + shift
    aligned = aligned.reshape(ori_shape)

    if return_scale_shift:
        return aligned, scale, shift
    return aligned


def depth2disparity(depth: np.ndarray, return_mask: bool = False):
    """1/depth where depth > 0 (reference alignment.py:85-93)."""
    depth = np.asarray(depth, np.float64)
    positive_mask = depth > 0
    disparity = np.zeros_like(depth)
    disparity[positive_mask] = 1.0 / depth[positive_mask]
    if return_mask:
        return disparity, positive_mask
    return disparity


def disparity2depth(disparity: np.ndarray, **kwargs):
    return depth2disparity(disparity, **kwargs)
