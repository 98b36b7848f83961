"""Evaluation metrics for depth / normals / IID, host-side numpy.

Behavioral reference: src/util/metric.py in prs-eth/Marigold. Formula notes:
  * depth metrics (lines 64-188) zero-out invalid pixels and divide by the
    per-image valid count, then mean over the batch dim; we reproduce that
    exactly (it differs from masked-flatten means when batch>1).
  * SILog (175-188) is sqrt(mean(E[d^2] - E[d]^2-ish terms)) * 100.
  * normals metrics (194-257) operate on a flat array of per-pixel angular
    errors in degrees, rounded to 4 decimals.
  * IID (263-338): shading/residual are scale-aligned to GT via 1-param
    least squares, then quantile-mapped so GT's 90th-percentile brightness
    is 0.8 before PSNR/SSIM.

These run per-sample on host (shapes vary per dataset; keeping them off the
TPU avoids shape-churn recompiles — the heavy lifting is in the pipeline).
"""

from __future__ import annotations

import numpy as np


# -------------------- tracker -------------------- #


class MetricTracker:
    """Streaming average tracker (reference src/util/metric.py:37-58)."""

    def __init__(self, *keys, writer=None):
        self.writer = writer
        self.keys = list(keys)
        self.reset()

    def reset(self):
        self._total = {k: 0.0 for k in self.keys}
        self._counts = {k: 0 for k in self.keys}

    def update(self, key, value, n=1):
        if self.writer is not None:
            self.writer.add_scalar(key, value)
        if key not in self._total:
            self.keys.append(key)
            self._total[key] = 0.0
            self._counts[key] = 0
        self._total[key] += float(value) * n
        self._counts[key] += n

    def avg(self, key):
        return self._total[key] / max(self._counts[key], 1)

    def result(self):
        return {k: self.avg(k) for k in self.keys}


# -------------------- depth -------------------- #


def _prep(output, target, valid_mask):
    output = np.asarray(output, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if output.ndim == 2:
        output, target = output[None], target[None]
        if valid_mask is not None:
            valid_mask = np.asarray(valid_mask, bool)[None]
    if valid_mask is None:
        valid_mask = np.ones_like(output, dtype=bool)
    else:
        valid_mask = np.asarray(valid_mask, bool)
        if valid_mask.ndim == 2:
            valid_mask = valid_mask[None]
    return output, target, valid_mask


def _masked_image_mean(x, valid_mask):
    x = np.where(valid_mask, x, 0.0)
    n = valid_mask.sum(axis=(-1, -2))
    with np.errstate(invalid="ignore"):
        # an all-invalid image yields NaN (reference divides by n and
        # propagates it) — a silent 0 would average a fake perfect score
        # into the benchmark
        return np.where(n > 0, x.sum(axis=(-1, -2)) / np.maximum(n, 1),
                        np.nan)


def abs_relative_difference(output, target, valid_mask=None):
    output, target, m = _prep(output, target, valid_mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(output - target) / target
    # exclude INVALID pixels via the mask only; a VALID pixel with
    # target==0 must propagate its inf/nan like the reference (a blanket
    # nan_to_num averaged a fake-perfect 0 into the benchmark)
    rel = np.where(m, rel, 0.0)
    return float(_masked_image_mean(rel, m).mean())


def squared_relative_difference(output, target, valid_mask=None):
    output, target, m = _prep(output, target, valid_mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(output - target) ** 2 / target
    rel = np.where(m, rel, 0.0)  # see abs_relative_difference
    return float(_masked_image_mean(rel, m).mean())


def rmse_linear(output, target, valid_mask=None):
    output, target, m = _prep(output, target, valid_mask)
    mse = _masked_image_mean((output - target) ** 2, m)
    return float(np.sqrt(mse).mean())


def rmse_log(output, target, valid_mask=None):
    output, target, m = _prep(output, target, valid_mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.log(output) - np.log(target)
    # invalid pixels excluded by the mask; a VALID non-positive depth
    # propagates its inf/nan like the reference
    mse = _masked_image_mean(np.where(m, d, 0.0) ** 2, m)
    return float(np.sqrt(mse).mean())


def log10(output, target, valid_mask=None):
    output, target, m = _prep(output, target, valid_mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.abs(np.log10(output) - np.log10(target))
    return float(d[m].mean())


def threshold_percentage(output, target, threshold_val, valid_mask=None):
    output, target, m = _prep(output, target, valid_mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.maximum(output / target, target / output)
    bit = (np.nan_to_num(ratio, nan=np.inf) < threshold_val).astype(np.float64)
    return float(_masked_image_mean(bit, m).mean())


def delta1_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25, valid_mask)


def delta2_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25**2, valid_mask)


def delta3_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25**3, valid_mask)


def i_rmse(output, target, valid_mask=None):
    output, target, m = _prep(output, target, valid_mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = 1.0 / output - 1.0 / target
    mse = _masked_image_mean(np.nan_to_num(d * m) ** 2, m)
    return float(np.sqrt(mse).mean())


def silog_rmse(depth_pred, depth_gt, valid_mask=None):
    pred, gt, m = _prep(depth_pred, depth_gt, valid_mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.log(pred) - np.log(gt)
    d = np.nan_to_num(d * m)
    n = np.maximum(m.sum(axis=(-1, -2)), 1)
    first = (d**2).sum(axis=(-1, -2)) / n
    second = d.sum(axis=(-1, -2)) ** 2 / n**2
    return float(np.sqrt(np.maximum(np.mean(first - second), 0.0)) * 100)


DEPTH_METRICS = {
    "abs_relative_difference": abs_relative_difference,
    "squared_relative_difference": squared_relative_difference,
    "rmse_linear": rmse_linear,
    "rmse_log": rmse_log,
    "log10": log10,
    "delta1_acc": delta1_acc,
    "delta2_acc": delta2_acc,
    "delta3_acc": delta3_acc,
    "i_rmse": i_rmse,
    "silog_rmse": silog_rmse,
}


# -------------------- normals -------------------- #


def compute_cosine_error(pred_norm, gt_norm, masked=False):
    """Per-pixel angular error in degrees, flattened.
    Inputs [H,W,3] (or [3,H,W]; detected by which axis has size 3)."""
    pred = np.asarray(pred_norm, np.float64)
    gt = np.asarray(gt_norm, np.float64)
    if pred.ndim == 4:
        if pred.shape[0] != 1:
            raise ValueError(
                f"compute_cosine_error is per-image; got a batch of "
                f"{pred.shape[0]} (loop over images instead)"
            )
        pred = pred[0]
    if gt.ndim == 4:
        if gt.shape[0] != 1:
            raise ValueError(
                f"compute_cosine_error is per-image; got a batch of "
                f"{gt.shape[0]} (loop over images instead)"
            )
        gt = gt[0]
    if pred.shape[0] == 3 and pred.shape[-1] != 3:  # CHW -> HWC
        pred = np.moveaxis(pred, 0, -1)
        gt = np.moveaxis(gt, 0, -1)
    if masked:
        mask = np.linalg.norm(gt, axis=-1) > 0
        pred, gt = pred[mask], gt[mask]
    else:
        pred, gt = pred.reshape(-1, 3), gt.reshape(-1, 3)
    pn = np.linalg.norm(pred, axis=-1)
    gn = np.linalg.norm(gt, axis=-1)
    cos = (pred * gt).sum(-1) / np.maximum(pn * gn, 1e-12)
    cos = np.clip(cos, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def mean_angular_error(cosine_error):
    return round(float(np.mean(cosine_error)), 4)


def median_angular_error(cosine_error):
    return round(float(np.median(cosine_error)), 4)


def rmse_angular_error(cosine_error):
    return round(float(np.sqrt(np.mean(np.square(cosine_error)))), 4)


def _sub(cosine_error, deg):
    return round(100.0 * float(np.mean(cosine_error < deg)), 4)


def sub5_error(cosine_error):
    return _sub(cosine_error, 5)


def sub7_5_error(cosine_error):
    return _sub(cosine_error, 7.5)


def sub11_25_error(cosine_error):
    return _sub(cosine_error, 11.25)


def sub22_5_error(cosine_error):
    return _sub(cosine_error, 22.5)


def sub30_error(cosine_error):
    return _sub(cosine_error, 30)


NORMALS_METRICS = {
    "mean_angular_error": mean_angular_error,
    "median_angular_error": median_angular_error,
    "rmse_angular_error": rmse_angular_error,
    "sub5_error": sub5_error,
    "sub7_5_error": sub7_5_error,
    "sub11_25_error": sub11_25_error,
    "sub22_5_error": sub22_5_error,
    "sub30_error": sub30_error,
}


# -------------------- IID -------------------- #


def compute_alignment_scale(pred, gt, valid_mask=None):
    """1-param least-squares scale mapping pred -> gt over valid pixels
    (reference metric.py:291-305). Inputs HWC or CHW, any shape."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if valid_mask is not None:
        m = np.asarray(valid_mask, bool)
        pred, gt = pred[m], gt[m]
    pred, gt = pred.reshape(-1), gt.reshape(-1)
    denom = (pred * pred).sum()
    if denom <= 0:
        return 0.0
    return float((pred * gt).sum() / denom)


def quantile_map(pred, gt, valid_mask=None, percentile=90,
                 brightness_target=0.8):
    """Scale both pred and gt so gt's Nth-percentile luma is
    `brightness_target`, clip to [0,1] (reference metric.py:308-338).
    Inputs [H,W,3]."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    luma = 0.3 * gt[..., 0] + 0.59 * gt[..., 1] + 0.11 * gt[..., 2]
    if valid_mask is not None:
        vm = np.asarray(valid_mask, bool)
        if vm.ndim == 3:
            vm = vm[..., 0]
        luma = luma[vm]
    cur = np.quantile(luma.reshape(-1), percentile / 100.0)
    scale = 0.0 if cur < 1e-4 else brightness_target / cur
    return np.clip(scale * pred, 0, 1), np.clip(scale * gt, 0, 1)


def psnr(pred, gt, data_range=1.0):
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    mse = np.mean((pred - gt) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range**2 / mse))


def ssim(pred, gt, data_range=1.0):
    """SSIM with 11x11 Gaussian window sigma=1.5 (standard; matches
    torchmetrics defaults used by reference script/iid/eval.py:113-115).
    Inputs [H,W,C]."""
    from scipy.ndimage import gaussian_filter

    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    sig, trunc = 1.5, (11 - 1) / 2 / 1.5  # 11-tap window
    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        mu_x = gaussian_filter(x, sig, truncate=trunc)
        mu_y = gaussian_filter(y, sig, truncate=trunc)
        sxx = gaussian_filter(x * x, sig, truncate=trunc) - mu_x**2
        syy = gaussian_filter(y * y, sig, truncate=trunc) - mu_y**2
        sxy = gaussian_filter(x * y, sig, truncate=trunc) - mu_x * mu_y
        s = ((2 * mu_x * mu_y + C1) * (2 * sxy + C2)) / (
            (mu_x**2 + mu_y**2 + C1) * (sxx + syy + C2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


def compute_iid_metric(pred, gt, target_name, metric_fn, valid_mask=None,
                       metric_name="psnr"):
    """Reference compute_iid_metric (metric.py:263-287): shading/residual are
    scale-aligned + quantile-mapped first; PSNR uses only valid pixels,
    SSIM/LPIPS zero-out invalid pixels. Inputs [H,W,3]."""
    pred = np.asarray(pred, np.float64).copy()
    gt = np.asarray(gt, np.float64).copy()
    if target_name in ("shading", "residual"):
        s = compute_alignment_scale(pred, gt, valid_mask)
        pred = s * pred
        pred, gt = quantile_map(pred, gt, valid_mask)
    if valid_mask is not None:
        vm = np.asarray(valid_mask, bool)
        if metric_name == "psnr":
            return metric_fn(pred[vm], gt[vm])
        pred[~vm] = 0
        gt[~vm] = 0
    return metric_fn(pred, gt)
