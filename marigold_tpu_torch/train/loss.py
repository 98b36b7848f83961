"""Training losses, factory-compatible with the reference configs.

Counterpart of `marigold_tpu/train/loss.py`: `get_loss` dispatches on name
to silog_mse / silog_rmse / mse_loss / l1_loss / l1_loss_with_mask /
mean_abs_rel. Elementwise in fp32, so the layout (NCHW here) does not
matter. All shipped configs use `mse_loss` with reduction=mean.
"""

from __future__ import annotations

import functools

import torch


def _reduce(x: torch.Tensor, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none" or reduction is None:
        return x
    raise ValueError(f"unknown reduction: {reduction}")


def _masked_mean(x: torch.Tensor, valid_mask) -> torch.Tensor:
    if valid_mask is None:
        return x.sum() / x.numel()
    x = torch.where(valid_mask, x, torch.zeros_like(x))
    return x.sum() / valid_mask.sum().clamp(min=1)


def mse_loss(pred, target, reduction="mean", **kwargs):
    return _reduce((pred.float() - target.float()) ** 2, reduction)


def l1_loss(pred, target, reduction="mean", **kwargs):
    return _reduce((pred.float() - target.float()).abs(), reduction)


def l1_loss_with_mask(pred, target, valid_mask=None, **kwargs):
    return _masked_mean((pred.float() - target.float()).abs(), valid_mask)


def mean_abs_rel(pred, target, valid_mask=None, eps=1e-6, **kwargs):
    rel = (pred.float() - target.float()).abs() / (target.float().abs() + eps)
    return _masked_mean(rel, valid_mask)


def silog_loss(pred, target, valid_mask=None, variance_focus=0.85,
               rmse=False, eps=1e-8, **kwargs):
    """Scale-invariant log loss (SILog). `rmse=True` takes the sqrt."""
    d = torch.log(pred.float().clamp(min=eps)) - torch.log(
        target.float().clamp(min=eps))
    if valid_mask is not None:
        d = torch.where(valid_mask, d, torch.zeros_like(d))
        n = valid_mask.sum().clamp(min=1)
    else:
        n = d.numel()
    loss = (d**2).sum() / n - variance_focus * (d.sum() / n) ** 2
    return torch.sqrt(loss + eps) if rmse else loss


def silog_mse(pred, target, valid_mask=None, **kw):
    return silog_loss(pred, target, valid_mask, rmse=False, **kw)


def silog_rmse(pred, target, valid_mask=None, **kw):
    return silog_loss(pred, target, valid_mask, rmse=True, **kw)


_LOSSES = {
    "mse_loss": mse_loss,
    "l1_loss": l1_loss,
    "l1_loss_with_mask": l1_loss_with_mask,
    "mean_abs_rel": mean_abs_rel,
    "silog_mse": silog_mse,
    "silog_rmse": silog_rmse,
}


def get_loss(loss_name: str, **kwargs):
    """Factory by config name."""
    if loss_name not in _LOSSES:
        raise ValueError(f"unknown loss: {loss_name}")
    fn = _LOSSES[loss_name]
    return functools.partial(fn, **kwargs) if kwargs else fn
