"""LPIPS perceptual metric (VGG16 variant) in PyTorch.

Counterpart of `marigold_tpu/eval/lpips.py`, with the same weight file and
the same arithmetic (NCHW here, NHWC there). Role parity: the reference's
IID eval uses torchmetrics LPIPS (script/iid/eval.py:44-48,113-131), which
downloads pretrained VGG16 + learned linear calibration weights at runtime.
This implementation is offline-first: weights load from a local file
(safetensors/npz) passed explicitly or via $LPIPS_WEIGHTS; without weights
the metric is unavailable and callers skip it (the eval CLI reports which
metrics ran). One weight file gives the same metric in both packages.

The network runs on the CUDA device unless the caller asks for the CPU:
"cuda" without a card raises, as `from_pretrained` does. Its convolutions
run in full fp32 there (no TF32), so the card gives the CPU's metric.

Weight file layout (flat names):
  features.<idx>.weight / .bias   — torchvision VGG16 conv layers (OIHW)
  lins.<k>.weight                 — LPIPS 1x1 calibration convs [1,C,1,1]
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# torchvision VGG16 "features" conv indices and the 5 LPIPS tap points
_VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_TAP_AFTER_RELU_OF = [1, 3, 6, 9, 12]  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_POOL_BEFORE_CONV = {2, 4, 7, 10}  # conv positions preceded by maxpool

# ImageNet normalization in LPIPS convention (input in [-1,1])
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def _read_flat(path: str) -> dict:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    from marigold_tpu_torch.models.weights import read_safetensors

    return read_safetensors(path)


class LPIPS:
    """params: {"convs": [{"weight" OIHW, "bias"}] x 13, "lins": [C] x 5},
    fp32 tensors on `device`."""

    def __init__(self, params: dict, device="cuda"):
        self.device = torch.device(device)
        self.params = params

    @classmethod
    def from_file(cls, path: Optional[str] = None,
                  device="cuda") -> Optional["LPIPS"]:
        """None when there is no weight file; raises when `device` is CUDA
        and there is no card."""
        path = path or os.environ.get("LPIPS_WEIGHTS")
        if not path or not os.path.exists(path):
            return None
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LPIPS runs on the CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(--device cpu) to run it on the host")
        flat = _read_flat(path)

        def t(x):
            return x.to(device=device, dtype=torch.float32)

        params = {
            "convs": [{"weight": t(flat[f"features.{idx}.weight"]),
                       "bias": t(flat[f"features.{idx}.bias"])}
                      for idx in _VGG16_CONV_IDX],
            "lins": [t(flat[f"lins.{k}.weight"]).reshape(-1)
                     for k in range(5)],
        }
        return cls(params, device)

    def _features(self, x: torch.Tensor) -> list:
        """x: [B,3,H,W] in [-1,1] -> list of 5 normalized feature maps."""
        shift = torch.from_numpy(_SHIFT).to(x.device).reshape(1, 3, 1, 1)
        scale = torch.from_numpy(_SCALE).to(x.device).reshape(1, 3, 1, 1)
        h = (x - shift) / scale
        feats = []
        for pos, p in enumerate(self.params["convs"]):
            if pos in _POOL_BEFORE_CONV:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(F.conv2d(h, p["weight"], p["bias"], padding=1))
            if pos in _TAP_AFTER_RELU_OF:
                n = torch.sqrt(torch.sum(h**2, dim=1, keepdim=True))
                feats.append(h / torch.clamp(n, min=1e-10))
        return feats

    @torch.inference_mode()
    def __call__(self, pred, gt) -> float:
        """pred/gt: [H,W,3] in [0,1] -> LPIPS distance (lower=better)."""
        def batch(x):
            x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            return x.permute(2, 0, 1)[None] * 2.0 - 1.0

        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            fa = self._features(batch(pred))
            fb = self._features(batch(gt))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        total = 0.0
        for k in range(5):
            d = (fa[k] - fb[k]) ** 2
            w = self.params["lins"][k].reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * w, dim=1))
        return float(total)


def get_lpips(path: Optional[str] = None, device="cuda") -> Optional[LPIPS]:
    return LPIPS.from_file(path, device)
