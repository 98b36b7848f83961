"""Marigold surface-normals pipeline, PyTorch port.

API of `marigold_tpu/pipelines/normals.py` (the reference's
MarigoldNormalsPipeline.__call__): RGB -> unit normals in [-1, 1]^3. The
decode clips and L2-normalizes per pixel; ensembles reduce "closest" by
default, with uncertainty = mean angular deviation / pi; no scale or shift
invariance. LCM checkpoints are rejected, as in the reference.
`normals_img` is a PIL image when PIL is installed and an [H, W, 3] uint8
array otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from marigold_tpu_torch.pipelines import image_util
from marigold_tpu_torch.pipelines.base import BasePipeline

LCM_REJECTED = "LCM checkpoints are not supported for normals prediction"


@dataclasses.dataclass
class MarigoldNormalsOutput:
    """normals_np: [H, W, 3] float32 unit vectors in [-1, 1]; normals_img:
    PIL image (or uint8 array); uncertainty: [H, W] in [0, 1] for
    ensembles, else None."""

    normals_np: np.ndarray
    normals_img: Optional[Any]
    uncertainty: Optional[np.ndarray]


def _output(pred: np.ndarray, unc: Optional[np.ndarray]) -> MarigoldNormalsOutput:
    n = np.clip(pred, -1.0, 1.0).astype(np.float32)
    return MarigoldNormalsOutput(
        normals_np=n, normals_img=image_util.to_image(image_util.norm_to_rgb(n)),
        uncertainty=unc[..., 0] if unc is not None else None)


class MarigoldNormalsPipeline(BasePipeline):
    mode = "normals"
    n_targets = 1

    def _reject_lcm(self) -> None:
        if self.core.lcm is not None:
            raise ValueError(LCM_REJECTED)

    def __call__(
        self,
        input_image,
        denoising_steps: Optional[int] = None,
        ensemble_size: int = 1,
        processing_res: Optional[int] = None,
        match_input_res: bool = True,
        resample_method: str = "bilinear",
        batch_size: int = 0,
        generator: Union[None, int, torch.Generator] = None,
        seed: Optional[int] = None,
        show_progress_bar: bool = True,
        ensemble_kwargs: Optional[Dict] = None,
        shape_bucketing: bool = False,
        spatial: bool = False,
    ) -> MarigoldNormalsOutput:
        """One image -> MarigoldNormalsOutput (4 steps by default). The
        keywords are the depth pipeline's; `ensemble_kwargs` takes
        "reduction" ("closest" or "mean")."""
        self._reject_lcm()
        pred, unc = self._single_infer(
            input_image, denoising_steps, ensemble_size, processing_res,
            match_input_res, resample_method, batch_size,
            generator if seed is None else seed, ensemble_kwargs,
            shape_bucketing, spatial, default_steps=4)
        return _output(pred, unc)

    def batch_call(
        self,
        input_images,
        denoising_steps: Optional[int] = None,
        ensemble_size: int = 1,
        processing_res: Optional[int] = None,
        match_input_res: bool = True,
        resample_method: str = "bilinear",
        batch_size: int = 0,
        seed: Union[None, int, torch.Generator] = None,
        ensemble_kwargs: Optional[Dict] = None,
        compact_readback: bool = False,
    ) -> list:
        """Batched serving of same-shape images (the normals protocol runs
        E=10 at 640/768 px): all NI x E rows share the denoise batch.
        Returns a list of MarigoldNormalsOutput."""
        self._reject_lcm()
        preds, uncs = self._batch_infer(
            input_images, denoising_steps, ensemble_size, processing_res,
            match_input_res, resample_method, batch_size, seed,
            ensemble_kwargs, compact_readback=compact_readback,
        )
        return [_output(preds[i], uncs[i] if uncs is not None else None)
                for i in range(preds.shape[0])]
