"""Marigold depth pipeline, PyTorch port.

API of `marigold_tpu/pipelines/depth.py` (itself the reference's
MarigoldDepthPipeline.__call__): RGB -> affine-invariant depth in [0, 1],
an optional colorized map and, for ensembles, an uncertainty. `generator`
takes an integer seed or a torch.Generator on the pipeline's device.
`from_pretrained(..., device=)` picks the device (the CUDA device unless
the caller passes device="cpu"). A checkpoint with an LCMScheduler config
(the deprecated v1-0 LCM model) samples with LCM and logs a deprecation
warning. Numpy images are always
accepted, PIL images when PIL is installed; the colorized map is a PIL image
when PIL is installed and an [H, W, 3] uint8 array otherwise.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from marigold_tpu_torch.pipelines import image_util
from marigold_tpu_torch.pipelines.base import BasePipeline

logger = logging.getLogger(__name__)

LCM_DEPRECATION = (
    "LCM checkpoint detected: the LCM depth checkpoint is deprecated; "
    "consider marigold-depth-v1-1 (reference deprecation, "
    "marigold_depth_pipeline.py:368-377)")


@dataclasses.dataclass
class MarigoldDepthOutput:
    """depth_np: [H, W] float32 in [0, 1]; depth_colored: PIL image (or
    uint8 array) or None; uncertainty: [H, W] for ensembles, else None."""

    depth_np: np.ndarray
    depth_colored: Optional[Any]
    uncertainty: Optional[np.ndarray]


def _colorize(depth: np.ndarray, cmap: str):
    return image_util.to_image(image_util.float2int(image_util.chw2hwc(
        image_util.colorize_depth_maps(depth, 0.0, 1.0, cmap=cmap)[0])))


class MarigoldDepthPipeline(BasePipeline):
    mode = "depth"
    n_targets = 1

    def _warn_lcm(self) -> None:
        if self.core.lcm is not None:
            logger.warning(LCM_DEPRECATION)

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
        color_map: Optional[str] = "Spectral",
        show_progress_bar: bool = True,
        ensemble_kwargs: Optional[Dict] = None,
        shape_bucketing: bool = False,
        spatial: bool = False,
    ) -> MarigoldDepthOutput:
        """One image -> MarigoldDepthOutput. ensemble_size > 1 runs the
        members in chunks of batch_size (0: from the device's memory) and
        ensembles them with `ensemble_kwargs` (see
        `pipelines/ensemble.py:ensemble_depth`). The keywords are the JAX
        package's: `show_progress_bar` is accepted and, as there, has no
        effect; `shape_bucketing=True` pads the image to a 64-px grid instead
        of the VAE's 8 px. A pipeline built with a mesh
        (`from_pretrained(..., mesh=get_mesh())`, in every rank) shards the
        members over the ranks, or with `spatial=True` the image's H rows
        (`BasePipeline._infer_fused`)."""
        self._warn_lcm()
        pred, unc = self._single_infer(
            input_image, denoising_steps, ensemble_size, processing_res,
            match_input_res, resample_method, batch_size,
            generator if seed is None else seed, ensemble_kwargs,
            shape_bucketing, spatial, default_steps=1)
        depth = np.clip(pred[..., 0], 0.0, 1.0).astype(np.float32)
        return MarigoldDepthOutput(
            depth_np=depth,
            depth_colored=_colorize(depth, color_map) if color_map else None,
            uncertainty=unc[..., 0] if unc is not None else None,
        )

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
        color_map: Optional[str] = None,
        ensemble_kwargs: Optional[Dict] = None,
        compact_readback: bool = False,
    ) -> list:
        """Batched serving of same-shape images: all NI x E rows share the
        denoise batch. Returns a list of MarigoldDepthOutput."""
        self._warn_lcm()
        preds, uncs = self._batch_infer(
            input_images, denoising_steps, ensemble_size, processing_res,
            match_input_res, resample_method, batch_size, seed,
            ensemble_kwargs, default_steps=1,
            compact_readback=compact_readback,
        )
        outputs = []
        for i in range(preds.shape[0]):
            depth = np.clip(preds[i, ..., 0], 0.0, 1.0).astype(np.float32)
            outputs.append(MarigoldDepthOutput(
                depth_np=depth,
                depth_colored=_colorize(depth, color_map) if color_map else None,
                uncertainty=uncs[i, ..., 0] if uncs is not None else None,
            ))
        return outputs
