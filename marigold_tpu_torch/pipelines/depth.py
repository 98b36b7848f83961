"""Marigold depth pipeline, PyTorch port.

API of `marigold_tpu/pipelines/depth.py` (itself the reference's
MarigoldDepthPipeline.__call__): RGB -> affine-invariant depth in [0, 1],
an optional colorized map and, for ensembles, an uncertainty. `generator`
takes an integer seed or a torch.Generator on the pipeline's device.
`from_pretrained(..., device=)` picks the device (the CUDA device unless
the caller passes device="cpu"). Numpy images are always
accepted, PIL images when PIL is installed; the colorized map is a PIL image
when PIL is installed and an [H, W, 3] uint8 array otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from marigold_tpu_torch.pipelines import image_util
from marigold_tpu_torch.pipelines.base import BasePipeline, image_to_array


@dataclasses.dataclass
class MarigoldDepthOutput:
    """depth_np: [H, W] float32 in [0, 1]; depth_colored: PIL image (or
    uint8 array) or None; uncertainty: [H, W] for ensembles, else None."""

    depth_np: np.ndarray
    depth_colored: Optional[Any]
    uncertainty: Optional[np.ndarray]


def _colorize(depth: np.ndarray, cmap: str):
    colored = image_util.float2int(image_util.chw2hwc(
        image_util.colorize_depth_maps(depth, 0.0, 1.0, cmap=cmap)[0]))
    try:
        from PIL import Image
    except ImportError:
        return colored
    return Image.fromarray(colored)


class MarigoldDepthPipeline(BasePipeline):
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
        of the VAE's 8 px; `spatial=True` (the H axis sharded over a mesh)
        raises NotImplementedError."""
        if denoising_steps is None:
            denoising_steps = self.default_denoising_steps or 1
        if processing_res is None:
            processing_res = self.default_processing_resolution or 768
        if processing_res < 0 or ensemble_size < 1:
            raise ValueError(f"processing_res={processing_res}, "
                             f"ensemble_size={ensemble_size}")
        self._check_inference_step(denoising_steps)
        if seed is None:
            seed = generator

        rgb_norm = image_to_array(input_image)
        input_h, input_w = rgb_norm.shape[:2]
        if processing_res > 0 and max(input_h, input_w) != processing_res:
            nh, nw = image_util.resize_max_res_shape(input_h, input_w, processing_res)
            rgb_norm = image_util.resize_np(rgb_norm, (nh, nw), method=resample_method)

        pred, unc = self._infer_fused(
            rgb_norm, denoising_steps=denoising_steps,
            ensemble_size=ensemble_size, batch_size=batch_size, seed=seed,
            out_hw=(input_h, input_w) if match_input_res else None,
            ensemble_kwargs=ensemble_kwargs, resample_method=resample_method,
            shape_bucketing=shape_bucketing, spatial=spatial,
        )
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
