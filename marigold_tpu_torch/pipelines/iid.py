"""Marigold intrinsic-image-decomposition (IID) pipeline, PyTorch port.

API of `marigold_tpu/pipelines/iid.py` (the reference's
MarigoldIIDPipeline): the target modalities are named by the checkpoint's
`target_properties` (model_index.json), or `target_0..` from the UNet's
out_channels / 4 when it names none. The target latent has 4 * n_targets
channels, each 4-channel group decodes through the shared VAE, and the
outputs fill a MarigoldIIDOutput keyed by target name, visualized per
`prediction_space` (srgb / linear, optionally up to scale / stack). Entry
arrays are CHW [3, H, W] in [0, 1]. Entry images are PIL images when PIL is
installed and [H, W, 3] uint8 arrays otherwise. LCM checkpoints are
rejected, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from marigold_tpu_torch.pipelines import image_util
from marigold_tpu_torch.pipelines.base import BasePipeline

LCM_REJECTED = "LCM checkpoints are not supported for IID prediction"


@dataclasses.dataclass
class IIDEntry:
    """One decomposed component: array [3, H, W] in [0, 1], image, optional
    uncertainty [3, H, W]."""

    name: str
    array: Optional[np.ndarray] = None
    image: Optional[Any] = None
    uncertainty: Optional[np.ndarray] = None


class MarigoldIIDOutput:
    """Entries keyed by target name."""

    def __init__(self, target_names: List[str]):
        self.n_targets = len(target_names)
        self.target_names = target_names
        self.entries: List[IIDEntry] = [IIDEntry(name=n) for n in target_names]
        self._entry_map = {e.name: e for e in self.entries}
        self._filled = set()

    def fill_entry(self, name: str, prediction: np.ndarray,
                   uncertainty: Optional[np.ndarray] = None,
                   target_properties: Optional[Dict[str, Any]] = None) -> None:
        """prediction [3, H, W] in [0, 1]. The image: "linear" targets go
        through linear2srgb (divided by their max first when
        `up_to_scale`), "srgb" and "stack" ones are shown as they are."""
        if name not in self._entry_map:
            raise KeyError(f"Unknown entry name: {name}")
        if name in self._filled:
            raise RuntimeError(f"Entry {name} already filled")
        entry = self._entry_map[name]

        array = np.asarray(prediction).squeeze()
        img_array = array
        space = (target_properties or {}).get(name, {}).get(
            "prediction_space", "srgb")
        if space == "linear":
            if target_properties[name].get("up_to_scale", False):
                img_array = img_array / max(img_array.max(), 1e-6)
            img_array = image_util.linear2srgb(img_array)
        img_u8 = (np.clip(img_array, 0, 1) * 255).astype(np.uint8)

        entry.array = array
        entry.image = image_util.to_image(image_util.chw2hwc(img_u8))
        entry.uncertainty = (np.asarray(uncertainty).squeeze()
                             if uncertainty is not None else None)
        self._filled.add(name)

    @property
    def is_complete(self) -> bool:
        return len(self._filled) == self.n_targets

    def __getitem__(self, key: str) -> IIDEntry:
        return self._entry_map[key]

    def __iter__(self):
        return iter(self.entries)


class MarigoldIIDPipeline(BasePipeline):
    mode = "iid"

    def __init__(self, core, pipe_cfg):
        super().__init__(core, pipe_cfg)
        self.target_properties = pipe_cfg.get("target_properties") or {}
        self.target_names = self.target_properties.get("target_names")
        latent = core.vae_cfg.latent_channels
        if not self.target_names:
            n = core.unet_cfg.out_channels // latent
            self.target_names = [f"target_{i}" for i in range(n)]
        self.n_targets = len(self.target_names)
        if core.unet_cfg.out_channels != latent * self.n_targets:
            raise ValueError(
                f"UNet out_channels {core.unet_cfg.out_channels} != "
                f"{latent} * n_targets ({latent * self.n_targets})")

    def _reject_lcm(self) -> None:
        if self.core.lcm is not None:
            raise ValueError(LCM_REJECTED)

    def _output(self, pred: np.ndarray, unc: Optional[np.ndarray]
                ) -> MarigoldIIDOutput:
        """pred [h, w, 3n] (and unc, per channel) -> the filled output."""
        output = MarigoldIIDOutput(target_names=self.target_names)
        for i, name in enumerate(self.target_names):
            sl = slice(i * 3, i * 3 + 3)
            output.fill_entry(
                name=name, prediction=image_util.hwc2chw(pred[..., sl]),
                uncertainty=(image_util.hwc2chw(unc[..., sl])
                             if unc is not None else None),
                target_properties=self.target_properties)
        return output

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
    ) -> MarigoldIIDOutput:
        """One image -> MarigoldIIDOutput (4 steps by default). The keywords
        are the depth pipeline's; `ensemble_kwargs` takes "reduction"
        ("median" or "mean")."""
        self._reject_lcm()
        pred, unc = self._single_infer(
            input_image, denoising_steps, ensemble_size, processing_res,
            match_input_res, resample_method, batch_size,
            generator if seed is None else seed, ensemble_kwargs,
            shape_bucketing, spatial, default_steps=4)
        return self._output(pred, unc)

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
        """Batched serving of same-shape images (the IID protocol runs E=1,
        so the images are the only batching axis). Returns a list of
        MarigoldIIDOutput."""
        self._reject_lcm()
        preds, uncs = self._batch_infer(
            input_images, denoising_steps, ensemble_size, processing_res,
            match_input_res, resample_method, batch_size, seed,
            ensemble_kwargs, compact_readback=compact_readback,
        )
        return [self._output(preds[b], uncs[b] if uncs is not None else None)
                for b in range(preds.shape[0])]
