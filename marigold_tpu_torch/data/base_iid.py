"""Base intrinsic-image-decomposition dataset (host numpy, HWC).

Behavioral reference: src/dataset/base_iid_dataset.py — HDR .exr reading
(OpenCV), linear->sRGB conversion for HDR RGB inputs, per-dataset
`_load_targets_data` hook, bilinear resize (nearest for masks), LR-flip
augmentation.
"""

from __future__ import annotations

import io
import os
import random
import tarfile
from typing import Optional

import numpy as np

from marigold_tpu_torch.data.base_depth import (
    DatasetMode,
    bilinear_resize,
    nearest_resize,
)
from marigold_tpu_torch.data.image_io import (
    decode_image_bytes,
    img_linear2srgb,
    is_hdr,
)


class BaseIIDDataset:
    def __init__(
        self,
        mode: DatasetMode,
        filename_ls_path: str,
        dataset_dir: str,
        disp_name: str,
        augmentation_args: Optional[dict] = None,
        resize_to_hw=None,
        **kwargs,
    ) -> None:
        self.mode = mode
        self.filename_ls_path = filename_ls_path
        self.dataset_dir = dataset_dir
        assert os.path.exists(
            self.dataset_dir
        ), f"Dataset does not exist at: {self.dataset_dir}"
        self.disp_name = disp_name
        self.augm_args = augmentation_args
        self.resize_to_hw = tuple(resize_to_hw) if resize_to_hw else None

        with open(self.filename_ls_path) as f:
            self.filenames = [s.split() for s in f.readlines()]

        self.tar_obj = None
        self.is_tar = os.path.isfile(dataset_dir) and tarfile.is_tarfile(dataset_dir)

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, index):
        rasters, other = self._get_data_item(index)
        if DatasetMode.TRAIN == self.mode:
            rasters = self._training_preprocess(rasters)
        outputs = rasters
        outputs.update(other)
        return outputs

    def _get_data_item(self, index):
        rgb_rel_path, targets_rel_path = self._get_data_path(index)
        rasters = {}
        rasters.update(self._load_rgb_data(rgb_rel_path))
        if DatasetMode.RGB_ONLY != self.mode:
            rasters.update(self._load_targets_data(rel_paths=targets_rel_path))
        other = {"index": index, "rgb_relative_path": rgb_rel_path}
        return rasters, other

    def _get_data_path(self, index):
        line = self.filenames[index]
        return line[0], line[1:]

    # ---------------- IO ---------------- #

    def _read_bytes(self, rel_path) -> bytes:
        if self.is_tar:
            if self.tar_obj is None:
                from .tario import TarIndex

                self.tar_obj = TarIndex(self.dataset_dir)
            return self.tar_obj.read(rel_path)
        with open(os.path.join(self.dataset_dir, rel_path), "rb") as f:
            return f.read()

    def _read_image(self, rel_path) -> np.ndarray:
        """-> [H,W,C] (or [H,W]) float in [0,1] (reference asserts this,
        base_iid_dataset.py:133-136)."""
        img = decode_image_bytes(self._read_bytes(rel_path), rel_path)
        assert img.min() >= 0, f"negative values in {rel_path}"
        return img

    def _read_numpy(self, rel_path) -> np.ndarray:
        return np.load(io.BytesIO(self._read_bytes(rel_path))).astype(np.float32)

    def _load_rgb_data(self, rgb_rel_path):
        rgb = self._read_image(rgb_rel_path)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        if is_hdr(rgb_rel_path):
            rgb = img_linear2srgb(rgb)
        return {"rgb": rgb.astype(np.float32)}  # [H,W,3] in [0,1]

    def _load_targets_data(self, rel_paths):
        return {}

    # ---------------- train preprocessing ---------------- #

    def _training_preprocess(self, rasters):
        if self.augm_args is not None:
            rasters = self._augment_data(rasters)
        if self.resize_to_hw is not None:
            out = {}
            for k, v in rasters.items():
                if "valid_mask" in k or k.startswith("mask"):
                    out[k] = nearest_resize(v, self.resize_to_hw)
                else:
                    out[k] = bilinear_resize(
                        v.astype(np.float32), self.resize_to_hw
                    )
            rasters = out
        return rasters

    def _augment_data(self, rasters):
        from . import rng as data_rng

        if data_rng.random() < self.augm_args.get("lr_flip_p", 0):
            rasters = {k: np.ascontiguousarray(v[:, ::-1]) for k, v in rasters.items()}
        return rasters

    def __del__(self):
        if getattr(self, "tar_obj", None) is not None:
            self.tar_obj.close()
            self.tar_obj = None
