"""Base depth dataset — host-side numpy, HWC layout (TPU-native).

Copy of `marigold_tpu/data/base_depth.py` for the PyTorch port (framework
free, so shared as it is). Tar archives are read through `data/tario.py`'s
`TarIndex`, the native indexed reader (tarfile when it cannot build), as in
the JAX package.

Behavioral reference: src/dataset/base_depth_dataset.py — modes
RGB_ONLY/EVAL/TRAIN, filename lists from data_split txt files, transparent
tar-archive or directory reading, min/max-depth validity masks, train-time
flip augmentation + depth normalization + invalid-to-far-plane +
nearest-exact resize, and the 4 prediction file-naming modes.

Differences by design: arrays are HWC numpy (rgb_int [H,W,3] int32,
rgb_norm [H,W,3] f32 in [-1,1], depth/masks [H,W,1]) instead of torch CHW
— the TPU compute path is NHWC end to end.
"""

from __future__ import annotations

import io
import os
import random
import tarfile
from enum import Enum
from typing import Optional

import numpy as np
from PIL import Image


class DatasetMode(Enum):
    RGB_ONLY = "rgb_only"
    EVAL = "evaluate"
    TRAIN = "train"


class DepthFileNameMode(Enum):
    """Prediction file naming modes (reference base_depth_dataset.py:52-58)."""

    id = 1  # id.png
    rgb_id = 2  # rgb_id.png
    i_d_rgb = 3  # i_d_1_rgb.png
    rgb_i_d = 4


def nearest_resize(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Nearest-exact resize for [H,W,C] numpy arrays (torchvision
    NEAREST_EXACT semantics: sample at (i+0.5)*scale)."""
    h, w = img.shape[0], img.shape[1]
    th, tw = hw
    ri = np.minimum(((np.arange(th) + 0.5) * h / th).astype(int), h - 1)
    ci = np.minimum(((np.arange(tw) + 0.5) * w / tw).astype(int), w - 1)
    return img[np.ix_(ri, ci)]


def bilinear_resize(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize for [H,W,C] float arrays (host-side, PIL-backed).

    Deliberately NOT pipelines.image_util.resize_np (which routes through
    jax and is the torchvision-antialiased-parity path): this runs inside
    forked dataloader workers, where touching jax means per-process
    backend init + per-shape compiles. PIL's BILINEAR applies the same
    antialiased triangle filter torchvision's default (antialias=True)
    uses — the filter the reference's train-time Resize applies
    (base_normals_dataset.py:186-190)."""
    from PIL import Image as PILImage

    arr = np.asarray(img, np.float32)
    chans = [
        np.asarray(
            PILImage.fromarray(arr[..., c]).resize(
                (hw[1], hw[0]), PILImage.BILINEAR
            )
        )
        for c in range(arr.shape[-1])
    ]
    return np.stack(chans, axis=-1)


class BaseDepthDataset:
    def __init__(
        self,
        mode: DatasetMode,
        filename_ls_path: str,
        dataset_dir: str,
        disp_name: str,
        min_depth: float,
        max_depth: float,
        has_filled_depth: bool,
        name_mode: DepthFileNameMode,
        depth_transform=None,
        augmentation_args: Optional[dict] = None,
        resize_to_hw=None,
        move_invalid_to_far_plane: bool = True,
        **kwargs,
    ) -> None:
        self.mode = mode
        self.filename_ls_path = filename_ls_path
        self.dataset_dir = dataset_dir
        assert os.path.exists(
            self.dataset_dir
        ), f"Dataset does not exist at: {self.dataset_dir}"
        self.disp_name = disp_name
        self.has_filled_depth = has_filled_depth
        self.name_mode = name_mode
        self.min_depth = min_depth
        self.max_depth = max_depth

        self.depth_transform = depth_transform
        self.augm_args = augmentation_args
        self.resize_to_hw = tuple(resize_to_hw) if resize_to_hw else None
        self.move_invalid_to_far_plane = move_invalid_to_far_plane

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

    # ---------------- IO ---------------- #

    def _read_bytes(self, rel_path) -> bytes:
        if self.is_tar:
            if self.tar_obj is None:
                from .tario import TarIndex

                self.tar_obj = TarIndex(self.dataset_dir)
            return self.tar_obj.read(rel_path)
        with open(os.path.join(self.dataset_dir, rel_path), "rb") as f:
            return f.read()

    def _read_image(self, img_rel_path) -> np.ndarray:
        data = self._read_bytes(img_rel_path)
        image = Image.open(io.BytesIO(data))
        return np.asarray(image)

    def _read_rgb_file(self, rel_path) -> np.ndarray:
        """-> [H,W,3] int array."""
        rgb = self._read_image(rel_path)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        return rgb.astype(np.int32)

    def _read_depth_file(self, rel_path) -> np.ndarray:
        return self._read_image(rel_path)

    # ---------------- assembly ---------------- #

    def _get_data_path(self, index):
        line = self.filenames[index]
        rgb_rel_path = line[0]
        depth_rel_path, filled_rel_path = None, None
        if DatasetMode.RGB_ONLY != self.mode:
            depth_rel_path = line[1]
            if self.has_filled_depth:
                filled_rel_path = line[2]
        return rgb_rel_path, depth_rel_path, filled_rel_path

    def _get_data_item(self, index):
        rgb_rel_path, depth_rel_path, filled_rel_path = self._get_data_path(index)
        rasters = {}
        rasters.update(self._load_rgb_data(rgb_rel_path))
        if DatasetMode.RGB_ONLY != self.mode:
            rasters.update(self._load_depth_data(depth_rel_path, filled_rel_path))
            rasters["valid_mask_raw"] = self._get_valid_mask(
                rasters["depth_raw_linear"]
            )
            rasters["valid_mask_filled"] = self._get_valid_mask(
                rasters["depth_filled_linear"]
            )
        other = {"index": index, "rgb_relative_path": rgb_rel_path}
        return rasters, other

    def _load_rgb_data(self, rgb_rel_path):
        rgb = self._read_rgb_file(rgb_rel_path)  # [H,W,3] int
        rgb_norm = rgb.astype(np.float32) / 255.0 * 2.0 - 1.0
        return {"rgb_int": rgb, "rgb_norm": rgb_norm}

    def _load_depth_data(self, depth_rel_path, filled_rel_path):
        outputs = {}
        depth_raw = np.asarray(self._read_depth_file(depth_rel_path)).squeeze()
        depth_raw = depth_raw.astype(np.float32)[..., None]  # [H,W,1]
        outputs["depth_raw_linear"] = depth_raw.copy()
        if self.has_filled_depth:
            depth_filled = np.asarray(
                self._read_depth_file(filled_rel_path)
            ).squeeze().astype(np.float32)[..., None]
            outputs["depth_filled_linear"] = depth_filled
        else:
            outputs["depth_filled_linear"] = depth_raw.copy()
        return outputs

    def _get_valid_mask(self, depth: np.ndarray) -> np.ndarray:
        return (depth > self.min_depth) & (depth < self.max_depth)

    # ---------------- train preprocessing ---------------- #

    def _training_preprocess(self, rasters):
        if self.augm_args is not None:
            rasters = self._augment_data(rasters)

        rasters["depth_raw_norm"] = self.depth_transform(
            rasters["depth_raw_linear"], rasters["valid_mask_raw"]
        ).astype(np.float32)
        rasters["depth_filled_norm"] = self.depth_transform(
            rasters["depth_filled_linear"], rasters["valid_mask_filled"]
        ).astype(np.float32)

        if self.move_invalid_to_far_plane:
            fill = (
                self.depth_transform.norm_max
                if self.depth_transform.far_plane_at_max
                else self.depth_transform.norm_min
            )
            rasters["depth_filled_norm"] = np.where(
                rasters["valid_mask_filled"], rasters["depth_filled_norm"], fill
            )

        if self.resize_to_hw is not None:
            rasters = {
                k: nearest_resize(v, self.resize_to_hw) for k, v in rasters.items()
            }
        return rasters

    def _augment_data(self, rasters):
        from . import rng as data_rng

        lr_flip_p = self.augm_args.get("lr_flip_p", 0)
        if data_rng.random() < lr_flip_p:
            rasters = {k: np.ascontiguousarray(v[:, ::-1]) for k, v in rasters.items()}
        return rasters

    def __del__(self):
        if getattr(self, "tar_obj", None) is not None:
            self.tar_obj.close()
            self.tar_obj = None


def get_pred_name(rgb_basename: str, name_mode: DepthFileNameMode,
                  suffix: str = ".png") -> str:
    """Prediction filename for a given RGB filename
    (reference base_depth_dataset.py:271-285)."""
    if DepthFileNameMode.rgb_id == name_mode:
        pred_basename = "pred_" + rgb_basename.split("_")[1]
    elif DepthFileNameMode.i_d_rgb == name_mode:
        pred_basename = rgb_basename.replace("_rgb.", "_pred.")
    elif DepthFileNameMode.id == name_mode:
        pred_basename = "pred_" + rgb_basename
    elif DepthFileNameMode.rgb_i_d == name_mode:
        pred_basename = "pred_" + "_".join(rgb_basename.split("_")[1:])
    else:
        raise NotImplementedError
    return os.path.splitext(pred_basename)[0] + suffix
