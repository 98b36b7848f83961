"""Base surface-normals dataset (host numpy, HWC).

Behavioral reference: src/dataset/base_normals_dataset.py — normals from
.npy [H,W,3]; train augmentations: LR flip with normal-x negation,
Gaussian blur + motion blur (768-height i.e. Hypersim samples only),
color jitter; bilinear resize_to_hw.
"""

from __future__ import annotations

import io
import os
import random
import tarfile
from typing import Optional

import numpy as np
from PIL import Image

from marigold_tpu_torch.data.base_depth import (
    DatasetMode,
    bilinear_resize,
)


def _gaussian_blur(img: np.ndarray, sigma: float, kernel_size: int = 33) -> np.ndarray:
    if sigma <= 0:
        return img
    try:  # cv2's SIMD separable filter is ~10x scipy's per-channel loop
        import cv2

        k = kernel_size | 1
        return cv2.GaussianBlur(
            img.astype(np.float32), (k, k), sigmaX=sigma, sigmaY=sigma,
            borderType=cv2.BORDER_REPLICATE,
        )
    except ImportError:
        from scipy.ndimage import gaussian_filter

        trunc = ((kernel_size - 1) / 2) / max(sigma, 1e-6)
        # mode='nearest' = cv2 BORDER_REPLICATE: both code paths share the
        # same boundary behavior
        return gaussian_filter(
            img.astype(np.float32), (sigma, sigma, 0), truncate=trunc,
            mode="nearest",
        )


def _motion_blur_kernel(kernel_size: int, angle_deg: float) -> np.ndarray:
    from scipy.ndimage import rotate

    kernel = np.zeros((kernel_size, kernel_size), np.float32)
    kernel[kernel_size // 2, :] = 1.0
    kernel = rotate(kernel, angle_deg, reshape=False, order=1)
    kernel = np.clip(kernel, 0, None)
    kernel /= max(kernel.sum(), 1e-8)
    return kernel


def _motion_blur(img: np.ndarray, kernel_size: int, angle_deg: float) -> np.ndarray:
    """Line kernel rotated by angle, depthwise conv (reference
    base_normals_dataset.py:205-246)."""
    kernel = _motion_blur_kernel(kernel_size, angle_deg)
    try:
        import cv2

        return cv2.filter2D(
            img.astype(np.float32), -1, kernel,
            borderType=cv2.BORDER_REPLICATE,
        )
    except ImportError:
        from scipy.ndimage import convolve

        return convolve(
            img.astype(np.float32), kernel[..., None], mode="nearest"
        )


def _color_jitter(rgb01: np.ndarray, brightness, contrast, saturation, hue,
                  rng: random.Random) -> np.ndarray:
    """torchvision-ColorJitter-style random jitter on [H,W,3] in [0,1]."""
    out = rgb01.astype(np.float32)

    def u(f):
        return rng.uniform(max(0, 1 - f), 1 + f)

    # random order like torchvision
    ops = ["b", "c", "s", "h"]
    rng.shuffle(ops)
    for op in ops:
        if op == "b" and brightness:
            out = out * u(brightness)
        elif op == "c" and contrast:
            mean = out.mean(axis=(0, 1), keepdims=True).mean()
            out = (out - mean) * u(contrast) + mean
        elif op == "s" and saturation:
            gray = out @ np.asarray([0.299, 0.587, 0.114], np.float32)
            f = u(saturation)
            out = out * f + gray[..., None] * (1 - f)
        elif op == "h" and hue:
            shift = rng.uniform(-hue, hue)
            u8 = (np.clip(out, 0, 1) * 255).astype(np.uint8)
            try:  # cv2's SIMD HSV roundtrip is ~10x PIL's
                import cv2

                hsv = cv2.cvtColor(u8, cv2.COLOR_RGB2HSV_FULL)
                h = hsv[..., 0].astype(np.int32)
                hsv[..., 0] = ((h + int(round(shift * 255.0))) % 256).astype(
                    np.uint8
                )
                out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB_FULL).astype(
                    np.float32
                ) / 255.0
            except ImportError:
                hsv = np.asarray(Image.fromarray(u8).convert("HSV"), np.float32)
                # mod 256: same hue circle as the cv2 HSV_FULL path
                hsv[..., 0] = (hsv[..., 0] + round(shift * 255.0)) % 256.0
                out = (
                    np.asarray(
                        Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB"),
                        np.float32,
                    )
                    / 255.0
                )
        out = np.clip(out, 0.0, 1.0)
    return out


class BaseNormalsDataset:
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
        rgb_rel_path, normals_rel_path = self._get_data_path(index)
        rasters = {}
        rasters.update(self._load_rgb_data(rgb_rel_path))
        if DatasetMode.RGB_ONLY != self.mode:
            rasters.update(self._load_normals_data(normals_rel_path))
        other = {"index": index, "rgb_relative_path": rgb_rel_path}
        return rasters, other

    def _get_data_path(self, index):
        line = self.filenames[index]
        return line[0], line[1]

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
        return np.asarray(Image.open(io.BytesIO(self._read_bytes(rel_path))))

    def _read_rgb_file(self, rel_path) -> np.ndarray:
        rgb = self._read_image(rel_path)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        return rgb.astype(np.int32)  # [H,W,3]

    def _read_normals_file(self, rel_path) -> np.ndarray:
        normals = np.load(io.BytesIO(self._read_bytes(rel_path)))  # [H,W,3]
        return normals.astype(np.float32)

    def _load_rgb_data(self, rgb_rel_path):
        rgb = self._read_rgb_file(rgb_rel_path)
        rgb_norm = rgb.astype(np.float32) / 255.0 * 2.0 - 1.0
        return {"rgb_int": rgb, "rgb_norm": rgb_norm}

    def _load_normals_data(self, normals_rel_path):
        return {"normals": self._read_normals_file(normals_rel_path)}

    # ---------------- train preprocessing ---------------- #

    def _training_preprocess(self, rasters):
        if self.augm_args is not None:
            rasters = self._augment_data(rasters)
        if self.resize_to_hw is not None:
            out = {}
            for k, v in rasters.items():
                r = bilinear_resize(v.astype(np.float32), self.resize_to_hw)
                out[k] = r.astype(v.dtype) if k == "rgb_int" else r
            rasters = out
        return rasters

    def _augment_data(self, rasters):
        """One float32 working buffer for the whole augmentation chain
        (each stage still rounds to integer levels like the reference's
        torchvision-on-int-tensor chain, but in place — on a slow host
        core every avoided 9 MB astype copy is ~0.1 s/sample)."""
        from . import rng as data_rng

        a = self.augm_args
        if data_rng.random() < a.get("lr_flip_p", 0):
            rasters = {k: v[:, ::-1] for k, v in rasters.items()}  # views
            n = np.ascontiguousarray(rasters.get("normals")) if "normals" in rasters else None
            if n is not None:
                n[..., 0] *= -1
                rasters["normals"] = n

        rgb_f = rasters["rgb_int"].astype(np.float32)  # one copy; handles views
        is_hypersim_res = rgb_f.shape[0] == 768
        if data_rng.random() < a.get("gaussian_blur_p", 0) and is_hypersim_res:
            sigma = data_rng.uniform(0.0, a.get("gaussian_blur_sigma", 2.0))
            rgb_f = _gaussian_blur(rgb_f, sigma)
            np.rint(rgb_f, out=rgb_f)  # reference quantizes between stages

        if data_rng.random() < a.get("motion_blur_p", 0) and is_hypersim_res:
            max_k = a.get("motion_blur_kernel_size", 9)
            ks = data_rng.choice([x for x in range(3, max_k + 1) if x % 2 == 1])
            angle = data_rng.uniform(0.0, a.get("motion_blur_angle_range", 180.0))
            rgb_f = _motion_blur(rgb_f, ks, angle)
            np.rint(rgb_f, out=rgb_f)

        if data_rng.random() < a.get("color_jitter_p", 0):
            rng = random.Random(data_rng.random())
            rgb_f *= 1.0 / 255.0
            rgb_f = _color_jitter(
                rgb_f,
                a.get("jitter_brightness_factor", 0),
                a.get("jitter_contrast_factor", 0),
                a.get("jitter_saturation_factor", 0),
                a.get("jitter_hue_factor", 0),
                rng,
            )
            rgb_f *= 255.0
            np.rint(rgb_f, out=rgb_f)

        np.clip(rgb_f, 0.0, 255.0, out=rgb_f)
        rasters["rgb_int"] = rgb_f.astype(np.int32)
        rasters["rgb_norm"] = rgb_f * np.float32(2.0 / 255.0) - np.float32(1.0)
        return rasters

    def __del__(self):
        if getattr(self, "tar_obj", None) is not None:
            self.tar_obj.close()
            self.tar_obj = None
