"""Concrete depth datasets.

Behavioral reference (src/dataset/): kitti_dataset.py (PNG/256 decode,
352x1216 benchmark crop, garg/eigen fractional eval masks),
vkitti_dataset.py (cm->m /100, max 80m, reuses KITTI crop/masks),
nyu_dataset.py (/1000, filled depth, eigen crop [45:471, 41:601]),
hypersim_dataset.py (/1000, max 65m), eth3d_dataset.py (raw float32 binary
4032x6048, inf->0), diode_dataset.py (.npy depth + explicit mask files,
0.6..350m), scannet_dataset.py (/1000).
"""

from __future__ import annotations

import io

import numpy as np

from marigold_tpu_torch.data.base_depth import (
    BaseDepthDataset,
    DatasetMode,
    DepthFileNameMode,
)


def _kitti_benchmark_crop(img: np.ndarray) -> np.ndarray:
    """Crop [H,W,C] to the 352x1216 KITTI benchmark window (bottom-center,
    reference kitti_dataset.py:82-109)."""
    KB_H, KB_W = 352, 1216
    h, w = img.shape[0], img.shape[1]
    top = int(h - KB_H)
    left = int((w - KB_W) / 2)
    return img[top : top + KB_H, left : left + KB_W]


def _fractional_eval_mask(shape_hw, crop_type: str) -> np.ndarray:
    h, w = shape_hw
    m = np.zeros((h, w, 1), bool)
    if crop_type == "garg":
        m[int(0.40810811 * h) : int(0.99189189 * h),
          int(0.03594771 * w) : int(0.96405229 * w)] = True
    elif crop_type == "eigen":
        m[int(0.3324324 * h) : int(0.91351351 * h),
          int(0.0359477 * w) : int(0.96405229 * w)] = True
    else:
        raise ValueError(crop_type)
    return m


class KITTIDepthDataset(BaseDepthDataset):
    def __init__(self, kitti_bm_crop, valid_mask_crop, **kwargs) -> None:
        super().__init__(
            min_depth=1e-5,
            max_depth=80,
            has_filled_depth=False,
            name_mode=DepthFileNameMode.id,
            **kwargs,
        )
        self.kitti_bm_crop = kitti_bm_crop
        self.valid_mask_crop = valid_mask_crop
        assert self.valid_mask_crop in [None, "garg", "eigen"], (
            f"Unknown crop type: {self.valid_mask_crop}"
        )
        self.filenames = [f for f in self.filenames if "None" != f[1]]

    def _read_depth_file(self, rel_path):
        return self._read_image(rel_path) / 256.0

    def _load_rgb_data(self, rgb_rel_path):
        data = super()._load_rgb_data(rgb_rel_path)
        if self.kitti_bm_crop:
            data = {k: _kitti_benchmark_crop(v) for k, v in data.items()}
        return data

    def _load_depth_data(self, depth_rel_path, filled_rel_path):
        data = super()._load_depth_data(depth_rel_path, filled_rel_path)
        if self.kitti_bm_crop:
            data = {k: _kitti_benchmark_crop(v) for k, v in data.items()}
        return data

    def _get_valid_mask(self, depth):
        valid_mask = super()._get_valid_mask(depth)
        if self.valid_mask_crop is not None:
            valid_mask &= _fractional_eval_mask(
                depth.shape[:2], self.valid_mask_crop
            )
        return valid_mask


class VirtualKITTIDepthDataset(KITTIDepthDataset):
    """vKITTI2: depth PNG in cm (reference vkitti_dataset.py:63-66);
    shares KITTI's crop & masks (vkitti subclasses BaseDepthDataset but
    duplicates KITTI's logic — we inherit instead)."""

    def _read_depth_file(self, rel_path):
        return self._read_image(rel_path) / 100.0


class NYUDepthDataset(BaseDepthDataset):
    def __init__(self, eigen_valid_mask: bool, **kwargs) -> None:
        super().__init__(
            min_depth=1e-3,
            max_depth=10.0,
            has_filled_depth=True,
            name_mode=DepthFileNameMode.rgb_id,
            **kwargs,
        )
        self.eigen_valid_mask = eigen_valid_mask

    def _read_depth_file(self, rel_path):
        return self._read_image(rel_path) / 1000.0

    def _get_valid_mask(self, depth):
        valid_mask = super()._get_valid_mask(depth)
        if self.eigen_valid_mask:
            eval_mask = np.zeros_like(valid_mask)
            eval_mask[45:471, 41:601] = True
            valid_mask &= eval_mask
        return valid_mask


class HypersimDepthDataset(BaseDepthDataset):
    def __init__(self, **kwargs) -> None:
        super().__init__(
            min_depth=1e-5,
            max_depth=65.0,
            has_filled_depth=False,
            name_mode=DepthFileNameMode.rgb_i_d,
            **kwargs,
        )

    def _read_depth_file(self, rel_path):
        return self._read_image(rel_path) / 1000.0


class ETH3DDepthDataset(BaseDepthDataset):
    HEIGHT, WIDTH = 4032, 6048

    def __init__(self, **kwargs) -> None:
        super().__init__(
            min_depth=1e-5,
            max_depth=np.inf,
            has_filled_depth=False,
            name_mode=DepthFileNameMode.id,
            **kwargs,
        )

    def _read_depth_file(self, rel_path):
        binary_data = self._read_bytes(rel_path)
        depth = np.frombuffer(binary_data, dtype=np.float32).copy()
        depth[depth == np.inf] = 0.0
        return depth.reshape((self.HEIGHT, self.WIDTH))


class DIODEDepthDataset(BaseDepthDataset):
    def __init__(self, **kwargs) -> None:
        super().__init__(
            min_depth=0.6,
            max_depth=350,
            has_filled_depth=False,
            name_mode=DepthFileNameMode.id,
            **kwargs,
        )

    def _read_npy_file(self, rel_path) -> np.ndarray:
        data = np.load(io.BytesIO(self._read_bytes(rel_path)))
        return data.squeeze()

    def _read_depth_file(self, rel_path):
        return self._read_npy_file(rel_path)

    def _get_data_path(self, index):
        return self.filenames[index]

    def _get_data_item(self, index):
        # DIODE ships explicit mask files (reference diode_dataset.py:73-99)
        rgb_rel_path, depth_rel_path, mask_rel_path = self._get_data_path(index)
        rasters = {}
        rasters.update(self._load_rgb_data(rgb_rel_path))
        if DatasetMode.RGB_ONLY != self.mode:
            rasters.update(self._load_depth_data(depth_rel_path, None))
            mask = self._read_npy_file(mask_rel_path).astype(bool)[..., None]
            rasters["valid_mask_raw"] = mask.copy()
            rasters["valid_mask_filled"] = mask.copy()
        other = {"index": index, "rgb_relative_path": rgb_rel_path}
        return rasters, other


class ScanNetDepthDataset(BaseDepthDataset):
    def __init__(self, **kwargs) -> None:
        super().__init__(
            min_depth=1e-3,
            max_depth=10,
            has_filled_depth=False,
            name_mode=DepthFileNameMode.id,
            **kwargs,
        )

    def _read_depth_file(self, rel_path):
        return self._read_image(rel_path) / 1000.0
