"""Normals + IID concrete datasets.

Behavioral reference: hypersim_dataset.py (normals subclass; IID loads
albedo/shading/residual .npy, clips shading+residual by a shared
98th-quantile cutoff and normalizes, NaN/inf/zero-albedo validity masks),
sintel_dataset.py (center-crop width 1024->582, invalid sky normals ->
camera-facing [0,0,1]), interiorverse_dataset.py (normals + IID appearance:
albedo + material EXRs with R=roughness G=metallicity B zeroed, 3ch mask,
HDR->sRGB), ibims_dataset.py / oasis_dataset.py / nyu / scannet / diode
(trivial normals subclasses).
"""

from __future__ import annotations

import numpy as np

from marigold_tpu_torch.data.base_iid import BaseIIDDataset, DatasetMode
from marigold_tpu_torch.data.base_normals import BaseNormalsDataset
from marigold_tpu_torch.data.image_io import img_linear2srgb, is_hdr


class HypersimNormalsDataset(BaseNormalsDataset):
    pass


class NYUNormalsDataset(BaseNormalsDataset):
    pass


class ScanNetNormalsDataset(BaseNormalsDataset):
    pass


class IBimsNormalsDataset(BaseNormalsDataset):
    pass


class OasisNormalsDataset(BaseNormalsDataset):
    pass


class DIODENormalsDataset(BaseNormalsDataset):
    pass


class InteriorVerseNormalsDataset(BaseNormalsDataset):
    pass


# Sintel original resolution (reference sintel_dataset.py:36-47)
_SINTEL_H, _SINTEL_W = 436, 1024
_SINTEL_CROP = 221  # crop both sides: 1024 - 2*221 = 582


def _sintel_center_crop(img: np.ndarray) -> np.ndarray:
    return img[:, _SINTEL_CROP : _SINTEL_W - _SINTEL_CROP]


class SintelNormalsDataset(BaseNormalsDataset):
    def _load_rgb_data(self, rgb_rel_path):
        rgb = _sintel_center_crop(self._read_rgb_file(rgb_rel_path))
        rgb_norm = rgb.astype(np.float32) / 255.0 * 2.0 - 1.0
        return {"rgb_int": rgb, "rgb_norm": rgb_norm}

    def _load_normals_data(self, normals_rel_path):
        normals = self._read_normals_file(normals_rel_path)  # [H,W,3]
        # invalid (sky) normals -> camera-facing (reference :69-73)
        invalid = np.linalg.norm(normals, axis=-1) <= 0.1
        normals[invalid] = np.asarray([0.0, 0.0, 1.0], normals.dtype)
        return {"normals": _sintel_center_crop(normals)}


class HypersimIIDDataset(BaseIIDDataset):
    """Lighting decomposition: albedo / shading / residual
    (reference hypersim_dataset.py:62-143)."""

    def _load_targets_data(self, rel_paths):
        albedo = self._read_numpy(rel_paths[0])  # [H,W,3] linear
        shading_raw = self._read_numpy(rel_paths[1])
        residual_raw = self._read_numpy(rel_paths[2])

        # shared 98th-quantile cutoff, clip + normalize to [0,1]
        cut_off = max(
            float(np.quantile(residual_raw, 0.98)),
            float(np.quantile(shading_raw, 0.98)),
        )
        cut_off = max(cut_off, 1e-8)
        shading = np.clip(shading_raw, 0, cut_off) / cut_off
        residual = np.clip(residual_raw, 0, cut_off) / cut_off

        invalid_albedo = np.isnan(albedo) | np.isinf(albedo)
        zero_mask = np.all(albedo == 0, axis=-1, keepdims=True)
        invalid_albedo |= np.broadcast_to(zero_mask, albedo.shape)

        return {
            "albedo": albedo.astype(np.float32),
            "shading": shading.astype(np.float32),
            "residual": residual.astype(np.float32),
            "mask_albedo": ~invalid_albedo,
            "mask_shading": ~(np.isnan(shading) | np.isinf(shading)),
            "mask_residual": ~(np.isnan(residual) | np.isinf(residual)),
        }


class InteriorVerseIIDDataset(BaseIIDDataset):
    """Appearance decomposition: albedo + material (R=roughness,
    G=metallicity, B zeroed) (reference interiorverse_dataset.py:44-85)."""

    def _load_targets_data(self, rel_paths):
        albedo_path, material_path, mask_path = rel_paths[0], rel_paths[1], rel_paths[2]

        albedo = self._read_image(albedo_path)
        material = self._read_image(material_path)
        material = material.copy()
        material[..., 2] = 0

        mask = self._read_image(mask_path) != 0  # [H,W,3] bool
        mask_1ch = np.all(mask, axis=-1, keepdims=True)

        if is_hdr(albedo_path):
            albedo = img_linear2srgb(albedo)
        if is_hdr(material_path):
            material = img_linear2srgb(material)

        outputs = {
            "albedo": albedo.astype(np.float32),
            "material": material.astype(np.float32),
            "mask": mask_1ch,
        }
        if self.mode == DatasetMode.EVAL:
            outputs["mask_albedo"] = mask
            outputs["mask_material"] = mask
        return outputs
