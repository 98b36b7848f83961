"""Dataset registry.

Copy of `marigold_tpu/data/__init__.py` for the PyTorch port, with the
dataset modules, the loader and the mixed sampler copied beside it (all
framework free).

Behavioral reference: src/dataset/__init__.py:57-107 — 17 named datasets;
`mixed` spec (train only) returns a list of datasets for the
MixedBatchSampler.
"""

from __future__ import annotations

import os

from marigold_tpu_torch.data.base_depth import (  # noqa: F401
    BaseDepthDataset,
    DatasetMode,
    DepthFileNameMode,
    get_pred_name,
)
from marigold_tpu_torch.data.base_iid import BaseIIDDataset  # noqa: F401
from marigold_tpu_torch.data.base_normals import BaseNormalsDataset  # noqa: F401
from marigold_tpu_torch.data.depth_datasets import (
    DIODEDepthDataset,
    ETH3DDepthDataset,
    HypersimDepthDataset,
    KITTIDepthDataset,
    NYUDepthDataset,
    ScanNetDepthDataset,
    VirtualKITTIDepthDataset,
)
from marigold_tpu_torch.data.loader import DataLoader, default_collate  # noqa: F401
from marigold_tpu_torch.data.mixed_sampler import (  # noqa: F401
    ConcatDataset,
    MixedBatchSampler,
)
from marigold_tpu_torch.data.other_datasets import (
    DIODENormalsDataset,
    HypersimIIDDataset,
    HypersimNormalsDataset,
    IBimsNormalsDataset,
    InteriorVerseIIDDataset,
    InteriorVerseNormalsDataset,
    NYUNormalsDataset,
    OasisNormalsDataset,
    ScanNetNormalsDataset,
    SintelNormalsDataset,
)

dataset_name_class_dict = {
    "hypersim_depth": HypersimDepthDataset,
    "vkitti_depth": VirtualKITTIDepthDataset,
    "nyu_depth": NYUDepthDataset,
    "kitti_depth": KITTIDepthDataset,
    "eth3d_depth": ETH3DDepthDataset,
    "diode_depth": DIODEDepthDataset,
    "scannet_depth": ScanNetDepthDataset,
    "hypersim_normals": HypersimNormalsDataset,
    "interiorverse_normals": InteriorVerseNormalsDataset,
    "sintel_normals": SintelNormalsDataset,
    "ibims_normals": IBimsNormalsDataset,
    "nyu_normals": NYUNormalsDataset,
    "scannet_normals": ScanNetNormalsDataset,
    "diode_normals": DIODENormalsDataset,
    "oasis_normals": OasisNormalsDataset,
    "interiorverse_iid": InteriorVerseIIDDataset,
    "hypersim_iid": HypersimIIDDataset,
}


def get_dataset(cfg_data_split, base_data_dir: str, mode: DatasetMode, **kwargs):
    """Registry dispatch (reference src/dataset/__init__.py:78-107).
    `cfg_data_split` is a mapping with `name`, `dir`, `filenames` (+
    per-dataset extras); `mixed` returns a list of datasets."""
    name = cfg_data_split["name"]
    if name == "mixed":
        assert DatasetMode.TRAIN == mode, "Only training mode supports mixed datasets."
        return [
            get_dataset(c, base_data_dir, mode, **kwargs)
            for c in cfg_data_split["dataset_list"]
        ]
    if name in dataset_name_class_dict:
        cls = dataset_name_class_dict[name]
        extras = {
            k: v
            for k, v in cfg_data_split.items()
            if k not in ("name", "dir", "filenames")
        }
        extras.update(kwargs)
        return cls(
            mode=mode,
            filename_ls_path=cfg_data_split["filenames"],
            dataset_dir=os.path.join(base_data_dir, cfg_data_split["dir"]),
            **extras,
        )
    raise NotImplementedError(f"unknown dataset: {name}")
