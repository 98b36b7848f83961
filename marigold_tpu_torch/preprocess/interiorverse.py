"""InteriorVerse preprocessing.

A copy of `marigold_tpu/preprocess/interiorverse.py` (numpy, tarfile and
PIL, no framework), held to it file for file by
tests/test_torch_preprocess.py.

Two entry points:
  * IID appearance (pack_scenes): pack per-scene EXR files into a tar
    archive readable by the tar-transparent data layer. Behavioral
    reference: script/iid/dataset_preprocess/interiorverse_appearance/
    preprocess_interiorverse_iid.py — tars scene directories
    (im/albedo/material/mask EXRs) and emits filename lists of the form
    <scene>/<id>_im.exr ... <scene>/<id>_mask.exr
  * Normals (preprocess_normals): scenes_85 EXRs -> LDR rgb PNG
    (clip + gamma 1/2.2) and unit-normalized normals .npy, skipping
    NaN frames and normal maps with invalid (near-zero) pixels.
    Behavioral reference: script/normals/dataset_preprocess/interiorverse/
    preprocess_interiorverse_normals.py:46-113.
"""

from __future__ import annotations

import argparse
import os
import re
import tarfile

import numpy as np


def pack_scenes(dataset_dir: str, output_tar: str, scenes=None) -> list[str]:
    """Tar scene dirs; returns filename-list lines for frames having all of
    im/albedo/material/mask."""
    scenes = scenes or sorted(
        d for d in os.listdir(dataset_dir)
        if os.path.isdir(os.path.join(dataset_dir, d))
    )
    lines = []
    with tarfile.open(output_tar, "w") as tar:
        for scene in scenes:
            sdir = os.path.join(dataset_dir, scene)
            ids = sorted(
                {
                    m.group(1)
                    for f in os.listdir(sdir)
                    if (m := re.match(r"(\d+)_im\.exr$", f))
                }
            )
            for fid in ids:
                frame_files = [
                    f"{fid}_im.exr", f"{fid}_albedo.exr",
                    f"{fid}_material.exr", f"{fid}_mask.exr",
                ]
                if not all(
                    os.path.exists(os.path.join(sdir, f)) for f in frame_files
                ):
                    continue
                for f in frame_files:
                    tar.add(
                        os.path.join(sdir, f), arcname=f"./{scene}/{f}"
                    )
                lines.append(" ".join(f"{scene}/{f}" for f in frame_files))
    return lines


def preprocess_normals(dataset_dir: str, output_dir: str) -> list[str]:
    """scenes_85 EXRs -> rgb PNGs + unit normals .npy under
    <output_dir>/scenes_85/<scene>/; returns filename-list lines
    "<scene>/<id>_img.png <scene>/<id>_normal.npy". One line per VALID
    normal map: NaN frames and normal maps with near-zero (|n| < 0.1,
    sky/invalid) pixels are skipped (reference
    preprocess_interiorverse_normals.py:69-94)."""
    from PIL import Image

    from marigold_tpu_torch.data.image_io import read_exr_raw

    in_dir = os.path.join(dataset_dir, "scenes_85")
    out_dir = os.path.join(output_dir, "scenes_85")
    lines = []
    for scene in sorted(os.listdir(in_dir)):
        sdir = os.path.join(in_dir, scene)
        if not os.path.isdir(sdir):
            continue
        for fname in sorted(os.listdir(sdir)):
            is_rgb = fname.endswith("im.exr")
            is_normal = fname.endswith("normal.exr")
            if not (is_rgb or is_normal):
                continue
            im = read_exr_raw(os.path.join(sdir, fname))
            im = np.asarray(im, dtype=np.float32)
            if np.any(np.isnan(im)):
                continue
            os.makedirs(os.path.join(out_dir, scene), exist_ok=True)
            if is_rgb:
                ldr = np.clip(im, 0, 1) ** (1 / 2.2)
                rgb_name = fname.replace("im.exr", "img.png")
                Image.fromarray((ldr * 255).astype(np.uint8)).save(
                    os.path.join(out_dir, scene, rgb_name)
                )
            else:
                if (np.linalg.norm(im, axis=2) < 0.1).sum() > 0:
                    continue
                im = im / np.linalg.norm(im, axis=2, keepdims=True)
                normal_name = fname.replace("normal.exr", "normal.npy")
                np.save(os.path.join(out_dir, scene, normal_name), im)
                rgb_name = fname.replace("normal.exr", "img.png")
                lines.append(
                    f"{os.path.join(scene, rgb_name)} "
                    f"{os.path.join(scene, normal_name)}"
                )
    with open(
        os.path.join(output_dir, "interiorverse_filtered_all.txt"), "w"
    ) as f:
        f.write("\n".join(lines))
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess InteriorVerse")
    parser.add_argument("--task", choices=["iid", "normals"], default="iid")
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--output_tar", type=str,
                        help="(iid) output tar archive path")
    parser.add_argument("--filename_list", type=str,
                        help="(iid) output filename-list path")
    parser.add_argument("--output_dir", type=str,
                        help="(normals) output directory")
    args = parser.parse_args(argv)
    if args.task == "normals":
        if not args.output_dir:
            parser.error("--task normals requires --output_dir")
        lines = preprocess_normals(args.dataset_dir, args.output_dir)
        print(f"processed {len(lines)} frames -> {args.output_dir}")
        return 0
    if not (args.output_tar and args.filename_list):
        parser.error("--task iid requires --output_tar and --filename_list")
    lines = pack_scenes(args.dataset_dir, args.output_tar)
    os.makedirs(os.path.dirname(args.filename_list) or ".", exist_ok=True)
    with open(args.filename_list, "w") as f:
        f.write("\n".join(lines))
    print(f"packed {len(lines)} frames -> {args.output_tar}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
