"""Hypersim raw-data preprocessing (HDF5 -> training-ready files).

A copy of `marigold_tpu/preprocess/hypersim.py` (numpy, h5py and PIL, no
framework), held to it file for file by tests/test_torch_preprocess.py.

Behavioral reference: script/{depth,normals,iid}/dataset_preprocess/hypersim/
— the published Marigold training data recipe:
  * tone_map: scale the HDR render so the 90th-percentile CCIR601 luma maps
    to 0.8 after gamma 1/2.2, clip to [0,1] (hypersim_util.py:35-74).
  * dist_2_depth: Hypersim "depth" HDF5 stores ray distance; convert to
    planar depth with focal 886.81 at 1024x768 (hypersim_util.py:78-95;
    apple/ml-hypersim#9). Saved as uint16 PNG in millimeters.
  * normals (--task normals): tone-mapped rgb PNG + camera-space normals
    .npy; unit-normalize, patch -inf camera positions, flip normals whose
    world-space n.v is < -1e-3 (back-facing renderer artifacts); frames
    with NaN normals are skipped entirely
    (preprocess_hypersim_normals.py:144-183, 196-215).
  * IID lighting (--task iid): extract diffuse_reflectance /
    diffuse_illumination / residual HDF5 planes to .npy + per-sample
    stats JSON (min/max/mean/std/percentiles) + tone-mapped rgb PNG.
    Train/val frames are validated (finite reconstruction, NaN-free
    planes, albedo in [0,1], non-negative shading/residual, finite
    tone-map scale, clipped-reconstruction PSNR >= 40) and rejects leave
    a marker file under <scene>_invalid/ so re-runs resume past them
    (preprocess_hypersim_iid.py:123-299).

Output naming matches the shipped split lists in data_split/hypersim_*
(depth list lines are relative to the split dir; normals/iid lines carry
the <split>/ prefix):
  depth:   <split>/<scene>/{rgb,depth_plane}_<cam>_fr<NNNN>.png
  normals: <split>/<scene>/rgb_<cam>_fr<NNNN>.png + normal_cam_<cam>_fr<NNNN>.npy
  iid:     <split>/<scene>/rgb_<cam>_fr<NNNN>.png +
           {albedo,shading,residual}_<cam>_fr<NNNN>.npy +
           shading_stats_<cam>_fr<NNNN>.json

Entry point: python -m marigold_tpu_torch.preprocess.hypersim --task depth ...
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

IMG_WIDTH = 1024
IMG_HEIGHT = 768
FOCAL_LENGTH = 886.81


def compute_tone_map_scale(
    rgb: np.ndarray, valid_mask: Optional[np.ndarray] = None
) -> float:
    """Linear scale mapping the 90th-percentile CCIR601 luma to 0.8 after
    gamma 1/2.2 (reference hypersim_util.py:35-62 /
    preprocess_hypersim_iid.py:70-97)."""
    inv_gamma = 2.2
    percentile = 90
    brightness_nth_percentile_desired = 0.8

    brightness = 0.3 * rgb[..., 0] + 0.59 * rgb[..., 1] + 0.11 * rgb[..., 2]
    if valid_mask is not None:
        if np.count_nonzero(valid_mask) == 0:
            return 1.0
        brightness = brightness[valid_mask]
    eps = 1e-4
    current = np.percentile(brightness, percentile)
    if current < eps:
        return 0.0
    return float(
        np.power(brightness_nth_percentile_desired, inv_gamma) / current
    )


def apply_tone_map(rgb: np.ndarray, scale: float) -> np.ndarray:
    """scale * rgb, clip negatives, gamma 1/2.2, clip to [0,1]."""
    gamma = 1.0 / 2.2
    out = np.power(np.maximum(scale * rgb, 0), gamma)
    return np.clip(out, 0, 1)


def tone_map(rgb: np.ndarray, entity_id_map: np.ndarray) -> np.ndarray:
    """HDR [H,W,3] -> tone-mapped sRGB [0,1]."""
    scale = compute_tone_map_scale(rgb, valid_mask=entity_id_map != -1)
    return apply_tone_map(rgb, scale)


def psnr_uint8(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR between two uint8 images (reference preprocess_hypersim_iid.py:46-54)."""
    mse = np.mean((a.astype(np.float32) - b.astype(np.float32)) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(255.0 / np.sqrt(mse)))


def dist_2_depth(distance: np.ndarray, width: int = IMG_WIDTH,
                 height: int = IMG_HEIGHT,
                 focal: float = FOCAL_LENGTH) -> np.ndarray:
    """Ray distance [H,W] -> planar depth [H,W]."""
    px = np.linspace(-0.5 * width + 0.5, 0.5 * width - 0.5, width,
                     dtype=np.float32)[None, :]
    py = np.linspace(-0.5 * height + 0.5, 0.5 * height - 0.5, height,
                     dtype=np.float32)[:, None]
    norm = np.sqrt(px**2 + py**2 + focal**2)
    return distance / norm * focal


def fix_normals(
    normal_cam: np.ndarray,
    normal_world: np.ndarray,
    position_world: np.ndarray,
    camera_position: np.ndarray,
) -> Optional[np.ndarray]:
    """Unit-normalize camera-space normals and flip back-facing ones (world
    n.v < -1e-3). Returns None if the map contains NaNs (sample skipped,
    reference behavior)."""
    if np.any(np.isnan(normal_cam)):
        return None
    h, w, _ = normal_cam.shape

    def normalize(a):
        n = np.linalg.norm(a, axis=-1, keepdims=True)
        return a / np.clip(n, 1e-12, None)

    normal_cam = normalize(normal_cam.reshape(-1, 3)).reshape(h, w, 3)

    position = position_world.copy()
    if np.any(np.isinf(position)):  # ai_051_004-style -inf artifacts
        inf_idx = np.where(np.isinf(position))
        for hh, ww, ch in zip(*inf_idx):
            src = hh + 1 if hh == 0 else hh - 1
            position[hh, ww, ch] = position[src, ww, ch]

    to_cam = normalize(
        (camera_position[None, :] - position.reshape(-1, 3))
    )
    n_dot_v = np.sum(normal_world.reshape(-1, 3) * to_cam, axis=1)
    back_facing = (n_dot_v < -1e-3).reshape(h, w)
    normal_cam[back_facing] *= -1
    return normal_cam


def _read_h5(path: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f["dataset"])


def process_depth_frame(scene_dir: str, cam: str, frame: int, out_dir: str):
    """One frame: final color HDF5 + geometry distance HDF5 -> rgb PNG +
    mm-uint16 depth PNG. Returns (rgb_rel, depth_rel, invalid_ratio)."""
    from PIL import Image

    stem_final = os.path.join(
        scene_dir, "images", f"scene_{cam}_final_hdf5", f"frame.{frame:04d}"
    )
    stem_geom = os.path.join(
        scene_dir, "images", f"scene_{cam}_geometry_hdf5", f"frame.{frame:04d}"
    )
    rgb_hdr = _read_h5(stem_final + ".color.hdf5").astype(np.float64)
    dist = _read_h5(stem_geom + ".depth_meters.hdf5").astype(np.float64)
    entity = _read_h5(stem_geom + ".render_entity_id.hdf5").astype(int)

    rgb_tm = tone_map(rgb_hdr, entity)
    rgb_int = (rgb_tm * 255).astype(np.uint8)

    depth = dist_2_depth(dist)
    valid = entity != -1
    invalid_ratio = 1.0 - valid.mean()
    depth = np.where(valid, depth, 0.0)
    depth_mm = (depth * 1000.0).astype(np.uint16)

    scene_name = os.path.basename(scene_dir.rstrip("/"))
    os.makedirs(os.path.join(out_dir, scene_name), exist_ok=True)
    rgb_rel = os.path.join(scene_name, f"rgb_{cam}_fr{frame:04d}.png")
    depth_rel = os.path.join(scene_name, f"depth_plane_{cam}_fr{frame:04d}.png")
    Image.fromarray(rgb_int).save(os.path.join(out_dir, rgb_rel))
    Image.fromarray(depth_mm).save(os.path.join(out_dir, depth_rel))
    return rgb_rel, depth_rel, invalid_ratio


def process_normals_frame(
    scene_dir: str, cam: str, frame: int, out_dir: str
) -> Optional[tuple]:
    """One frame: color + normal_cam/normal_world/position geometry HDF5 ->
    rgb PNG + camera-space normals .npy. Returns (rgb_rel, normal_rel) or
    None when the normal map contains NaNs (skipped, reference
    preprocess_hypersim_normals.py:144-147)."""
    from PIL import Image

    stem_final = os.path.join(
        scene_dir, "images", f"scene_{cam}_final_hdf5", f"frame.{frame:04d}"
    )
    stem_geom = os.path.join(
        scene_dir, "images", f"scene_{cam}_geometry_hdf5", f"frame.{frame:04d}"
    )
    scene_name = os.path.basename(scene_dir.rstrip("/"))
    rgb_rel = os.path.join(scene_name, f"rgb_{cam}_fr{frame:04d}.png")
    normal_rel = os.path.join(scene_name, f"normal_cam_{cam}_fr{frame:04d}.npy")
    if os.path.exists(os.path.join(out_dir, rgb_rel)) and os.path.exists(
        os.path.join(out_dir, normal_rel)
    ):  # resume: already processed
        return rgb_rel, normal_rel

    normal_cam = _read_h5(stem_geom + ".normal_cam.hdf5").astype(np.float64)
    if np.any(np.isnan(normal_cam)):
        return None
    rgb_hdr = _read_h5(stem_final + ".color.hdf5").astype(np.float64)
    entity = _read_h5(stem_geom + ".render_entity_id.hdf5").astype(int)
    normal_world = _read_h5(stem_geom + ".normal_world.hdf5").astype(np.float64)
    position = _read_h5(stem_geom + ".position.hdf5").astype(np.float64)
    cam_positions = _read_h5(
        os.path.join(scene_dir, "_detail", cam, "camera_keyframe_positions.hdf5")
    ).astype(np.float64)
    camera_position = cam_positions[frame]

    fixed = fix_normals(normal_cam, normal_world, position, camera_position)
    if fixed is None:
        return None
    rgb_int = (tone_map(rgb_hdr, entity) * 255).astype(np.uint8)

    os.makedirs(os.path.join(out_dir, scene_name), exist_ok=True)
    Image.fromarray(rgb_int).save(os.path.join(out_dir, rgb_rel))
    np.save(os.path.join(out_dir, normal_rel), fixed)
    return rgb_rel, normal_rel


def _iid_stats(albedo, shading, residual) -> dict:
    """Per-sample plane statistics (reference preprocess_hypersim_iid.py:158-175)."""
    return {
        "albedo_min": float(np.min(albedo)),
        "albedo_max": float(np.max(albedo)),
        "albedo_mean": float(np.mean(albedo)),
        "albedo_std": float(np.std(albedo)),
        "albedo_98": float(np.percentile(albedo, 98)),
        "shading_min": float(np.min(shading)),
        "shading_max": float(np.max(shading)),
        "shading_mean": float(np.mean(shading)),
        "shading_std": float(np.std(shading)),
        "shading_98": float(np.percentile(shading, 98)),
        "residual_min": float(np.min(residual)),
        "residual_max": float(np.max(residual)),
        "residual_mean": float(np.mean(residual)),
        "residual_std": float(np.std(residual)),
        "residual_02": float(np.percentile(residual, 2)),
        "residual_98": float(np.percentile(residual, 98)),
    }


def process_iid_frame(
    scene_dir: str, cam: str, frame: int, out_dir: str, split: str
) -> Optional[dict]:
    """One frame: extract diffuse_reflectance/diffuse_illumination/residual
    HDF5 planes -> .npy + stats JSON + tone-mapped rgb PNG, with the
    reference's train/val validity gauntlet. Rejections write a marker file
    under <scene>_invalid/ and re-runs skip both processed frames and known
    rejects (reference preprocess_hypersim_iid.py:123-299)."""
    import json

    from PIL import Image

    stem_final = os.path.join(
        scene_dir, "images", f"scene_{cam}_final_hdf5", f"frame.{frame:04d}"
    )
    stem_geom = os.path.join(
        scene_dir, "images", f"scene_{cam}_geometry_hdf5", f"frame.{frame:04d}"
    )
    scene_name = os.path.basename(scene_dir.rstrip("/"))
    frame_tag = f"{cam}_fr{frame:04d}"
    rels = {
        "rgb": os.path.join(scene_name, f"rgb_{frame_tag}.png"),
        "albedo": os.path.join(scene_name, f"albedo_{frame_tag}.npy"),
        "shading": os.path.join(scene_name, f"shading_{frame_tag}.npy"),
        "residual": os.path.join(scene_name, f"residual_{frame_tag}.npy"),
        "stats": os.path.join(scene_name, f"shading_stats_{frame_tag}.json"),
    }
    marker = os.path.join(
        out_dir, scene_name + "_invalid", f"status_{frame_tag}.txt"
    )
    if os.path.exists(marker):  # resume: known reject
        return None
    if all(os.path.exists(os.path.join(out_dir, r)) for r in rels.values()):
        return rels  # resume: already processed

    def reject(msg: str):
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        with open(marker, "w") as f:
            f.write(msg)
        return None

    entity = _read_h5(stem_geom + ".render_entity_id.hdf5").astype(int)
    num_invalid = int(np.count_nonzero(entity == -1))
    if num_invalid > 0:
        return reject(f"num_invalid={num_invalid}")

    color = _read_h5(stem_final + ".color.hdf5").astype(np.float64)
    albedo = _read_h5(stem_final + ".diffuse_reflectance.hdf5").astype(np.float64)
    shading = _read_h5(stem_final + ".diffuse_illumination.hdf5").astype(np.float64)
    residual = _read_h5(stem_final + ".residual.hdf5").astype(np.float64)

    stats = _iid_stats(albedo, shading, residual)

    if split != "test":
        recon = albedo * shading + residual
        if not np.isfinite(recon).all():
            return reject("reconstruction has non-finite values")
        for name, plane in (
            ("albedo", albedo), ("shading", shading), ("residual", residual)
        ):
            n_nan = int(np.isnan(plane).sum())
            if n_nan:
                return reject(f"{name}_nan={n_nan}")
        if stats["albedo_min"] < 0 or stats["albedo_max"] > 1:
            return reject(
                f"{stats['albedo_min']:0.4f} {stats['albedo_max']:0.4f}"
            )
        if stats["shading_min"] < 0:
            return reject(f"shading_min={stats['shading_min']:0.4f}")
        if stats["residual_min"] < 0:
            return reject(f"residual_min={stats['residual_min']:0.4f}")

        color_tmscale = compute_tone_map_scale(color)
        if not np.isfinite(color_tmscale):
            return reject(f"tone map scale not finite: {color_tmscale}")
        color_tm = (apply_tone_map(color, color_tmscale) * 255).astype(np.uint8)

        # shading and residual deliberately share the shading_98 cutoff so
        # they land on the same scale; the clipped reconstruction must
        # still match the tone-mapped render to >= 40 dB
        cutoff = stats["shading_98"]
        recon_clipped = (
            albedo * np.clip(shading, 0, cutoff) + np.clip(residual, 0, cutoff)
        )
        recon_scale = compute_tone_map_scale(recon_clipped)
        recon_tm = (apply_tone_map(recon_clipped, recon_scale) * 255).astype(
            np.uint8
        )
        if psnr_uint8(color_tm, recon_tm) < 40:
            return reject(f"clipped_psnr={psnr_uint8(color_tm, recon_tm):0.4f}")

    os.makedirs(os.path.join(out_dir, scene_name), exist_ok=True)
    rgb_int = (tone_map(color, entity) * 255).astype(np.uint8)
    Image.fromarray(rgb_int).save(os.path.join(out_dir, rels["rgb"]))
    np.save(os.path.join(out_dir, rels["albedo"]), np.clip(albedo, 0, 1.0))
    np.save(os.path.join(out_dir, rels["shading"]), shading)
    np.save(os.path.join(out_dir, rels["residual"]), residual)
    with open(os.path.join(out_dir, rels["stats"]), "w") as f:
        json.dump(stats, f)
    return rels


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess Hypersim raw data")
    parser.add_argument("--task", choices=["depth", "normals", "iid"],
                        default="depth")
    parser.add_argument("--split_csv", type=str, required=True,
                        help="metadata_images_split_scene_v1.csv")
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    args = parser.parse_args(argv)

    import csv

    rows = []
    with open(args.split_csv) as f:
        for row in csv.DictReader(f):
            if row.get("included_in_public_release", "True") in ("True", "true"):
                rows.append(row)

    filename_lists: dict = {}
    for row in rows:
        split = row.get("split_partition_name", "train")
        scene = row["scene_name"]
        cam = row["camera_name"]
        frame = int(row["frame_id"])
        out_split = os.path.join(args.output_dir, split)
        os.makedirs(out_split, exist_ok=True)
        scene_dir = os.path.join(args.dataset_dir, scene)
        try:
            if args.task == "depth":
                rgb_rel, depth_rel, _ = process_depth_frame(
                    scene_dir, cam, frame, out_split
                )
                # depth lists are relative to the split dir (shipped
                # data_split/hypersim_depth convention); normals/iid lists
                # are split-prefixed (shipped hypersim_filtered_all.txt /
                # reference preprocess_hypersim_iid.py:316-321 convention)
                line = f"{rgb_rel} {depth_rel}"
            elif args.task == "normals":
                result = process_normals_frame(scene_dir, cam, frame, out_split)
                if result is None:
                    print(f"skip {scene}/{cam}/{frame}: NaN normals")
                    continue
                rgb_rel, normal_rel = result
                line = f"{split}/{rgb_rel} {split}/{normal_rel}"
            else:  # iid
                rels = process_iid_frame(scene_dir, cam, frame, out_split, split)
                if rels is None:
                    print(f"skip {scene}/{cam}/{frame}: rejected (see marker)")
                    continue
                line = " ".join(
                    f"{split}/{rels[k]}"
                    for k in ("rgb", "albedo", "shading", "residual", "stats")
                )
            filename_lists.setdefault(split, []).append(line)
        except FileNotFoundError as e:
            print(f"skip {scene}/{cam}/{frame}: {e}")
    list_stem = {
        "depth": "filename_list",
        "normals": "hypersim_filtered",
        "iid": "filename_list",
    }[args.task]
    for split, lines in filename_lists.items():
        with open(
            os.path.join(args.output_dir, f"{list_stem}_{split}.txt"), "w"
        ) as f:
            f.write("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
