"""Zero-shot evaluation CLI: compute metrics from saved .npy predictions.

Copy of `marigold_tpu/cli/eval.py` for the PyTorch port, its imports
pointed at the port's copies of the data layer, metrics and LPIPS. The
metrics are numpy; the one network, IID's LPIPS, runs on `--device` (cuda
unless cpu is asked for).

Role parity: script/{depth,normals,iid}/eval.py — loads per-sample
predictions produced by cli/infer.py, applies the modality's alignment
protocol (depth: per-image least-squares scale/shift in depth or disparity
space, clip to dataset range; normals: none; IID: scale-align + quantile
map for up-to-scale targets), accumulates the metric suite, and writes a
per-sample CSV + tabulated summary text file.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os

import numpy as np

from marigold_tpu_torch.cli import add_device_argument


def build_parser():
    parser = argparse.ArgumentParser(description="Evaluate saved predictions")
    parser.add_argument("--modality", choices=["depth", "normals", "iid"],
                        default="depth")
    parser.add_argument("--dataset_config", type=str, required=True)
    parser.add_argument("--base_data_dir", type=str, required=True)
    parser.add_argument("--prediction_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--alignment", type=str, default="least_square",
                        choices=["least_square", "least_square_disparity"])
    parser.add_argument("--alignment_max_res", type=int, default=None)
    parser.add_argument("--no_cuda", action="store_true", help="(ignored; kept "
                        "for reference CLI compatibility)")
    parser.add_argument("--targets_to_eval_in_linear_space", type=str,
                        nargs="*", default=[],
                        help="(iid) targets converted sRGB->linear before "
                             "metrics (appearance model protocol)")
    parser.add_argument("--target_names", type=str, nargs="*", default=None,
                        help="(iid) restrict evaluation to these targets "
                             "(reference script/iid/eval.py --target_names; "
                             "default: every target present in the sample)")
    parser.add_argument("--use_mask", action="store_true", default=True)
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="(iid) local VGG16+LPIPS weight file; also "
                             "$LPIPS_WEIGHTS. Skipped when unavailable.")
    parser.add_argument("--limit", type=int, default=0,
                        help="Only evaluate the first N samples (0 = all).")
    add_device_argument(parser, help="(iid) device the LPIPS network runs "
                                     "on (default cuda)")
    return parser


def _load_pred(pred_dir, base, name_mode, scene="", suffix="_pred.npy",
               use_name_mode=True):
    from marigold_tpu_torch.data import get_pred_name

    if use_name_mode:
        pred_name = get_pred_name(base, name_mode, suffix=".npy")
    else:
        pred_name = os.path.splitext(base)[0] + suffix
    path = os.path.join(pred_dir, (scene + "_" if scene else "") + pred_name)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return np.load(path)


def eval_depth(args, dataset, metric_names):
    from marigold_tpu_torch.eval import metrics as M
    from marigold_tpu_torch.eval.alignment import (
        align_depth_least_square,
        depth2disparity,
        disparity2depth,
    )

    tracker = M.MetricTracker(*metric_names)
    rows = []
    for i in range(len(dataset)):
        sample = dataset[i]
        rel = sample["rgb_relative_path"]
        base = os.path.basename(rel)
        scene = os.path.dirname(rel).replace(os.sep, "_")
        pred = _load_pred(args.prediction_dir, base, dataset.name_mode, scene)

        gt = np.asarray(sample["depth_raw_linear"][..., 0])
        valid = np.asarray(sample["valid_mask_raw"][..., 0], bool)

        if args.alignment == "least_square":
            aligned, _, _ = align_depth_least_square(
                gt, pred, valid, max_resolution=args.alignment_max_res
            )
        else:  # disparity-space LS (reference eval.py:179-199)
            gt_disp, nonneg = depth2disparity(gt, return_mask=True)
            pred_disp = pred  # predictions are relative; treat as disparity
            aligned_disp, _, _ = align_depth_least_square(
                gt_disp, pred_disp, valid & nonneg,
                max_resolution=args.alignment_max_res,
            )
            aligned = disparity2depth(aligned_disp)

        aligned = np.clip(aligned, dataset.min_depth, dataset.max_depth)
        aligned[aligned <= 0] = 1e-6

        row = {"filename": rel}
        for name in metric_names:
            v = M.DEPTH_METRICS[name](aligned, gt, valid)
            tracker.update(name, v)
            row[name] = v
        rows.append(row)
    return tracker, rows


def eval_normals(args, dataset, metric_names):
    from marigold_tpu_torch.eval import metrics as M

    tracker = M.MetricTracker(*metric_names)
    rows = []
    for i in range(len(dataset)):
        sample = dataset[i]
        rel = sample["rgb_relative_path"]
        base = os.path.basename(rel)
        scene = os.path.dirname(rel).replace(os.sep, "_")
        pred = _load_pred(
            args.prediction_dir, base, None, scene, use_name_mode=False
        )
        gt = np.asarray(sample["normals"])
        err = M.compute_cosine_error(pred, gt, masked=True)
        row = {"filename": rel}
        for name in metric_names:
            v = M.NORMALS_METRICS[name](err)
            tracker.update(name, v)
            row[name] = v
        rows.append(row)
    return tracker, rows


def eval_iid(args, dataset, metric_names):
    from marigold_tpu_torch.eval import metrics as M
    from marigold_tpu_torch.data.image_io import img_linear2srgb, img_srgb2linear

    linear_targets = set(
        t for t in getattr(args, "targets_to_eval_in_linear_space", []) or []
        if t and t != "None"
    )
    is_hypersim = "hypersim" in getattr(dataset, "disp_name", "")
    target_names = list(args.target_names) if getattr(
        args, "target_names", None
    ) else None
    if target_names is not None:
        known = {"albedo", "material", "shading", "residual"}
        bad = [t for t in target_names if t not in known]
        if bad:
            raise SystemExit(f"--target_names: unknown target(s) {bad}; "
                             f"choose from {sorted(known)}")
    _lin = set(getattr(args, "targets_to_eval_in_linear_space", []) or [])
    if target_names is not None and not _lin <= set(target_names):
        # reference validates the subset relation up front
        # (script/iid/eval.py:120-124)
        raise SystemExit(
            "--targets_to_eval_in_linear_space must be a subset of "
            f"--target_names, got {sorted(_lin - set(target_names))} extra"
        )
    tracker = M.MetricTracker()
    rows = []
    metric_fns = {"psnr": M.psnr, "ssim": M.ssim}
    from marigold_tpu_torch.eval.lpips import get_lpips

    lpips_fn = get_lpips(getattr(args, "lpips_weights", None), args.device)
    if lpips_fn is not None:
        metric_fns["lpips"] = lpips_fn
    elif "lpips" in metric_names:
        import logging as _logging

        _logging.warning("lpips requested but no weights available; skipping")
        metric_names = [m for m in metric_names if m != "lpips"]
    for i in range(len(dataset)):
        sample = dataset[i]
        rel = sample["rgb_relative_path"]
        base = os.path.basename(rel)
        scene = os.path.dirname(rel).replace(os.sep, "_")
        if target_names is None:
            target_names = [
                k for k in ("albedo", "material", "shading", "residual")
                if k in sample
            ]
        row = {"filename": rel}
        for t in target_names:
            pred = _load_pred(
                args.prediction_dir, base, None, scene,
                suffix=f"_{t}_pred.npy", use_name_mode=False,
            )
            if pred.shape[0] == 3 and pred.ndim == 3:
                pred = np.moveaxis(pred, 0, -1)
            gt = np.asarray(sample[t])
            # appearance protocol: evaluate listed targets in linear space
            if t in linear_targets:
                pred, gt = img_srgb2linear(pred), img_srgb2linear(gt)
            # lighting protocol: Hypersim GT/preds are linear; albedo is
            # evaluated in sRGB (reference script/iid/eval.py:182-196).
            # Detect the lighting model from the SAMPLE (shading present),
            # not from len(target_names) — --target_names may restrict
            # the evaluated list without changing the checkpoint protocol
            if is_hypersim and "shading" in sample and t == "albedo":
                pred, gt = img_linear2srgb(pred), img_linear2srgb(gt)
            mask = sample.get(f"mask_{t}")
            mask = np.asarray(mask, bool) if mask is not None else None
            for mname in metric_names:
                v = M.compute_iid_metric(
                    pred, gt, t, metric_fns[mname], valid_mask=mask,
                    metric_name=mname,
                )
                tracker.update(f"{mname}_{t}", v)
                row[f"{mname}_{t}"] = v
        rows.append(row)
    return tracker, rows


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from marigold_tpu_torch.config import recursive_load_config
    from marigold_tpu_torch.data import DatasetMode, get_dataset
    from marigold_tpu_torch.utils.logging_util import eval_dict_to_text

    cfg = recursive_load_config(args.dataset_config)
    cfg_data = cfg.get("dataset") or cfg  # flat configs supported
    dataset = get_dataset(
        cfg_data, base_data_dir=args.base_data_dir, mode=DatasetMode.EVAL
    )
    if args.limit > 0:
        dataset.filenames = dataset.filenames[: args.limit]

    if args.modality == "depth":
        metric_names = list(
            cfg.get("eval", {}).get("eval_metrics")
            or [
                "abs_relative_difference", "squared_relative_difference",
                "rmse_linear", "rmse_log", "log10", "delta1_acc",
                "delta2_acc", "delta3_acc", "i_rmse", "silog_rmse",
            ]
        )
        tracker, rows = eval_depth(args, dataset, metric_names)
    elif args.modality == "normals":
        metric_names = list(
            cfg.get("eval", {}).get("eval_metrics")
            or [
                "mean_angular_error", "median_angular_error",
                "rmse_angular_error", "sub5_error", "sub7_5_error",
                "sub11_25_error", "sub22_5_error", "sub30_error",
            ]
        )
        tracker, rows = eval_normals(args, dataset, metric_names)
    else:
        # reference reports psnr/ssim/lpips per target (script/iid/
        # eval.py:127-131); lpips is dropped with a warning when no
        # offline weights are available (scripts/export_lpips_weights.py)
        metric_names = list(
            cfg.get("eval", {}).get("eval_metrics")
            or ["psnr", "ssim", "lpips"]
        )
        tracker, rows = eval_iid(args, dataset, metric_names)

    os.makedirs(args.output_dir, exist_ok=True)
    # per-sample CSV (reference eval.py:219-245)
    csv_path = os.path.join(args.output_dir, "per_sample_metrics.csv")
    if rows:
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)

    result = tracker.result()
    text = eval_dict_to_text(
        result, dataset.disp_name, dataset.filename_ls_path
    )
    suffix = "least_square" if args.alignment.startswith("least_square") else "none"
    txt_path = os.path.join(args.output_dir, f"eval_metrics-{suffix}.txt")
    with open(txt_path, "w") as f:
        f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
