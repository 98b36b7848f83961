"""Dataset inference CLI: run a checkpoint over an eval dataset (RGB_ONLY
mode) and save per-sample .npy predictions.

Counterpart of `marigold_tpu/cli/infer.py`, with its arguments and file
names; the pipeline runs in bf16 on `--device` (cuda unless cpu is asked
for).

Role parity: script/{depth,normals,iid}/infer.py — the first half of the
two-process zero-shot benchmark protocol (filesystem is the interface to
eval.py; SURVEY.md §3.3).
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from marigold_tpu_torch.cli import add_device_argument


def build_parser():
    parser = argparse.ArgumentParser(description="Dataset inference -> npy")
    parser.add_argument("--modality", choices=["depth", "normals", "iid"],
                        default="depth")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--dataset_config", type=str, required=True,
                        help="YAML data config (config/dataset_*/data_*.yaml)")
    parser.add_argument("--base_data_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--denoise_steps", type=int, default=None)
    parser.add_argument("--ensemble_size", type=int, default=1)
    parser.add_argument("--processing_res", type=int, default=None)
    parser.add_argument("--output_processing_res", action="store_true")
    parser.add_argument("--resample_method", type=str, default="bilinear")
    parser.add_argument("--half_precision", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=0)
    parser.add_argument("--serving_batch", type=int, default=1,
                        help="process N same-shape images per "
                             "batch_call for throughput (batched serving; "
                             "all modalities).")
    parser.add_argument("--limit", type=int, default=0,
                        help="Only process the first N samples (0 = all). "
                             "For smoke-testing the real protocol configs "
                             "on partial data trees.")
    parser.add_argument("--ensemble_reg_max_res", type=int, default=None,
                        help="pin the ensemble range-regularizer solve "
                             "resolution (reference-faithful: 1024; "
                             "serving default: 96 — docs/PARITY.md "
                             "'Reproduction pins').")
    parser.add_argument("--ensemble_gauge_anchor", type=int, default=None,
                        choices=(0, 1),
                        help="1 (default): anchor ensemble member 0 to "
                             "block the scale-degenerate collapse; 0: "
                             "reference-exact unanchored objective "
                             "(marigold/util/ensemble.py:154-173) — "
                             "docs/PARITY.md 'Reproduction pins'.")
    parser.add_argument("--overwrite", action="store_true",
                        help="Recompute predictions that already exist "
                             "(default: skip existing files — the "
                             "non-interactive analog of the reference's "
                             "overwrite prompt, infer.py:172-190).")
    add_device_argument(parser)
    return parser


def main(argv=None):
    import torch

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from marigold_tpu_torch.cli.run import pipeline_class
    from marigold_tpu_torch.config import recursive_load_config
    from marigold_tpu_torch.data import DatasetMode, get_dataset, get_pred_name
    from marigold_tpu_torch.utils.seeding import seed_all

    # seed default = current time (reference infer.py:164-170)
    seed = args.seed if args.seed is not None else int(time.time())
    seed_all(seed)

    cfg = recursive_load_config(args.dataset_config)
    cfg_data = cfg.get("dataset") or cfg  # flat configs supported
    dataset = get_dataset(
        cfg_data, base_data_dir=args.base_data_dir, mode=DatasetMode.RGB_ONLY
    )
    if args.limit > 0:
        dataset.filenames = dataset.filenames[: args.limit]

    pipe = pipeline_class(args.modality).from_pretrained(
        args.checkpoint, dtype=torch.bfloat16, device=args.device,
        variant="fp16" if args.half_precision else None,
    )

    out_npy = os.path.join(args.output_dir, f"{args.modality}_npy")
    os.makedirs(out_npy, exist_ok=True)

    common = dict(
        denoising_steps=args.denoise_steps,
        ensemble_size=args.ensemble_size,
        processing_res=args.processing_res,
        match_input_res=not args.output_processing_res,
        resample_method=args.resample_method,
        batch_size=args.batch_size,
        seed=seed,
        show_progress_bar=False,
    )
    ens_kwargs = {}
    if args.ensemble_reg_max_res is not None:
        ens_kwargs["reg_max_res"] = args.ensemble_reg_max_res
    if args.ensemble_gauge_anchor is not None:
        ens_kwargs["gauge_anchor"] = bool(args.ensemble_gauge_anchor)
    if ens_kwargs:
        common["ensemble_kwargs"] = ens_kwargs

    # batched-serving fast path (all modalities): group same-shape
    # consecutive samples into one batch_call
    if args.serving_batch > 1:
        t0 = time.time()
        pending = []  # (img, save_meta): save path, or stem for iid

        def flush():
            if not pending:
                return
            imgs = [p[0] for p in pending]
            outs = pipe.batch_call(imgs, **{
                k: v for k, v in common.items() if k != "show_progress_bar"
            })
            for (_, meta), out in zip(pending, outs):
                if args.modality == "depth":
                    np.save(meta, out.depth_np)
                elif args.modality == "normals":
                    np.save(meta, out.normals_np)
                else:
                    for entry in out:
                        np.save(
                            os.path.join(
                                out_npy, f"{meta}_{entry.name}_pred.npy"
                            ),
                            entry.array,
                        )
            pending.clear()

        for i in range(len(dataset)):
            sample = dataset[i]
            rel = sample["rgb_relative_path"]
            base = os.path.basename(rel)
            scene = os.path.dirname(rel).replace(os.sep, "_")
            if args.modality == "iid":
                # iid RGB_ONLY samples carry float [0,1] "rgb" (possibly
                # HDR-derived), and fan out one file per target
                img = np.asarray(sample["rgb"], np.float32)
                stem = (
                    (scene + "_" if scene else "")
                    + os.path.splitext(base)[0]
                )
                if not args.overwrite and all(
                    os.path.exists(
                        os.path.join(out_npy, f"{stem}_{t}_pred.npy")
                    )
                    for t in pipe.target_names
                ):
                    continue
                meta = stem
            else:
                img = np.asarray(sample["rgb_int"], np.uint8)
                if args.modality == "depth":
                    pred_name = get_pred_name(
                        base, dataset.name_mode, suffix=".npy"
                    )
                else:
                    pred_name = os.path.splitext(base)[0] + "_pred.npy"
                meta = os.path.join(
                    out_npy, (scene + "_" if scene else "") + pred_name
                )
                if os.path.exists(meta) and not args.overwrite:
                    continue
            if pending and pending[0][0].shape != img.shape:
                flush()
            pending.append((img, meta))
            if len(pending) >= args.serving_batch:
                flush()
            if (i + 1) % 50 == 0 or i == len(dataset) - 1:
                rate = (i + 1) / (time.time() - t0)
                logging.info(f"{i+1}/{len(dataset)} samples ({rate:.2f}/s)")
        flush()
        return 0

    t0 = time.time()
    for i in range(len(dataset)):
        sample = dataset[i]
        rel = sample["rgb_relative_path"]
        base = os.path.basename(rel)
        scene = os.path.dirname(rel).replace(os.sep, "_")

        if args.modality == "depth":
            rgb_int = np.asarray(sample["rgb_int"], np.uint8)
            pred_name = get_pred_name(base, dataset.name_mode, suffix=".npy")
            save_to = os.path.join(
                out_npy, (scene + "_" if scene else "") + pred_name
            )
            if os.path.exists(save_to) and not args.overwrite:
                continue
            out = pipe(rgb_int, color_map=None, **common)
            np.save(save_to, out.depth_np)
        elif args.modality == "normals":
            rgb_int = np.asarray(sample["rgb_int"], np.uint8)
            save_to = os.path.join(
                out_npy,
                (scene + "_" if scene else "")
                + os.path.splitext(base)[0] + "_pred.npy",
            )
            if os.path.exists(save_to) and not args.overwrite:
                continue
            out = pipe(rgb_int, **common)
            np.save(save_to, out.normals_np)
        else:
            # iid RGB_ONLY samples carry "rgb" (float [0,1], possibly
            # HDR-derived), not "rgb_int"
            rgb01 = np.asarray(sample["rgb"], np.float32)
            stem = (scene + "_" if scene else "") + os.path.splitext(base)[0]
            targets = pipe.target_names
            if not args.overwrite and all(
                os.path.exists(os.path.join(out_npy, f"{stem}_{t}_pred.npy"))
                for t in targets
            ):
                continue
            out = pipe(rgb01, **common)
            for entry in out:
                np.save(
                    os.path.join(out_npy, f"{stem}_{entry.name}_pred.npy"),
                    entry.array,
                )
        if (i + 1) % 10 == 0 or i == len(dataset) - 1:
            rate = (i + 1) / (time.time() - t0)
            logging.info(f"{i+1}/{len(dataset)} samples ({rate:.2f}/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
