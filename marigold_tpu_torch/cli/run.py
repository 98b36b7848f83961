"""In-the-wild folder inference CLI.

Counterpart of `marigold_tpu/cli/run.py` (role parity: script/{depth,
normals,iid}/run.py in the reference): run a checkpoint over a folder of
images and save npy + PNG outputs, with the same arguments and file names.
The pipeline runs on `--device` (cuda unless cpu is asked for), in bf16
unless `--full_precision`, which runs it in fp32 through the fp32 kernels
with TF32 off (`cli/__init__.py:set_full_precision`).

Example:
  python -m marigold_tpu_torch.cli.run --modality depth \
      --checkpoint /path/to/marigold-depth-v1-1 \
      --input_rgb_dir in/ --output_dir out/ \
      --denoise_steps 4 --ensemble_size 10
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np

from marigold_tpu_torch.cli import add_device_argument, set_full_precision

EXTENSION_LIST = [".jpg", ".jpeg", ".png"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run Marigold inference on a folder of images (PyTorch)."
    )
    parser.add_argument("--modality", choices=["depth", "normals", "iid"],
                        default="depth")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Pipeline checkpoint path (diffusers layout).")
    parser.add_argument("--input_rgb_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--denoise_steps", type=int, default=None)
    parser.add_argument("--ensemble_size", type=int, default=1)
    parser.add_argument("--half_precision", action="store_true",
                        help="bf16 inference (the default) from the fp16 "
                             "weight-variant files when the checkpoint "
                             "ships them.")
    parser.add_argument("--full_precision", action="store_true",
                        help="fp32 inference (overrides the bf16 default).")
    parser.add_argument("--processing_res", type=int, default=None,
                        help="0 = native resolution.")
    parser.add_argument("--output_processing_res", action="store_true",
                        help="Do not resize back to input resolution.")
    parser.add_argument("--resample_method", type=str, default="bilinear",
                        choices=["bilinear", "bicubic", "nearest"])
    parser.add_argument("--color_map", type=str, default="Spectral",
                        help="(depth) colormap; 'None' to skip.")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=0)
    add_device_argument(parser)
    return parser


def pipeline_class(modality: str):
    from marigold_tpu_torch import (
        MarigoldDepthPipeline,
        MarigoldIIDPipeline,
        MarigoldNormalsPipeline,
    )

    return {
        "depth": MarigoldDepthPipeline,
        "normals": MarigoldNormalsPipeline,
        "iid": MarigoldIIDPipeline,
    }[modality]


def save_one(modality: str, output_dir: str, name: str, out) -> None:
    """Save one pipeline Output: `<modality>_npy/<name>_pred.npy` and the
    PNGs (depth: 16-bit and coloured; normals; IID: one per target). The
    one place the output layout is decided; `serve` saves through it."""
    from PIL import Image

    from marigold_tpu_torch.pipelines import image_util

    out_npy = os.path.join(output_dir, f"{modality}_npy")
    os.makedirs(out_npy, exist_ok=True)
    if modality == "depth":
        np.save(os.path.join(out_npy, f"{name}_pred.npy"), out.depth_np)
        bw = Image.fromarray(image_util.float2int(out.depth_np, 16))
        bw.save(os.path.join(output_dir, f"{name}_depth_bw.png"))
        if out.depth_colored is not None:
            out.depth_colored.save(
                os.path.join(output_dir, f"{name}_depth_colored.png")
            )
    elif modality == "normals":
        np.save(os.path.join(out_npy, f"{name}_pred.npy"), out.normals_np)
        out.normals_img.save(os.path.join(output_dir, f"{name}_normals.png"))
    else:
        for entry in out:
            np.save(
                os.path.join(out_npy, f"{name}_{entry.name}_pred.npy"),
                entry.array,
            )
            entry.image.save(
                os.path.join(output_dir, f"{name}_{entry.name}.png")
            )


def main(argv=None):
    import torch
    from PIL import Image

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    dtype = torch.float32 if args.full_precision else torch.bfloat16
    if args.full_precision:
        set_full_precision()
    # --half_precision also prefers fp16 weight-variant files when the
    # checkpoint ships them (reference script/depth/run.py:203-215); the
    # loader falls back to the plain files when no variant exists
    variant = "fp16" if args.half_precision else None
    pipe = pipeline_class(args.modality).from_pretrained(
        args.checkpoint, dtype=dtype, device=args.device, variant=variant)

    rgb_paths = sorted(
        p
        for ext in EXTENSION_LIST
        for p in glob.glob(os.path.join(args.input_rgb_dir, f"*{ext}"))
    )
    if not rgb_paths:
        logging.error(f"no images found in {args.input_rgb_dir}")
        return 1
    logging.info(f"inference on {len(rgb_paths)} images")

    os.makedirs(os.path.join(args.output_dir, f"{args.modality}_npy"),
                exist_ok=True)

    common = dict(
        denoising_steps=args.denoise_steps,
        ensemble_size=args.ensemble_size,
        processing_res=args.processing_res,
        match_input_res=not args.output_processing_res,
        resample_method=args.resample_method,
        batch_size=args.batch_size,
        seed=args.seed,
        show_progress_bar=True,
        # in-the-wild folders mix image shapes; the JAX package pads to a
        # 64-px bucket (masked out of ensemble statistics) to bound its
        # compiles, and the port pads the same way so both give one map
        shape_bucketing=True,
    )

    cmap = None if args.color_map == "None" else args.color_map
    for path in rgb_paths:
        name = os.path.splitext(os.path.basename(path))[0]
        img = Image.open(path)
        if args.modality == "depth":
            out = pipe(img, color_map=cmap, **common)
        else:
            out = pipe(img, **common)
        save_one(args.modality, args.output_dir, name, out)
        logging.info(f"done: {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
