"""Zero-shot benchmark driver: the canonical eval protocols as one CLI.

Counterpart of `marigold_tpu/cli/benchmark.py`, with its registry, pins,
arguments and output tree; infer and eval run on `--device` (cuda unless
cpu is asked for). `--parity` pins the port's flash softmax to "online" (the
setter for this process, MARIGOLD_TPU_FLASH_SOFTMAX for any child) and the
ensemble's reg_max_res and gauge_anchor, as in the JAX package.

Role parity: the reference's 30+ bash scripts under script/*/eval/*.sh
(SURVEY.md §2.5) — each pins (steps, ensemble, seed, processing_res,
alignment) per dataset. One registry + one command replaces them:

  python -m marigold_tpu_torch.cli.benchmark --modality depth --benchmark nyu \
      --checkpoint <ckpt> --base_data_dir $BASE_DATA_DIR --output_dir out/

  python -m marigold_tpu_torch.cli.benchmark --modality depth --benchmark all ...

Protocol constants from the reference drivers (BASELINE.md):
  depth v1-1: 1 step, ensemble 10, seed 1234; processing_res 0 for
  NYU/KITTI/ScanNet, 756 ETH3D, 640 DIODE; LS alignment.
  normals: 4 steps, ensemble 10; res 640 (ScanNet/NYU/iBims), 768
  (DIODE/OASIS). IID: 4 steps, ensemble 1; appearance 640, lighting 0.
"""

from __future__ import annotations

import argparse
import logging
import os

from marigold_tpu_torch.cli import add_device_argument

# benchmark name -> (dataset_config, infer overrides, eval flags)
DEPTH_PROTOCOLS = {
    "nyu": ("config/dataset_depth/data_nyu_test.yaml",
            dict(processing_res=0), []),
    "kitti": ("config/dataset_depth/data_kitti_eigen_test.yaml",
              dict(processing_res=0), []),
    # ETH3D pins the LS-alignment solve resolution
    # (reference 32_eval_eth3d.sh:13)
    "eth3d": ("config/dataset_depth/data_eth3d.yaml",
              dict(processing_res=756), ["--alignment_max_res", "1024"]),
    "scannet": ("config/dataset_depth/data_scannet_val.yaml",
                dict(processing_res=0), []),
    "diode": ("config/dataset_depth/data_diode_all.yaml",
              dict(processing_res=640), []),
}
NORMALS_PROTOCOLS = {
    "scannet": ("config/dataset_normals/data_scannet_test.yaml",
                dict(processing_res=640), []),
    "nyu": ("config/dataset_normals/data_nyu_test.yaml",
            dict(processing_res=640), []),
    "ibims": ("config/dataset_normals/data_ibims_test.yaml",
              dict(processing_res=640), []),
    "diode": ("config/dataset_normals/data_diode_test.yaml",
              dict(processing_res=768), []),
    "oasis": ("config/dataset_normals/data_oasis_test.yaml",
              dict(processing_res=768), []),
}
IID_PROTOCOLS = {
    # material is evaluated in linear space (reference
    # 12_eval_appearance_interiorverse.sh:13)
    "appearance_interiorverse": (
        "config/dataset_iid/data_appearance_interiorverse_test.yaml",
        dict(processing_res=640),
        ["--targets_to_eval_in_linear_space", "material"],
    ),
    "lighting_hypersim": (
        "config/dataset_iid/data_lighting_hypersim_test.yaml",
        dict(processing_res=0),
        [],
    ),
}

DEFAULTS = {
    "depth": dict(denoise_steps=1, ensemble_size=10, seed=1234),
    "normals": dict(denoise_steps=4, ensemble_size=10, seed=1234),
    "iid": dict(denoise_steps=4, ensemble_size=1, seed=1234),
}

PROTOCOLS = {
    "depth": DEPTH_PROTOCOLS,
    "normals": NORMALS_PROTOCOLS,
    "iid": IID_PROTOCOLS,
}


def build_parser():
    p = argparse.ArgumentParser(description="Run the zero-shot eval protocol")
    p.add_argument("--modality", choices=["depth", "normals", "iid"],
                   default="depth")
    p.add_argument("--benchmark", type=str, default="all",
                   help="dataset key or 'all'")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--base_data_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="output/eval")
    p.add_argument("--ensemble_size", type=int, default=None)
    p.add_argument("--denoise_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--skip_infer", action="store_true",
                   help="Only evaluate existing predictions.")
    p.add_argument("--overwrite", action="store_true",
                   help="Re-infer over existing prediction files (without "
                        "this, stale predictions from an earlier run with "
                        "different settings would be silently reused).")
    p.add_argument("--old_protocol", action="store_true",
                   help="CVPR v1-0 depth protocol (50 steps).")
    p.add_argument("--serving_batch", type=int, default=1,
                   help="group same-shape consecutive samples into fused "
                        "N-image device batches during inference "
                        "(throughput mode; passed through to cli.infer)")
    p.add_argument("--limit", type=int, default=0,
                   help="Only process the first N samples per dataset "
                        "(0 = all). For protocol smoke tests.")
    p.add_argument("--processing_res", type=int, default=None,
                   help="Override the protocol's pinned processing "
                        "resolution (smoke tests on small models).")
    p.add_argument("--parity", action="store_true",
                   help="reference-faithful mode: pins the three documented "
                        "serving-path deviations (docs/PARITY.md "
                        "'Reproduction pins') — flash softmax 'online' "
                        "(exact running-max instead of the shifted "
                        "fast path), ensemble reg_max_res=1024 "
                        "(full-res range regularizer), and "
                        "gauge_anchor=0 (reference-exact unanchored "
                        "alignment objective). Use for real-weights "
                        "metric-parity runs.")
    p.add_argument("--ensemble_reg_max_res", type=int, default=None,
                   help="pin the ensemble range-regularizer solve "
                        "resolution (overrides --parity's 1024).")
    p.add_argument("--ensemble_gauge_anchor", type=int, default=None,
                   choices=(0, 1),
                   help="ensemble member-0 gauge anchor (overrides "
                        "--parity's 0; serving default 1).")
    add_device_argument(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    reg_max_res = args.ensemble_reg_max_res
    gauge_anchor = args.ensemble_gauge_anchor
    if args.parity:
        # pin the documented serving-path deviations (PARITY.md
        # 'Reproduction pins'): exact online softmax in the flash
        # kernels + full-res ensemble range regularizer. The env var
        # covers any child process; the setter covers this one even
        # if ops.attention was imported before the flag was parsed.
        os.environ["MARIGOLD_TPU_FLASH_SOFTMAX"] = "online"
        from marigold_tpu_torch.ops.attention import set_flash_softmax

        set_flash_softmax("online")
        if reg_max_res is None:
            reg_max_res = 1024
        if gauge_anchor is None:
            gauge_anchor = 0

    from marigold_tpu_torch.cli.eval import main as eval_main
    from marigold_tpu_torch.cli.infer import main as infer_main
    base_data_dir = args.base_data_dir or os.environ.get("BASE_DATA_DIR")
    if not base_data_dir:
        raise SystemExit("--base_data_dir or $BASE_DATA_DIR required")

    table = PROTOCOLS[args.modality]
    names = list(table) if args.benchmark == "all" else [args.benchmark]
    unknown = [n for n in names if n not in table]
    if unknown:
        raise SystemExit(
            f"unknown --benchmark {unknown} for modality "
            f"{args.modality!r}; valid: {sorted(table)} or 'all'"
        )
    defaults = dict(DEFAULTS[args.modality])
    if args.old_protocol and args.modality == "depth":
        defaults["denoise_steps"] = 50
    for k in ("ensemble_size", "denoise_steps", "seed"):
        if getattr(args, k) is not None:
            defaults[k] = getattr(args, k)

    results = {}
    for name in names:
        cfg_path, overrides, eval_flags = table[name]
        proto = dict(defaults, **overrides)
        if args.processing_res is not None:  # CLI beats the protocol pin
            proto["processing_res"] = args.processing_res
        out_base = os.path.join(args.output_dir, args.modality, name)
        pred_dir = os.path.join(out_base, "prediction")
        metric_dir = os.path.join(out_base, "eval_metric")
        logging.info(f"=== {args.modality}/{name}: {proto} ===")

        limit = ["--limit", str(args.limit)] if args.limit > 0 else []
        overwrite = ["--overwrite"] if args.overwrite else []
        reg = (["--ensemble_reg_max_res", str(reg_max_res)]
               if reg_max_res is not None else [])
        if gauge_anchor is not None:
            reg += ["--ensemble_gauge_anchor", str(gauge_anchor)]
        if not args.skip_infer:
            rc = infer_main([
                "--modality", args.modality,
                "--checkpoint", args.checkpoint,
                "--dataset_config", cfg_path,
                "--base_data_dir", base_data_dir,
                "--output_dir", pred_dir,
                "--denoise_steps", str(proto["denoise_steps"]),
                "--ensemble_size", str(proto["ensemble_size"]),
                "--processing_res", str(proto["processing_res"]),
                "--seed", str(proto["seed"]),
                "--serving_batch", str(args.serving_batch),
                "--device", args.device,
            ] + limit + overwrite + reg)
            if rc != 0:
                return rc
        rc = eval_main([
            "--modality", args.modality,
            "--dataset_config", cfg_path,
            "--base_data_dir", base_data_dir,
            "--prediction_dir", os.path.join(
                pred_dir, f"{args.modality}_npy"
            ),
            "--output_dir", metric_dir,
            "--device", args.device,
        ] + limit + eval_flags)
        if rc != 0:
            return rc
        results[name] = metric_dir
    logging.info(f"benchmark metric dirs: {results}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
