"""Command-line entry points of the PyTorch port.

Counterpart of `marigold_tpu/cli/`: `run`, `serve`, `validate_ckpt`,
`infer`, `eval`, `benchmark` and `train`, each run as
`python -m marigold_tpu_torch.cli.<name>` or in-process through
`main(argv)`, with the JAX CLIs' arguments, defaults and output files.

The JAX package's `apply_platform_env` (the JAX_PLATFORMS override and the
persistent compile cache of `utils/compile_cache.py`) has no counterpart:
the port compiles no program, so there is no cache to keep, and the device
is an argument instead. Every CLI that runs a model takes `--device`
(`add_device_argument`) and hands it to `from_pretrained(device=...)`,
eval to `get_lpips(device=...)`, train to its trainer:
"cuda" by default, which raises without a card; the CPU only when asked.

`--full_precision` (`run`, `serve`) runs the pipeline in fp32 through the
fp32 kernels (`csrc/flash_fwd_d64_f32_sm90.cu`, `csrc/conv3x3_f32_sm90.cu`,
...) and, by `set_full_precision`, turns TF32 off for every other fp32
product: cuBLAS matmuls (`torch.backends.cuda.matmul.allow_tf32`, off by
default) and cuDNN convolutions (`torch.backends.cudnn.allow_tf32`, on by
default), so that no fp32 product on the card keeps only TF32's ~10
mantissa bits.
"""

from __future__ import annotations

import argparse

DEVICES = ("cuda", "cpu")


def set_full_precision() -> None:
    """fp32 products in full fp32 on the card: TF32 off for cuBLAS matmuls
    and cuDNN convolutions (process-wide flags)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def add_device_argument(
        parser: argparse.ArgumentParser,
        help: str = "device the pipeline runs on (default cuda; cpu runs "
                    "the kernels' plain versions)") -> None:
    """--device {cuda,cpu}, default cuda: where the pipeline (or eval's
    LPIPS network) runs. "cuda" without a card raises; nothing falls back
    to the CPU unasked."""
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help=help)
