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
"""

from __future__ import annotations

import argparse

DEVICES = ("cuda", "cpu")


def add_device_argument(
        parser: argparse.ArgumentParser,
        help: str = "device the pipeline runs on (default cuda; cpu runs "
                    "the kernels' plain versions)") -> None:
    """--device {cuda,cpu}, default cuda: where the pipeline (or eval's
    LPIPS network) runs. "cuda" without a card raises; nothing falls back
    to the CPU unasked."""
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help=help)
