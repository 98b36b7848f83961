"""Validate a diffusers checkpoint dir against the manifests the port's
loader expects, BEFORE spending the multi-GB load.

Counterpart of `marigold_tpu/cli/validate_ckpt.py`, with its arguments,
output and exit codes. The reference has no equivalent — its
from_pretrained fails mid-load on a broken checkpoint; this diagnoses from
safetensors headers in milliseconds (`models/manifest.py`), on no device.

Usage:
  python -m marigold_tpu_torch.cli.validate_ckpt CKPT_DIR [CKPT_DIR ...] \
      [--variant fp16] [--json]

Exit code 0 iff every checkpoint validates.
"""

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ckpt_dirs", nargs="+",
                    help="diffusers pipeline checkpoint directories")
    ap.add_argument("--variant", default=None,
                    help="weights variant to check (e.g. fp16); default "
                         "checks the non-variant files")
    ap.add_argument("--json", action="store_true",
                    help="emit the full machine-readable report")
    args = ap.parse_args(argv)

    from marigold_tpu_torch.models.manifest import (
        format_report, validate_checkpoint,
    )

    all_ok = True
    for d in args.ckpt_dirs:
        report = validate_checkpoint(d, variant=args.variant)
        if args.json:
            print(json.dumps({"checkpoint": d, **report}))
        else:
            print(f"== {d}")
            print(format_report(report))
        all_ok = all_ok and report["ok"]
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
