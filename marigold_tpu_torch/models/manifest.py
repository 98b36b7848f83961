"""Checkpoint manifest validation: diagnose a diffusers checkpoint dir
before the multi-GB load.

Counterpart of `marigold_tpu/models/manifest.py`, with the same report. The
EXPECTED flat tensor manifest of each component comes from the port's own
modules, built on the meta device (no memory is allocated): the port keeps
the diffusers names and torch layout, so `state_dict()` shapes are what a
checkpoint on the hub carries and no layout conversion is needed. It is
compared against the safetensors HEADERS (`weights.read_safetensors_header`;
no tensor data is read), so a broken or mislabeled checkpoint is diagnosed
in milliseconds.

Entry points:
  expected_component_manifest(kind, cfg) -> {torch_name: shape}
  actual_component_manifest(subdir, variant) -> {torch_name: (shape, dtype)}
  validate_checkpoint(ckpt_dir, variant) -> report dict (see docstring)
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Optional

import torch

from marigold_tpu_torch.models import weights as W

# components a diffusers pipeline dir may carry; tokenizer/scheduler are
# config/vocab-only (no tensors)
_TENSOR_COMPONENTS = ("unet", "vae", "text_encoder")

# keys transformers writes that the loader deliberately drops
# (`weights._IGNORED_KEYS`: a CLIPModel's text_projection; position_ids is
# a buffer some exports include)
_IGNORABLE = {
    "text_encoder": {"text_projection.weight",
                     "text_model.embeddings.position_ids"},
    "unet": set(),
    "vae": set(),
}


def _module_for(kind: str, cfg) -> torch.nn.Module:
    if kind == "unet":
        from marigold_tpu_torch.models.unet import UNet2DConditionModel

        return UNet2DConditionModel(cfg)
    if kind == "vae":
        from marigold_tpu_torch.models.vae import AutoencoderKL

        return AutoencoderKL(cfg)
    if kind == "text_encoder":
        from marigold_tpu_torch.models.clip_text import CLIPTextModel

        return CLIPTextModel(cfg)
    raise ValueError(f"unknown component kind: {kind}")


def expected_component_manifest(kind: str, cfg) -> dict:
    """Expected {torch_name: shape} for one component: the port's module
    built on the meta device. The text encoder's names carry transformers'
    `text_model.` prefix, as its checkpoints do."""
    with torch.device("meta"):
        model = _module_for(kind, cfg)
    prefix = "text_model." if kind == "text_encoder" else ""
    return {prefix + k: tuple(v.shape) for k, v in model.state_dict().items()}


def actual_component_manifest(
    subdir: str, variant: Optional[str] = None
) -> dict:
    """{torch_name: (shape, dtype_str)} from safetensors HEADERS only (the
    8-byte-length + json header prefix of each file; tensor data is never
    read). File choice as the JAX module's: the variant's files, else the
    plain ones, else every file."""
    names = [f for f in os.listdir(subdir) if f.endswith(".safetensors")]
    shard = r"(?:-\d+-of-\d+)?\.safetensors$"

    def is_var(f):
        return bool(re.search(r"\.(fp16|bf16|fp32)" + shard, f))

    if variant:
        pat = re.compile(re.escape(f".{variant}") + shard)
        want = [f for f in names if pat.search(f)]
    else:
        want = [f for f in names if not is_var(f)]
    if not want:
        want = names  # fall back to whatever exists (mirrors the loader)
    out: dict[str, tuple] = {}
    for f in sorted(want):
        out.update(W.read_safetensors_header(os.path.join(subdir, f)))
    return out


def _component_config(ckpt_dir: str, kind: str):
    sub = os.path.join(ckpt_dir, kind)
    if kind == "unet":
        from marigold_tpu_torch.models.unet import UNetConfig

        return UNetConfig.from_dict(W.read_config(sub))
    if kind == "vae":
        from marigold_tpu_torch.models.vae import VAEConfig

        return VAEConfig.from_dict(W.read_config(sub))
    from marigold_tpu_torch.models.clip_text import CLIPTextConfig

    return CLIPTextConfig.from_dict(W.read_config(sub))


def validate_checkpoint(
    ckpt_dir: str, variant: Optional[str] = None
) -> dict:
    """Validate a diffusers pipeline checkpoint dir against the manifests
    the loader expects. Returns
      {"ok": bool,
       "components": {kind: {"ok", "n_expected", "n_actual",
                             "missing": [...], "unexpected": [...],
                             "mismatched": {name: {"expected", "actual"}},
                             "dtypes": {dtype: count}}},
       "notes": [...]}
    Missing/mismatched tensors fail validation; unexpected keys beyond the
    known-ignorable set are reported but only warn (the loader ignores
    names it does not consume)."""
    report: dict[str, Any] = {"ok": True, "components": {}, "notes": []}
    if not os.path.isdir(ckpt_dir):
        return {"ok": False, "components": {},
                "notes": [f"not a directory: {ckpt_dir}"]}
    if not os.path.exists(os.path.join(ckpt_dir, "model_index.json")):
        report["notes"].append(
            "no model_index.json (pipeline defaults like "
            "default_denoising_steps will not load)"
        )
    sched_cfg = os.path.join(ckpt_dir, "scheduler", "scheduler_config.json")
    if not os.path.exists(sched_cfg):
        report["ok"] = False
        report["notes"].append("missing scheduler/scheduler_config.json")

    for kind in _TENSOR_COMPONENTS:
        sub = os.path.join(ckpt_dir, kind)
        if not os.path.isdir(sub):
            if kind == "text_encoder":
                report["notes"].append(
                    "no text_encoder/ (pipeline will need a precomputed "
                    "empty-text embedding)"
                )
                continue
            report["ok"] = False
            report["notes"].append(f"missing component dir: {kind}/")
            continue
        try:
            cfg = _component_config(ckpt_dir, kind)
            expected = expected_component_manifest(kind, cfg)
            actual_raw = actual_component_manifest(sub, variant=variant)
        except (OSError, ValueError, KeyError, TypeError, struct.error) as e:
            # unreadable configs/headers
            report["ok"] = False
            report["components"][kind] = {"ok": False, "error": str(e)}
            continue

        # the loader's historical VAE attention aliases: old names compare
        # equal to their modern forms
        actual = {W.checkpoint_name(k): v for k, v in actual_raw.items()}
        ignorable = {W.checkpoint_name(k) for k in _IGNORABLE.get(kind, set())}
        missing = sorted(set(expected) - set(actual))
        unexpected = sorted(set(actual) - set(expected) - ignorable)
        mismatched = {}
        for name in set(expected) & set(actual):
            if tuple(expected[name]) != tuple(actual[name][0]):
                mismatched[name] = {
                    "expected": list(expected[name]),
                    "actual": list(actual[name][0]),
                }
        dtypes: dict[str, int] = {}
        for _, dt in actual.values():
            dtypes[dt] = dtypes.get(dt, 0) + 1
        comp_ok = not missing and not mismatched
        report["components"][kind] = {
            "ok": comp_ok,
            "n_expected": len(expected),
            "n_actual": len(actual),
            "missing": missing,
            "unexpected": unexpected,
            "mismatched": mismatched,
            "dtypes": dtypes,
        }
        if not comp_ok:
            report["ok"] = False
    return report


def format_report(report: dict, max_items: int = 8) -> str:
    lines = []
    for kind, c in report.get("components", {}).items():
        if "error" in c:
            lines.append(f"{kind}: ERROR {c['error']}")
            continue
        status = "ok" if c["ok"] else "FAIL"
        lines.append(
            f"{kind}: {status} ({c['n_actual']}/{c['n_expected']} tensors, "
            f"dtypes {c['dtypes']})"
        )
        for label in ("missing", "unexpected"):
            items = c[label]
            if items:
                shown = ", ".join(items[:max_items])
                more = f" (+{len(items)-max_items} more)" \
                    if len(items) > max_items else ""
                lines.append(f"  {label}: {shown}{more}")
        for name, mm in list(c["mismatched"].items())[:max_items]:
            lines.append(
                f"  shape mismatch {name}: expected {mm['expected']} "
                f"got {mm['actual']}"
            )
    for note in report.get("notes", []):
        lines.append(f"note: {note}")
    lines.append("RESULT: " + ("OK" if report.get("ok") else "FAIL"))
    return "\n".join(lines)
