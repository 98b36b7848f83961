"""The bf16 flash backward's schedules measured against each other:
`marigold_tpu_torch/csrc/flash_bwd_sm90.cu` built as it is ("base": each
kernel and head width on what its `Tune` picks) and with its two switches
set for every kernel and width where they apply: FLASH_BWD_PINGPONG=1 or 0
(the two consumers take turns to issue their products, or issue
together) and FLASH_BWD_AREG=1 or 0 (S and dP read their A operand from
registers loaded once, or from the resident tiles in shared memory);
timed side by side on an NVIDIA GPU at the fine-tuning shapes of
chip_smoke.py's BITS_TIMED backward rows (d = 64, 40, 80, 160).

    python3 flash_bwd_variants.py [--check] [VARIANT ...]

The probe_* variants build the base schedule with the exponentials, the S
and dP products, the gradient products, all products or the streamed
stages' TMA loads taken out (the source's FLASH_BWD_PROBE_* switches):
what is left of the time says what the kernels wait on. Their outputs are wrong by design ("within_gate"
false, another digest).

Each variant runs in a process of its own with a time limit, so that a
hang loses only it, and the variants run in turns (each twice: A B B A):
per width, the whole backward's outputs against flash_attention_bwd_plain
within chip_smoke.py's phase 3 gate and a digest of their bits (the
schedules change no sum: every variant must print the same digest), then
(without --check) torch.profiler's device ms per call of each kernel over
the whole backward. Prints one JSON line per variant, run and width.
Builds into marigold_tpu_torch/_build/variants/ (git-ignored).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "marigold_tpu_torch", "csrc", "flash_bwd_sm90.cu")
OUT_DIR = os.path.join(HERE, "marigold_tpu_torch", "_build", "variants")

# name -> the nvcc -D switches the source is built with
VARIANTS = {
    "base": [],
    "pingpong_areg": ["-DFLASH_BWD_PINGPONG=1", "-DFLASH_BWD_AREG=1"],
    "pingpong": ["-DFLASH_BWD_PINGPONG=1", "-DFLASH_BWD_AREG=0"],
    "together_areg": ["-DFLASH_BWD_PINGPONG=0", "-DFLASH_BWD_AREG=1"],
    "together": ["-DFLASH_BWD_PINGPONG=0", "-DFLASH_BWD_AREG=0"],
    # probes: the base schedule with a part of the work taken out (its
    # outputs wrong by design)
    "probe_noexp": ["-DFLASH_BWD_PROBE_NO_EXP"],
    "probe_nologits": ["-DFLASH_BWD_PROBE_NO_LOGIT_MMA"],
    "probe_nograds": ["-DFLASH_BWD_PROBE_NO_GRAD_MMA"],
    "probe_nomma": ["-DFLASH_BWD_PROBE_NO_LOGIT_MMA",
                    "-DFLASH_BWD_PROBE_NO_GRAD_MMA"],
    "probe_noload": ["-DFLASH_BWD_PROBE_NO_LOAD"],
    "probe_nomma_noload": ["-DFLASH_BWD_PROBE_NO_LOGIT_MMA",
                           "-DFLASH_BWD_PROBE_NO_GRAD_MMA",
                           "-DFLASH_BWD_PROBE_NO_LOAD"],
}
TIME_LIMIT_S = 240


def build(names: list) -> list:
    """nvcc of each variant, all started together; returns the built ones
    (spills and ptxas's wgmma serialization notes printed)."""
    from marigold_tpu_torch.ops import cuda_build

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        procs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *VARIANTS[name],
             "-shared", "-o", os.path.join(OUT_DIR, f"lib{name}.so"), SOURCE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = []
    for name, proc in procs.items():
        out = proc.communicate()[0]
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", out)))
        notes = sorted(set(re.findall(r"C75\d\d", out)))
        print(f"variant {name}: nvcc rc {proc.returncode}, spill stores "
              f"{spills}, wgmma notes {notes}", flush=True)
        if proc.returncode == 0:
            built.append(name)
        else:
            print(out[-2000:], flush=True)
    return built


def digest(tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run(name: str, check: bool) -> None:
    """The whole bf16 backward on variant `name`'s library (already built)
    at each width: its gate, its digest and (unless `check`) its device ms
    per kernel."""
    import torch

    import chip_smoke
    from marigold_tpu_torch.ops import flash_attention as fa

    lib = fa.bind_bwd(ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so")))
    fa._bwd_library = lambda: lib
    gen = torch.Generator(device="cuda").manual_seed(24)
    for d, b, n, c, h in chip_smoke.TRAIN_SHAPES:
        q, k, v, g = (torch.randn((b, n, c), generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_attention_lse(q, k, v, h)

        def call():
            return fa.flash_attention_bwd(q, k, v, out, lse, g, h)

        grads = call()
        refs = fa.flash_attention_bwd_plain(q, k, v, g, h)
        torch.cuda.synchronize()
        ok = all(
            bool(torch.isfinite(x.float()).all())
            and (x.float() - r.float()).abs().max().item()
            <= chip_smoke.TOL_REL * r.float().abs().max().item()
            + chip_smoke.GRAD_TOL_ABS
            for x, r in zip(grads, refs))
        line = {"variant": name, "d": d, "within_gate": ok,
                "digest": digest(grads)}
        if not check:
            _, split = chip_smoke.kernel_profile(call, 10, "flash_bwd")
            line["device_ms"] = {k: round(t, 4) for k, t in split.items()}
        print(json.dumps(line), flush=True)
        del q, k, v, g, out, lse, grads, refs


def main(argv: list) -> None:
    if argv[:1] == ["--run"]:
        run(argv[1], argv[2:] == ["--check"])
        return
    check = argv[:1] == ["--check"]
    names = argv[1:] if check else argv
    names = names or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    built = build(names)
    turns = built if check else built + built[::-1]
    failed = False
    for name in turns:
        try:
            r = subprocess.run(
                [sys.executable, __file__, "--run", name,
                 *(["--check"] if check else [])],
                capture_output=True, text=True, timeout=TIME_LIMIT_S, cwd=HERE)
            print(r.stdout.strip(), flush=True)
            if r.returncode:
                failed = True
                print(f"variant {name}: rc {r.returncode}: "
                      f"{r.stderr.strip().splitlines()[-3:]}", flush=True)
        except subprocess.TimeoutExpired:
            failed = True
            print(f"variant {name}: no end within {TIME_LIMIT_S} s", flush=True)
    if failed or len(built) != len(names):
        raise SystemExit(1)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main(sys.argv[1:])
