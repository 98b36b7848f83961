"""Where the bf16 Winograd kernel's time goes: variants of
`marigold_tpu_torch/csrc/winograd.cu`, each the source built with parts of
its work taken out, built side by side and timed at chip_smoke.py's nine
CONV_CASES in the fused design (one persistent launch) on an NVIDIA GPU.
The outputs of the variants are wrong by design; "base" is the source
itself, held to the plain version within chip_smoke.py's gate.

    python3 winograd_variants.py [VARIANT ...]

Variants (VARIANTS, each the source built with its WINO_VARIANT_*
switches): base; nobuild (the builders fill no V slot); nofold (the
consumers fold one accumulator register, not 32); noconsume (no wgmma, no
fold: the builders' and the producer's time); skeleton (no build, wgmma
or fold: the rings, barriers, box and U loads and the stores). Each
variant runs in a process of its own with a time limit, so that a hang
loses only it. Prints one line per variant and case: the
device ms per call (torch.profiler) and whether the output is within the
gate. Builds into marigold_tpu_torch/_build/variants/ (git-ignored).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "marigold_tpu_torch", "csrc", "winograd.cu")
OUT_DIR = os.path.join(HERE, "marigold_tpu_torch", "_build", "variants")

# name -> the source's WINO_VARIANT_* switches it is built with
VARIANTS = {
    "base": [],
    "nobuild": ["NO_BUILD"],
    "nofold": ["NO_FOLD"],
    "noconsume": ["NO_WGMMA", "NO_FOLD"],
    "skeleton": ["NO_BUILD", "NO_WGMMA", "NO_FOLD"],
}
TIME_LIMIT_S = 200


def build(names: list) -> list:
    """nvcc of each variant, all started together; returns the built ones
    (ptxas spills printed)."""
    from marigold_tpu_torch.ops import cuda_build

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        procs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
             *(f"-DWINO_VARIANT_{d}" for d in VARIANTS[name]), "-shared",
             "-o", os.path.join(OUT_DIR, f"lib{name}.so"), SOURCE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = []
    for name, proc in procs.items():
        out = proc.communicate()[0]
        spills = re.findall(r"(\d+) bytes spill stores", out)
        print(f"variant {name}: nvcc rc {proc.returncode}, spill stores "
              f"{spills}", flush=True)
        if proc.returncode == 0:
            built.append(name)
        else:
            print(out[-2000:], flush=True)
    return built


def run(name: str) -> None:
    """Times variant `name` (already built) at every CONV_CASES."""
    import torch

    import chip_smoke
    from marigold_tpu_torch.ops import winograd as wino_ops

    lib = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mt_winograd_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.mt_winograd_fwd.restype = i
    lib.mt_cuda_error_string.argtypes = [i]
    lib.mt_cuda_error_string.restype = ctypes.c_char_p
    gen = torch.Generator(device="cuda").manual_seed(5)
    for case, b, c, k, hw in chip_smoke.CONV_CASES:
        x = torch.randn((b, c, hw, hw), generator=gen,
                        device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, c, 3, 3), generator=gen, device="cuda")
             / (3.0 * c ** 0.5)).to(torch.bfloat16)
        bias = torch.randn((k,), generator=gen, device="cuda").to(torch.bfloat16)
        u = wino_ops.filter_transform(w)

        def call():
            return wino_ops.launch_design(x, u, bias, True, lib)

        out = call()
        ref = wino_ops.winograd3x3_plain(x, w, bias).float()
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        ok = err <= chip_smoke.TOL_REL * ref.abs().max().item() + chip_smoke.TOL_ABS
        n, split = chip_smoke.kernel_profile(call, 5)
        print(json.dumps({"variant": name, "case": case,
                          "device_ms": round(sum(split.values()), 4),
                          "launches": n, "within_gate": ok}), flush=True)
        del x, w, bias, u, out, ref


def main(argv: list) -> None:
    if argv[:1] == ["--run"]:
        run(argv[1])
        return
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    for name in build(names):
        try:
            r = subprocess.run([sys.executable, __file__, "--run", name],
                               capture_output=True, text=True,
                               timeout=TIME_LIMIT_S, cwd=HERE)
            print(r.stdout.strip(), flush=True)
            if r.returncode:
                print(f"variant {name}: rc {r.returncode}: "
                      f"{r.stderr.strip().splitlines()[-1:]}", flush=True)
        except subprocess.TimeoutExpired:
            print(f"variant {name}: no end within {TIME_LIMIT_S} s", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main(sys.argv[1:])
