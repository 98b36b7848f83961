"""Build and load the port's hand-written CUDA kernels.

Each library is one or more sources under `marigold_tpu_torch/csrc/`,
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library with a plain
C interface and loaded with `ctypes`. The build runs at first use into
`marigold_tpu_torch/_build/<name>-<hash>/`, keyed by a hash of the sources
and the flags, so an edit or a flag change rebuilds and an unchanged tree
reuses what is there. Only sources in the repository are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into build.log
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when reused), "log": build.log path}
BUILD_INFO: dict[str, dict] = {}


def find_nvcc() -> str:
    """nvcc from torch's CUDA_HOME, else from PATH; raises if neither has it."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (torch.utils.cpp_extension.CUDA_HOME="
        f"{CUDA_HOME!r}, and none on PATH): the port's CUDA kernels cannot "
        "be built"
    )


def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Compile (if needed) and load `lib<name>.so` from `csrc/<sources>`."""
    if name in _LIBS:
        return _LIBS[name]
    h = hashlib.sha256()
    for src in sources:
        h.update(src.encode())
        h.update((CSRC_DIR / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"
    log = so.parent / "build.log"
    seconds = 0.0
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC_DIR / s) for s in sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode} building "
                f"{name}:\n{proc.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    BUILD_INFO[name] = {"seconds": seconds, "log": str(log)}
    return lib
