"""Build and load the port's hand-written CUDA kernels.

Each library is one or more sources under `marigold_tpu_torch/csrc/`,
compiled by `nvcc` for Hopper (`sm_90a`), one process per source, all
started together, and linked into a shared library with a plain C interface
that is loaded with `ctypes`. The build runs at first use into
`marigold_tpu_torch/_build/<name>-<hash>/`, keyed by a hash of the sources,
every header under `csrc/` and the flags (`build_key`), so an edit or a
flag change rebuilds and an unchanged tree reuses what is there. Only
sources in the repository are compiled.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into build.log
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when reused), "log": build.log path}
BUILD_INFO: dict[str, dict] = {}
# one build of a library at a time: serving threads may reach its first use
# together, and their object files would share the process id in their
# names; different libraries build in directories of their own, at once
_BUILD_LOCKS: dict[str, threading.Lock] = collections.defaultdict(
    threading.Lock)
_LOCKS_LOCK = threading.Lock()


class LaunchCounter(collections.Counter):
    """Kernel launches by variant. `add` is the one place a wrapper counts a
    launch; it takes a lock, since serving threads launch concurrently and
    `counter[key] += 1` is a read-modify-write."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lock = threading.Lock()

    def add(self, key: str) -> None:
        with self._lock:
            self[key] += 1


def stream_of(x) -> int:
    """The current CUDA stream of CUDA tensor x's device, as the kernels take
    it (the raw handle: `torch.cuda.current_stream()` builds a Stream
    object, a few microseconds a call)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(x.get_device())
    return torch.cuda.current_stream(x.device).cuda_stream


def on_device(x, fn, *args):
    """fn(*args) with CUDA tensor x's device current, so that a launch goes
    to x's card; the device guard (a few microseconds a call) only when
    another device is current (x is a CUDA tensor, so CUDA is
    initialised)."""
    import torch

    if x.get_device() == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(x.device):
        return fn(*args)


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


def build_key(sources: tuple[str, ...], csrc: Path = CSRC_DIR) -> str:
    """The build directory's hash: the names and bytes of `sources`, of every
    `*.cuh` under `csrc` (any source may include any of them) and the nvcc
    flags."""
    h = hashlib.sha256()
    for path in [csrc / src for src in sources] + sorted(csrc.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Compile (if needed) and load `lib<name>.so` from `csrc/<sources>`."""
    if name in _LIBS:
        return _LIBS[name]
    with _LOCKS_LOCK:
        lock = _BUILD_LOCKS[name]
    with lock:
        if name not in _LIBS:
            _build_and_load(name, sources)
    return _LIBS[name]


def _build_and_load(name: str, sources: tuple[str, ...]) -> None:
    so = BUILD_DIR / f"{name}-{build_key(sources)}" / f"lib{name}.so"
    log = so.parent / "build.log"
    seconds = 0.0
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        pid = os.getpid()
        objs = [so.with_name(f"{Path(src).stem}.{pid}.o") for src in sources]
        tmp = so.with_name(f"{so.name}.{pid}.tmp")
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / src)]
                for src, obj in zip(sources, objs)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        outs = [proc.communicate() for proc in procs]
        runs = [(cmd, proc.returncode, *out)
                for cmd, proc, out in zip(cmds, procs, outs)]
        if all(rc == 0 for _, rc, _, _ in runs):
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            runs.append((cmd, proc.returncode, proc.stdout, proc.stderr))
        seconds = time.perf_counter() - t0
        log.write_text("".join(" ".join(cmd) + "\n" + out + err
                               for cmd, _, out, err in runs))
        for obj in objs:
            obj.unlink(missing_ok=True)
        failed = [(cmd, rc, err) for cmd, rc, _, err in runs if rc != 0]
        if failed:
            cmd, rc, err = failed[0]
            raise RuntimeError(
                f"nvcc failed with exit code {rc} building {name} "
                f"({' '.join(cmd[-2:])}):\n{err}"
            )
        os.replace(tmp, so)
    BUILD_INFO[name] = {"seconds": seconds, "log": str(log)}
    _LIBS[name] = ctypes.CDLL(str(so))
