"""Python binding of the native indexed tar reader (`native/tario.cc`).

Copy of `marigold_tpu/data/tario.py` for the PyTorch port (framework free).
The reader scans an archive once into a name -> (offset, size) index and
serves members with positioned reads (pread): lock-free, thread-safe, and
safe across a fork, since no file offset is shared. The dataset bases
(`base_depth.py`, `base_normals.py`, `base_iid.py`) open every tar through
`TarIndex`, as the JAX bases do.

One difference: the library is built by g++ at first use into
`marigold_tpu_torch/_build/tario-<hash of the source>/libtario.so` (the
git-ignored build directory of the port's CUDA kernels), not beside the
source, and written under a temporary name that is renamed into place, so
that concurrent first uses never load a half-written file. Without g++, or
when the build fails, `TarIndex` reads through Python's tarfile behind a
lock, as in the JAX package; that fallback is logged as a warning, and
`TarIndex.native` says which reader an archive got.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tarfile
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "tario.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"tario-{h.hexdigest()[:16]}" / "libtario.so"


def _build(so: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("no g++ on PATH")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, cp, n = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long
    lib.tario_open.restype, lib.tario_open.argtypes = p, [cp]
    lib.tario_count.restype, lib.tario_count.argtypes = n, [p]
    lib.tario_member_size.restype, lib.tario_member_size.argtypes = n, [p, cp]
    lib.tario_read.restype = n
    lib.tario_read.argtypes = [p, cp, ctypes.POINTER(ctypes.c_ubyte), n]
    lib.tario_names.restype, lib.tario_names.argtypes = n, [p, cp, n]
    lib.tario_close.restype, lib.tario_close.argtypes = None, [p]
    return lib


def load_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None (logged once) when it
    cannot be built or loaded."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is None and not _build_failed:
            so = library_path()
            try:
                if not so.exists():
                    _build(so)
                _lib = _bind(ctypes.CDLL(str(so)))
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", None) or e
                logger.warning("the native tar reader is unavailable (%s); "
                               "reading tars through tarfile", detail)
                _build_failed = True
    return _lib


class TarIndex:
    """Indexed tar reader: read(name) -> bytes, names(), len(). Thread-safe.
    Member names match with or without a leading "./"."""

    def __init__(self, path: str):
        self.path = path
        self._lib = None
        self._handle = None
        self._pytar = None
        self._pytar_lock = threading.Lock()
        lib = load_lib()
        if lib is not None:
            h = lib.tario_open(path.encode())
            if h:
                self._lib, self._handle = lib, ctypes.c_void_p(h)
            else:
                logger.warning("tario_open failed for %s; reading it through "
                               "tarfile", path)
        if self._handle is None:
            self._pytar = tarfile.open(path)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __len__(self) -> int:
        if self.native:
            return int(self._lib.tario_count(self._handle))
        return len(self._pytar.getmembers())

    def names(self) -> list[str]:
        if self.native:
            cap = 1 << 20
            while True:
                buf = ctypes.create_string_buffer(cap)
                n = self._lib.tario_names(self._handle, buf, cap)
                if n >= 0:
                    return buf.raw[:n].decode().splitlines()
                cap = -n + 1
        return [m.name for m in self._pytar.getmembers()]

    def read(self, name: str) -> bytes:
        if self.native:
            size = self._lib.tario_member_size(self._handle, name.encode())
            if size < 0:
                raise KeyError(f"{name} not in {self.path}")
            buf = (ctypes.c_ubyte * size)()
            n = self._lib.tario_read(self._handle, name.encode(), buf, size)
            if n != size:
                raise OSError(f"tario_read({name}) -> {n}")
            return bytes(buf)
        with self._pytar_lock:
            for candidate in (name, "./" + name.lstrip("./"), name.lstrip("./")):
                try:
                    member = self._pytar.extractfile(candidate)
                except KeyError:
                    continue
                if member is not None:
                    return member.read()
            raise KeyError(name)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tario_close(self._handle)
            self._handle = None
        if self._pytar is not None:
            self._pytar.close()
            self._pytar = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None or \
                getattr(self, "_pytar", None) is not None:
            self.close()
