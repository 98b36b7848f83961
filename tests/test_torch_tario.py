"""The port's native tar reader (`marigold_tpu_torch/data/tario.py` with
`native/tario.cc`) against Python's tarfile and the JAX package's
`TarIndex` on fabricated tars (as tests/test_tario.py does for JAX): member
bytes and names, both spellings of a name, a missing member, concurrent
reads, the build directory, the logged tarfile fallback; and the training
loader's batches identical with either reader, with forked workers too."""

import logging
import os
import pickle
import subprocess
import sys
import tarfile
import threading

import numpy as np
import pytest
from PIL import Image

from marigold_tpu.data.tario import TarIndex as JTarIndex
from marigold_tpu_torch import data as tdata
from marigold_tpu_torch.data import tario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def sample_tar(tmp_path):
    rng = np.random.default_rng(0)
    files = {
        "a.bin": rng.integers(0, 255, 1000, dtype=np.uint8).tobytes(),
        "dir/b.bin": rng.integers(0, 255, 513, dtype=np.uint8).tobytes(),  # pad
        "dir/sub/" + "x" * 120 + ".bin": b"longname-content",  # GNU longname
        "empty.bin": b"",
        "big.bin": rng.integers(0, 255, 70000, dtype=np.uint8).tobytes(),
    }
    src = tmp_path / "src"
    tar_path = str(tmp_path / "t.tar")
    with tarfile.open(tar_path, "w", format=tarfile.GNU_FORMAT) as tar:
        for name, data in files.items():
            p = src / name
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)
            tar.add(str(p), arcname="./" + name)
    return tar_path, files


def _tarfile_only(monkeypatch):
    """The reader as it is where the native library cannot build."""
    monkeypatch.setattr(tario, "_lib", None)
    monkeypatch.setattr(tario, "_build_failed", True)


def test_native_library_builds_into_the_build_dir():
    assert tario.load_lib() is not None
    so = tario.library_path()
    assert so.is_file() and so.parent.parent == tario.BUILD_DIR
    assert so.parent.name.startswith("tario-")


def test_members_and_names_match_tarfile_and_the_jax_reader(sample_tar):
    tar_path, files = sample_tar
    idx, jidx = tario.TarIndex(tar_path), JTarIndex(tar_path)
    assert idx.native and jidx.native
    with tarfile.open(tar_path) as tar:
        members = [m for m in tar.getmembers() if m.isfile()]
        assert len(idx) == len(members) == len(jidx)
        want_names = sorted(m.name.removeprefix("./") for m in members)
        for m in members:
            data = tar.extractfile(m).read()
            name = m.name.removeprefix("./")
            assert idx.read(name) == data == jidx.read(name)
            assert idx.read("./" + name) == data  # both spellings
    assert sorted(n.removeprefix("./") for n in idx.names()) == want_names
    assert idx.names() == jidx.names()
    assert {n.removeprefix("./") for n in idx.names()} == set(files)
    idx.close()
    jidx.close()


@pytest.mark.parametrize("native", [True, False])
def test_missing_member_and_concurrent_reads(sample_tar, native, monkeypatch):
    if not native:
        _tarfile_only(monkeypatch)
    tar_path, files = sample_tar
    idx = tario.TarIndex(tar_path)
    assert idx.native is native
    with pytest.raises(KeyError):
        idx.read("nope.bin")
    errors = []

    def worker():
        try:
            for _ in range(30):
                for name, data in files.items():
                    assert idx.read(name) == data
        except Exception as e:  # the assertion reaches the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    idx.close()


def test_without_gxx_the_fallback_is_tarfile_and_logged(sample_tar, tmp_path,
                                                       monkeypatch, caplog):
    """No g++ and no built library: a warning, then tarfile's bytes."""
    tar_path, files = sample_tar
    monkeypatch.setattr(tario, "_lib", None)
    monkeypatch.setattr(tario, "_build_failed", False)
    monkeypatch.setattr(tario, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tario.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING, logger=tario.__name__):
        idx = tario.TarIndex(tar_path)
    assert not idx.native
    assert "through tarfile" in caplog.text and "g++" in caplog.text
    for name, data in files.items():
        assert idx.read(name) == data
    idx.close()


# ---------------------------------------------------------------------- #
# the training loader on a NYU depth tar, either reader

NORM = {"type": "scale_shift_depth", "clip": True, "norm_min": -1.0,
        "norm_max": 1.0, "min_max_quantile": 0.02}

_LOADER = """
import pickle, sys
from marigold_tpu_torch import data as tdata
from marigold_tpu_torch.data import tario
from marigold_tpu_torch.utils import depth_transform as tdt
base, split, native, workers, out = sys.argv[1:]
if native == "0":
    tario._build_failed = True
ds = tdata.get_dataset(
    {"name": "nyu_depth", "disp_name": "nyu", "dir": "nyu.tar",
     "filenames": split, "eigen_valid_mask": False},
    base_data_dir=base, mode=tdata.DatasetMode.TRAIN,
    augmentation_args={"lr_flip_p": 0.5},
    depth_transform=tdt.get_depth_normalizer(%r))
ds[0]  # the parent opens the archive before the workers fork
loader = tdata.DataLoader(ds, batch_size=2, shuffle=True, seed=7,
                          num_workers=int(workers))
batches = list(loader) + list(loader)
with open(out, "wb") as f:
    pickle.dump((batches, ds.tar_obj.native), f)
"""


@pytest.fixture(scope="module")
def nyu_tar(tmp_path_factory):
    base = tmp_path_factory.mktemp("tario_data")
    rng = np.random.default_rng(1)
    stage, lines = base / "stage", []
    for i in range(6):
        rel = f"train/room_{i % 2}"
        os.makedirs(stage / rel, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)).save(
            stage / rel / f"rgb_{i}.png")
        for kind in ("depth", "filled"):
            Image.fromarray(rng.integers(500, 9000, (24, 32)).astype(np.uint16)
                            ).save(stage / rel / f"{kind}_{i}.png")
        lines.append(f"{rel}/rgb_{i}.png {rel}/depth_{i}.png {rel}/filled_{i}.png")
    with tarfile.open(base / "nyu.tar", "w") as tar:
        tar.add(str(stage / "train"), arcname="train")
    (base / "split.txt").write_text("\n".join(lines))
    return base


def _loader_batches(base, tmp_path, native: bool, workers: int):
    """Two epochs of the loader's batches in a fresh interpreter (a fork
    from a test process that ran threaded torch or JAX code can hang),
    bounded by a timeout; -> (batches, whether the reader was native)."""
    out = tmp_path / f"batches_{int(native)}_{workers}.pkl"
    subprocess.run([sys.executable, "-c", _LOADER % (NORM,), str(base),
                    str(base / "split.txt"), str(int(native)), str(workers),
                    str(out)], cwd=REPO, check=True, timeout=120)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_are_the_same_with_either_reader(nyu_tar, tmp_path,
                                                       workers):
    native, was_native = _loader_batches(nyu_tar, tmp_path, True, workers)
    plain, was_plain = _loader_batches(nyu_tar, tmp_path, False, workers)
    assert was_native and not was_plain
    assert len(native) == len(plain) == 6
    for i, (a, b) in enumerate(zip(native, plain)):
        assert a.keys() == b.keys(), i
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert np.array_equal(a[k], b[k], equal_nan=True), (i, k)
            else:
                assert a[k] == b[k], (i, k)


def test_the_fork_guard_keeps_only_the_native_reader(nyu_tar, monkeypatch):
    """The loader's fork guard closes a tarfile reader (its file offset is
    shared across the fork) and keeps a native one (pread)."""
    from marigold_tpu_torch.data import loader

    ds = tdata.get_dataset(
        {"name": "nyu_depth", "disp_name": "nyu", "dir": "nyu.tar",
         "filenames": str(nyu_tar / "split.txt"), "eigen_valid_mask": False},
        base_data_dir=str(nyu_tar), mode=tdata.DatasetMode.EVAL)
    ds[0]
    reader = ds.tar_obj
    assert reader.native
    loader._reset_inherited_io(ds)
    assert ds.tar_obj is reader
    _tarfile_only(monkeypatch)
    ds.tar_obj = tario.TarIndex(str(nyu_tar / "nyu.tar"))
    assert not ds.tar_obj.native
    loader._reset_inherited_io(ds)
    assert ds.tar_obj is None
