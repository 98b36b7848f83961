"""The port's copies of the preprocessing entry points against the JAX package's:
both write the same files, byte for byte, from the scenes that
tests/test_preprocess.py fabricates (Hypersim HDF5 trees for the depth,
normals and IID frames, InteriorVerse EXR scenes for the normals frames and
the IID tar)."""

import os
import tarfile

import numpy as np
import pytest

from marigold_tpu.data.exr import write_exr
from marigold_tpu.preprocess import hypersim as jhs
from marigold_tpu.preprocess import interiorverse as jiv
from marigold_tpu_torch.preprocess import hypersim as ths
from marigold_tpu_torch.preprocess import interiorverse as tiv
import test_preprocess
from test_preprocess import _H, _W, _make_scene, _write_csv


def _tree(root) -> dict:
    """relative path -> bytes of every file under root."""
    files = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


def _assert_same_tree(a, b, min_files: int) -> None:
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    assert len(ta) >= min_files
    for rel in ta:
        assert ta[rel] == tb[rel], rel


@pytest.mark.parametrize("task", ["depth", "normals", "iid"])
def test_hypersim_preprocessing_writes_the_same_files(tmp_path, task, monkeypatch):
    rng = np.random.default_rng(0)
    if task == "depth":  # the distance-to-depth conversion is for 768x1024
        monkeypatch.setattr(test_preprocess, "_H", 768)
        monkeypatch.setattr(test_preprocess, "_W", 1024)
    raw = tmp_path / "raw"
    scene = "ai_001_001"
    if task == "iid":
        # frame 1's albedo is out of range: rejected with a marker file
        _make_scene(str(raw), scene, frames=(0, 1), task="iid", rng=rng,
                    bad_albedo=(1,))
    else:
        # frame 1 has a NaN normal: the normals task skips it
        _make_scene(str(raw), scene, frames=(0, 1), task="normals", rng=rng,
                    nan_normals=(1,))
    _write_csv(str(tmp_path / "split.csv"), [
        (scene, "cam_00", 0, "True", "train"),
        (scene, "cam_00", 1, "True", "val"),
        (scene, "cam_00", 2, "True", "train"),   # missing: skipped
        (scene, "cam_00", 0, "False", "test"),   # not public: dropped
    ])
    outs = {}
    for name, main in (("jax", jhs.main), ("port", ths.main)):
        outs[name] = tmp_path / name
        assert main(["--task", task, "--split_csv", str(tmp_path / "split.csv"),
                     "--dataset_dir", str(raw),
                     "--output_dir", str(outs[name])]) == 0
    # depth: 2 frames x (rgb, depth) + 2 lists; normals: 1 frame x 2 + list;
    # iid: 1 frame x 5 + the reject marker + list
    _assert_same_tree(outs["jax"], outs["port"],
                      {"depth": 6, "normals": 3, "iid": 7}[task])


def test_interiorverse_normals_writes_the_same_files(tmp_path):
    rng = np.random.default_rng(1)
    scene = tmp_path / "raw" / "scenes_85" / "L3D001"
    scene.mkdir(parents=True)
    rgb = rng.uniform(0, 2.0, (_H, _W, 3)).astype(np.float32)
    n = rng.normal(size=(_H, _W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    bad = n.copy()
    bad[0, 0] = 0  # an invalid normal: frame 001 is skipped
    nan_rgb = rgb.copy()
    nan_rgb[0, 0, 0] = np.nan  # frame 002 keeps its normals, no png
    for fid, im, nm in (("000", rgb, 0.5 * n), ("001", rgb, bad),
                        ("002", nan_rgb, n)):
        write_exr(str(scene / f"{fid}_im.exr"), im)
        write_exr(str(scene / f"{fid}_normal.exr"), nm)
    lines = {}
    for name, fn in (("jax", jiv.preprocess_normals),
                     ("port", tiv.preprocess_normals)):
        os.makedirs(tmp_path / name)
        lines[name] = fn(str(tmp_path / "raw"), str(tmp_path / name))
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 2
    _assert_same_tree(tmp_path / "jax", tmp_path / "port", 4)


def test_interiorverse_packing_writes_the_same_tar(tmp_path):
    for scene_name, fids in (("L3D001", ("000", "001")), ("L3D002", ("000",))):
        scene = tmp_path / "raw" / scene_name
        scene.mkdir(parents=True)
        for fid in fids:
            for kind in ("im", "albedo", "material", "mask"):
                (scene / f"{fid}_{kind}.exr").write_bytes(
                    f"{scene_name}/{fid}/{kind}".encode())
    # an incomplete frame (no mask) is left out of both
    for kind in ("im", "albedo", "material"):
        (tmp_path / "raw" / "L3D001" / f"002_{kind}.exr").write_bytes(b"x")
    lines, members = {}, {}
    for name, fn in (("jax", jiv.pack_scenes), ("port", tiv.pack_scenes)):
        tar_path = str(tmp_path / f"{name}.tar")
        lines[name] = fn(str(tmp_path / "raw"), tar_path)
        with tarfile.open(tar_path) as tar:
            members[name] = [(m.name, m.size, tar.extractfile(m).read())
                             for m in tar.getmembers() if m.isfile()]
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 3
    assert members["port"] == members["jax"] and len(members["jax"]) == 12


def test_the_entry_points_are_kept():
    assert callable(ths.main) and callable(tiv.main)
    for mod in (ths, tiv):
        with open(mod.__file__) as f:
            assert 'if __name__ == "__main__":' in f.read()
