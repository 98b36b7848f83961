"""The port's copy of the eval data layer (marigold_tpu_torch/data) against
the JAX package's (marigold_tpu/data): on fabricated dataset trees built by
tests/test_benchmark_protocol.py's builders from the shipped configs and
split lists, every sample of every benchmark dataset, in EVAL and RGB_ONLY
mode, must give identical arrays (np.array_equal) and identical other
values. One NYU tree is also packed as a tar archive, which the port reads
with tarfile and the JAX package with its indexed tar reader; and the EXR
codec copies must agree bit for bit."""

import os
import tarfile

import numpy as np
import pytest

from marigold_tpu import data as jdata
from marigold_tpu.config import recursive_load_config
from marigold_tpu.data import exr as jexr
from marigold_tpu_torch import data as tdata
from marigold_tpu_torch.data import exr as texr
from marigold_tpu_torch.data import tario
from test_benchmark_protocol import BENCHES, REPO, _split_lines
from marigold_tpu.cli.benchmark import PROTOCOLS

MODES = ("EVAL", "RGB_ONLY")


def _datasets(cfg_path, base, mode):
    cfg = recursive_load_config(os.path.join(REPO, cfg_path))["dataset"]
    cfg = dict(cfg, filenames=os.path.join(REPO, cfg["filenames"]))
    return (jdata.get_dataset(cfg, base, getattr(jdata.DatasetMode, mode)),
            tdata.get_dataset(cfg, base, getattr(tdata.DatasetMode, mode)))


def _assert_same_samples(jds, tds, n):
    assert len(jds) == len(tds) >= n
    assert type(tds).__name__ == type(jds).__name__
    jds.filenames, tds.filenames = jds.filenames[:n], tds.filenames[:n]
    for i in range(n):
        ref, got = jds[i], tds[i]
        assert sorted(got) == sorted(ref)
        for key, r in ref.items():
            g = got[key]
            if isinstance(r, np.ndarray):
                assert isinstance(g, np.ndarray) and g.dtype == r.dtype, key
                assert np.array_equal(g, r, equal_nan=r.dtype.kind == "f"), key
            else:
                assert g == r, key


CASES = [(m, b, builder, n) for m, b, builder, _, n, _ in BENCHES]


@pytest.mark.parametrize("modality,bench,builder,n", CASES,
                         ids=[f"{m}-{b}" for m, b, *_ in CASES])
def test_dataset_samples_match_jax(tmp_path, modality, bench, builder, n):
    cfg_path = PROTOCOLS[modality][bench][0]
    ds_dir, lines = _split_lines(cfg_path, n)
    base = str(tmp_path / "base")
    builder(os.path.join(base, ds_dir), lines, np.random.default_rng(0))
    for mode in MODES:
        _assert_same_samples(*_datasets(cfg_path, base, mode), n)


def test_nyu_tar_archive_matches_jax(tmp_path):
    """The NYU tree packed as the tar its config names: both packages read
    the members, and the port's copy reads them with its native reader."""
    from test_benchmark_protocol import build_depth_nyu

    cfg_path = PROTOCOLS["depth"]["nyu"][0]
    ds_dir, lines = _split_lines(cfg_path, 2)
    tree = str(tmp_path / "tree")
    build_depth_nyu(tree, lines, np.random.default_rng(1))
    base = str(tmp_path / "base")
    archive = os.path.join(base, ds_dir)
    assert archive.endswith(".tar")
    os.makedirs(os.path.dirname(archive))
    with tarfile.open(archive, "w") as tar:
        for name in sorted(os.listdir(tree)):
            tar.add(os.path.join(tree, name), arcname=name)
    for mode in MODES:
        jds, tds = _datasets(cfg_path, base, mode)
        assert tds.is_tar and jds.is_tar
        _assert_same_samples(jds, tds, 2)
        assert isinstance(tds.tar_obj, tario.TarIndex) and tds.tar_obj.native


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_exr_codec_matches_jax(tmp_path, dtype):
    img = np.random.default_rng(2).uniform(-1, 3, (17, 23, 3)).astype(dtype)
    a, b = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jexr.write_exr(a, img)
    texr.write_exr(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        data = fa.read()
        assert fb.read() == data
    ref, got = jexr.read_exr(data), texr.read_exr(data)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
