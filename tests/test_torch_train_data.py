"""The port's training input and the pieces the training CLI builds from it
(marigold_tpu_torch.data.loader, data.mixed_sampler, utils.depth_transform,
models.surgery.replace_conv_in_out_multimodal) against the JAX package's
copies, on a fabricated NYU depth tar and a ScanNet-layout directory.

The data copies are framework free, so one seed must give both packages
the same batches, array for array (np.array_equal), with the prefetch
thread and with forked workers, and after skip_first_batches."""

import os
import random
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from marigold_tpu import data as jdata
from marigold_tpu.models import surgery as jsurgery
from marigold_tpu.models.unet import UNetConfig as JUNetConfig
from marigold_tpu.utils import depth_transform as jdt
from marigold_tpu_torch import data as tdata
from marigold_tpu_torch.models import surgery as tsurgery
from marigold_tpu_torch.models.unet import UNetConfig as TUNetConfig
from marigold_tpu_torch.utils import depth_transform as tdt

NORM = {"type": "scale_shift_depth", "clip": True, "norm_min": -1.0,
        "norm_max": 1.0, "min_max_quantile": 0.02}
AUG = {"lr_flip_p": 0.5}


def _depth_png(rng, path, hw, lo_mm, hi_mm):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mm = rng.integers(lo_mm, hi_mm, hw).astype(np.uint16)
    mm[: hw[0] // 4, : hw[1] // 3] = 0  # an invalid block
    Image.fromarray(mm).save(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """base dir with nyu.tar (7 samples, rgb/depth/filled) and a scannet
    directory (5 samples); -> (base, nyu split, scannet split)."""
    base = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    stage = base / "nyu_stage"
    nyu_lines, scannet_lines = [], []
    for i in range(7):
        rel = f"train/room_{i % 3}"
        os.makedirs(stage / rel, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)).save(
            stage / rel / f"rgb_{i:04d}.png")
        _depth_png(rng, str(stage / rel / f"depth_{i:04d}.png"), (24, 32), 500, 9000)
        _depth_png(rng, str(stage / rel / f"filled_{i:04d}.png"), (24, 32), 500, 9000)
        nyu_lines.append(f"{rel}/rgb_{i:04d}.png {rel}/depth_{i:04d}.png "
                         f"{rel}/filled_{i:04d}.png")
    with tarfile.open(base / "nyu.tar", "w") as tar:
        for dp, _, fs in os.walk(stage):
            for fn in fs:
                tar.add(os.path.join(dp, fn),
                        arcname=os.path.relpath(os.path.join(dp, fn), stage))
    for i in range(5):
        rel = f"scene{i}"
        os.makedirs(base / "scannet" / rel, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)).save(
            base / "scannet" / rel / "color.jpg")
        _depth_png(rng, str(base / "scannet" / rel / "depth.png"), (24, 32), 300, 6000)
        scannet_lines.append(f"{rel}/color.jpg {rel}/depth.png")
    (base / "nyu.txt").write_text("\n".join(nyu_lines))
    (base / "scannet.txt").write_text("\n".join(scannet_lines))
    return base


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The forked-worker runs happen in a fresh interpreter that imports only the
# port, bounded by a timeout: a test worker process has run threaded torch,
# JAX and OpenCV code, whose state a fork would carry into the loader's
# workers.
_FORKED = """
import pickle, random, sys
from marigold_tpu_torch import data as tdata
from marigold_tpu_torch.utils import depth_transform as tdt
base, workers, skip, seed, epochs, out = sys.argv[1:]
spec = {"name": "mixed", "dataset_list": [
    {"name": "nyu_depth", "disp_name": "nyu", "dir": "nyu.tar",
     "filenames": base + "/nyu.txt", "eigen_valid_mask": False},
    {"name": "scannet_depth", "disp_name": "scannet", "dir": "scannet",
     "filenames": base + "/scannet.txt"}]}
datasets = tdata.get_dataset(spec, base_data_dir=base, mode=tdata.DatasetMode.TRAIN,
                             augmentation_args=%r,
                             depth_transform=tdt.get_depth_normalizer(%r))
sampler = tdata.MixedBatchSampler(datasets, batch_size=2, shuffle=True,
                                  prob=[0.7, 0.3], generator=random.Random(int(seed)))
loader = tdata.DataLoader(tdata.ConcatDataset(datasets), batch_sampler=sampler,
                          num_workers=int(workers), seed=int(seed))
batches = []
for e in range(int(epochs)):
    if e == 0 and int(skip):
        loader.skip_first_batches(int(skip))
    batches.extend(loader)


class Broken:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        raise KeyError(f"member {i} missing")


try:
    list(tdata.DataLoader(Broken(), batch_size=2, num_workers=int(workers)))
    error = None
except KeyError as e:
    error = str(e)
with open(out, "wb") as f:
    pickle.dump((batches, error), f)
"""


def _forked_batches(base, tmp_path, workers=2, skip=0, seed=2024, epochs=2):
    """The port's batches from a loader with forked workers, in a fresh
    interpreter (bounded by a timeout); -> (batches, the error message a
    failing dataset raised through the workers)."""
    import pickle
    import subprocess
    import sys

    out = tmp_path / f"forked_{workers}_{skip}.pkl"
    subprocess.run([sys.executable, "-c", _FORKED % (AUG, NORM), str(base),
                    str(workers), str(skip), str(seed), str(epochs), str(out)],
                   cwd=REPO, check=True, timeout=120)
    with open(out, "rb") as f:
        return pickle.load(f)


def _mixed(pkg, dt, base):
    """The training CLI's mixed dataset on both trees, in one package."""
    spec = {"name": "mixed", "dataset_list": [
        {"name": "nyu_depth", "disp_name": "nyu", "dir": "nyu.tar",
         "filenames": str(base / "nyu.txt"), "eigen_valid_mask": False},
        {"name": "scannet_depth", "disp_name": "scannet", "dir": "scannet",
         "filenames": str(base / "scannet.txt")}]}
    return pkg.get_dataset(spec, base_data_dir=str(base),
                           mode=pkg.DatasetMode.TRAIN, augmentation_args=AUG,
                           depth_transform=dt.get_depth_normalizer(NORM))


def _batches(pkg, dt, base, workers, skip=0, seed=2024, epochs=2):
    datasets = _mixed(pkg, dt, base)
    sampler = pkg.MixedBatchSampler(datasets, batch_size=2, shuffle=True,
                                    prob=[0.7, 0.3], generator=random.Random(seed))
    loader = pkg.DataLoader(pkg.ConcatDataset(datasets), batch_sampler=sampler,
                            num_workers=workers, seed=seed)
    out = []
    for e in range(epochs):
        if e == 0 and skip:
            loader.skip_first_batches(skip)
        out.extend(loader)
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), i
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, (i, k)
                assert np.array_equal(g[k], w[k], equal_nan=True), (i, k)
            else:
                assert g[k] == w[k], (i, k)


@pytest.fixture(scope="module")
def jax_stream(trees):
    return _batches(jdata, jdt, trees, workers=0)


def test_sampler_gives_the_jax_index_batches(trees):
    jds, tds = _mixed(jdata, jdt, trees), _mixed(tdata, tdt, trees)
    for prob in ([0.7, 0.3], None):
        js = jdata.MixedBatchSampler(jds, 2, prob=prob, generator=random.Random(5))
        ts = tdata.MixedBatchSampler(tds, 2, prob=prob, generator=random.Random(5))
        assert len(ts) == len(js) == 3 + 2
        for _ in range(3):  # epochs: the per-dataset queues carry over
            assert list(ts) == list(js)
    jc, tc = jdata.ConcatDataset(jds), tdata.ConcatDataset(tds)
    assert tc.cumulative_sizes == jc.cumulative_sizes == [7, 12]
    with pytest.raises(IndexError):
        tc[12]


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_gives_the_jax_batches(trees, jax_stream, workers, tmp_path):
    """Two epochs of the seeded mixed loader, the port's with the prefetch
    thread (0) or 2 forked workers reading one tar, against the JAX
    loader's thread: the same arrays."""
    got = (_batches(tdata, tdt, trees, workers) if workers == 0
           else _forked_batches(trees, tmp_path, workers)[0])
    _assert_same_batches(got, jax_stream)


@pytest.mark.parametrize("workers", [0, 2])
def test_skip_first_batches_resumes_the_jax_stream(trees, workers, tmp_path):
    """A resumed epoch (skip_first_batches) replays the batches and
    augmentation seeds the uninterrupted run used, in both packages."""
    want = _batches(jdata, jdt, trees, workers=0, skip=3, epochs=1)
    got = (_batches(tdata, tdt, trees, workers, skip=3, epochs=1) if workers == 0
           else _forked_batches(trees, tmp_path, workers, skip=3, epochs=1)[0])
    _assert_same_batches(got, want)
    full = _batches(tdata, tdt, trees, workers=0, epochs=1)
    _assert_same_batches(want, full[3:])


def test_loader_shards_and_errors_like_jax(trees, tmp_path):
    tds = tdata.ConcatDataset(_mixed(tdata, tdt, trees))
    jds = jdata.ConcatDataset(_mixed(jdata, jdt, trees))
    for shard in range(2):
        got = list(tdata.DataLoader(tds, batch_size=2, shuffle=True, seed=3,
                                    shard_count=2, shard_index=shard))
        want = list(jdata.DataLoader(jds, batch_size=2, shuffle=True, seed=3,
                                     shard_count=2, shard_index=shard))
        _assert_same_batches(got, want)
    with pytest.raises(ValueError, match="shard_index"):
        tdata.DataLoader(tds, shard_count=2, shard_index=2)

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"member {i} missing")

    # a loader error reaches the consumer, from the thread and the workers
    with pytest.raises(KeyError, match="member"):
        list(tdata.DataLoader(Broken(), batch_size=2))
    assert "member 0 missing" in _forked_batches(trees, tmp_path, epochs=0)[1]


def test_depth_normalizer_copy_and_normalize_torch_match_jax():
    rng = np.random.default_rng(1)
    jn, tn = jdt.get_depth_normalizer(NORM), tdt.get_depth_normalizer(NORM)
    for shape, clip in (((40, 56), None), ((3, 17, 23, 1), False)):
        d = rng.uniform(0, 12, shape).astype(np.float32)
        d[..., :4] = 0  # invalid: not > 0
        mask = rng.uniform(size=shape) > 0.3
        for m in (mask, None):
            assert np.array_equal(tn(d, m, clip=clip), jn(d, m, clip=clip))
            ref = np.asarray(jn.normalize_jax(
                jnp.asarray(d), None if m is None else jnp.asarray(m), clip=clip))
            got = tn.normalize_torch(
                torch.from_numpy(d), None if m is None else torch.from_numpy(m),
                clip=clip).numpy()
            # fp32, the same sort and interpolation: atol 1e-6
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    empty = np.zeros((4, 5), np.float32)
    assert np.array_equal(tn(empty), jn(empty))
    assert tdt.get_depth_normalizer(None)(d) is d


@pytest.mark.parametrize("n_targets", [2, 3])
def test_multimodal_surgery_matches_jax(n_targets):
    """IID surgery on OIHW weights against the JAX package's on HWIO: bit
    for bit after transposition; the same ValueError on a widened UNet."""
    rng = np.random.default_rng(n_targets)
    w_in = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)  # HWIO
    w_out = rng.standard_normal((3, 3, 8, 4)).astype(np.float32)
    b_in = rng.standard_normal(8).astype(np.float32)
    b_out = rng.standard_normal(4).astype(np.float32)
    jparams = {"conv_in": {"weight": jnp.asarray(w_in), "bias": jnp.asarray(b_in)},
               "conv_out": {"weight": jnp.asarray(w_out), "bias": jnp.asarray(b_out)}}
    oihw = lambda w: torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # noqa: E731
    sd = {"conv_in.weight": oihw(w_in), "conv_in.bias": torch.from_numpy(b_in),
          "conv_out.weight": oihw(w_out), "conv_out.bias": torch.from_numpy(b_out)}
    jcfg, jout = jsurgery.replace_conv_in_out_multimodal(
        JUNetConfig(in_channels=4, out_channels=4), jparams, n_targets, 4)
    tcfg, tout = tsurgery.replace_conv_in_out_multimodal(
        TUNetConfig(in_channels=4, out_channels=4), sd, n_targets, 4)
    assert (tcfg.in_channels, tcfg.out_channels) == \
        (jcfg.in_channels, jcfg.out_channels) == (4 * (n_targets + 1), 4 * n_targets)
    for layer in ("conv_in", "conv_out"):
        w = np.asarray(jout[layer]["weight"]).transpose(3, 2, 0, 1)
        assert np.array_equal(tout[f"{layer}.weight"].numpy(), w), layer
        assert np.array_equal(tout[f"{layer}.bias"].numpy(),
                              np.asarray(jout[layer]["bias"])), layer
    assert torch.equal(sd["conv_in.weight"], oihw(w_in))  # input untouched
    with pytest.raises(ValueError, match="not a multiple of conv_out") as t_err:
        tsurgery.replace_conv_in_out_multimodal(tcfg, tout, 2 * n_targets + 1, 4)
    with pytest.raises(ValueError, match="not a multiple of conv_out") as j_err:
        jsurgery.replace_conv_in_out_multimodal(jcfg, jout, 2 * n_targets + 1, 4)
    assert str(t_err.value) == str(j_err.value)
