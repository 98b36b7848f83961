"""The port's copies of the JAX package's framework-free modules
(marigold_tpu_torch/eval/metrics.py, eval/alignment.py, config.py) give
the same results as the originals. They are numpy/pyyaml code copied so
that the port imports no part of the JAX package; the results must be
equal, not merely close."""

import numpy as np
import pytest

from marigold_tpu import config as jconfig
from marigold_tpu.eval import alignment as jalign
from marigold_tpu.eval import metrics as jmetrics
from marigold_tpu_torch import config as tconfig
from marigold_tpu_torch.eval import alignment as talign
from marigold_tpu_torch.eval import metrics as tmetrics


def _depth_case(seed=0, shape=(2, 24, 32)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 10.0, shape).astype(np.float32)
    pred = (gt * rng.uniform(0.8, 1.2, shape)).astype(np.float32)
    valid = rng.uniform(size=shape) > 0.2
    return pred, gt, valid


@pytest.mark.parametrize("name", sorted(jmetrics.DEPTH_METRICS))
def test_depth_metrics_copy_agrees(name):
    assert sorted(tmetrics.DEPTH_METRICS) == sorted(jmetrics.DEPTH_METRICS)
    pred, gt, valid = _depth_case()
    for mask in (valid, None):
        assert float(tmetrics.DEPTH_METRICS[name](pred, gt, mask)) == \
            float(jmetrics.DEPTH_METRICS[name](pred, gt, mask))


@pytest.mark.parametrize("name", sorted(jmetrics.NORMALS_METRICS))
def test_normals_metrics_copy_agrees(name):
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((20, 24, 3))
    gt = rng.standard_normal((20, 24, 3))
    err_t = tmetrics.compute_cosine_error(pred, gt, masked=True)
    err_j = jmetrics.compute_cosine_error(pred, gt, masked=True)
    np.testing.assert_array_equal(err_t, err_j)
    assert float(tmetrics.NORMALS_METRICS[name](err_t)) == \
        float(jmetrics.NORMALS_METRICS[name](err_j))


def test_iid_metrics_and_tracker_copy_agree():
    rng = np.random.default_rng(2)
    pred = rng.uniform(0, 1, (24, 32, 3))
    gt = rng.uniform(0, 1, (24, 32, 3))
    for fn in ("psnr", "ssim"):
        assert float(getattr(tmetrics, fn)(pred, gt)) == \
            float(getattr(jmetrics, fn)(pred, gt))
    for target in ("albedo", "shading"):
        assert tmetrics.compute_iid_metric(pred, gt, target, tmetrics.psnr) == \
            jmetrics.compute_iid_metric(pred, gt, target, jmetrics.psnr)
    trackers = tmetrics.MetricTracker("a", "b"), jmetrics.MetricTracker("a", "b")
    for t in trackers:
        for i, v in enumerate((0.5, 0.25, 2.0)):
            t.update("a", v)
            t.update("b", v * i, n=2)
    assert trackers[0].result() == trackers[1].result()


@pytest.mark.parametrize("max_resolution", [None, 16])
def test_alignment_copy_agrees(max_resolution):
    pred, gt, valid = _depth_case(3, (24, 32))
    got = talign.align_depth_least_square(gt, pred / 7.0 + 0.3, valid,
                                          max_resolution=max_resolution)
    want = jalign.align_depth_least_square(gt, pred / 7.0 + 0.3, valid,
                                           max_resolution=max_resolution)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    disp_t, mask_t = talign.depth2disparity(gt, return_mask=True)
    disp_j, mask_j = jalign.depth2disparity(gt, return_mask=True)
    np.testing.assert_array_equal(disp_t, disp_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(talign.disparity2depth(disp_t),
                                  jalign.disparity2depth(disp_j))


def test_config_copy_agrees():
    path = "config/train_marigold_depth.yaml"
    t, j = tconfig.recursive_load_config(path), jconfig.recursive_load_config(path)
    assert t.to_dict() == j.to_dict()
    assert t.lr_scheduler.kwargs.total_iter == j.lr_scheduler.kwargs.total_iter
    assert list(tconfig.find_value(t, "name")) == list(jconfig.find_value(j, "name"))
    override = {"trainer": {"init_seed": 7}, "lr": 1.0}
    assert tconfig.merge_configs(t, override).to_dict() == \
        jconfig.merge_configs(j, override).to_dict()
