"""The port's infer -> eval -> benchmark harness against the JAX package's
(CPU, `--device cpu`), and the switches it reads: the parity pins, the
decode cap, the import-time flash-softmax mode, LPIPS and the Spectral
colour table.

Tolerances: the port's eval on the port's predictions gives exactly (to the
byte) the metrics CSV and summary that the JAX eval gives on the same
predictions; LPIPS within LPIPS_ATOL = 1e-5 of the JAX module on one weight
file; the Spectral table within 1/255 of matplotlib's on a 4096-value
ramp."""

import os
import subprocess
import sys

import numpy as np
import pytest

from fixtures import make_tiny_checkpoint
from marigold_tpu.cli.benchmark import PROTOCOLS as JAX_PROTOCOLS
from marigold_tpu.cli.eval import main as jax_eval
from marigold_tpu_torch.cli import benchmark as tbench
from marigold_tpu_torch.cli.eval import main as torch_eval
from marigold_tpu_torch.cli.infer import main as torch_infer
from marigold_tpu_torch.ops import attention as tattn
from marigold_tpu_torch.pipelines import base as tbase
from test_benchmark_protocol import REPO, _split_lines, build_depth_nyu

LPIPS_ATOL = 1e-5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_checkpoint(str(tmp_path_factory.mktemp("depth")),
                                mode="depth")


@pytest.fixture(scope="module")
def nyu(tmp_path_factory):
    """base_data_dir holding two fabricated 480x640 NYU samples at the paths
    of the shipped split list."""
    base = tmp_path_factory.mktemp("base")
    ds_dir, lines = _split_lines(JAX_PROTOCOLS["depth"]["nyu"][0], 2)
    build_depth_nyu(str(base / ds_dir), lines, np.random.default_rng(0))
    return str(base)


@pytest.fixture
def restore_softmax(monkeypatch):
    monkeypatch.setenv("MARIGOLD_TPU_FLASH_SOFTMAX", "shifted")
    before = tattn.get_flash_softmax()
    yield
    tattn.set_flash_softmax(before)


def test_registry_is_the_jax_one():
    assert tbench.PROTOCOLS == JAX_PROTOCOLS
    from marigold_tpu.cli.benchmark import DEFAULTS

    assert tbench.DEFAULTS == DEFAULTS


def test_infer_then_eval_gives_the_jax_metrics(ckpt, nyu, tmp_path):
    """Port infer writes the reference's prediction names; the port's eval
    on them writes byte-identical CSV and summary files to the JAX eval's."""
    cfg = os.path.join(REPO, JAX_PROTOCOLS["depth"]["nyu"][0])
    pred = tmp_path / "pred"
    assert torch_infer([
        "--checkpoint", ckpt, "--dataset_config", cfg, "--base_data_dir", nyu,
        "--output_dir", str(pred), "--denoise_steps", "1",
        "--ensemble_size", "2", "--processing_res", "64", "--seed", "1234",
        "--limit", "2", "--serving_batch", "2", "--device", "cpu"]) == 0
    preds = sorted(os.listdir(pred / "depth_npy"))
    # scene prefix + the rgb_id naming mode (test/kitchen_0004/rgb_0001.png)
    assert preds == ["test_kitchen_0004_pred_0001.npy",
                     "test_kitchen_0004_pred_0002.npy"]
    p = np.load(pred / "depth_npy" / preds[0])
    assert p.shape == (480, 640) and 0 <= p.min() <= p.max() <= 1
    outs = {}
    for name, fn in (("jax", jax_eval), ("torch", torch_eval)):
        out = tmp_path / name
        assert fn(["--modality", "depth", "--dataset_config", cfg,
                   "--base_data_dir", nyu, "--prediction_dir",
                   str(pred / "depth_npy"), "--output_dir", str(out),
                   "--limit", "2"]) == 0
        outs[name] = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
    assert list(outs["torch"]) == ["eval_metrics-least_square.txt",
                                   "per_sample_metrics.csv"]
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"]["per_sample_metrics.csv"].splitlines()) == 3


def _benchmark(ckpt, nyu, out, monkeypatch, extra):
    calls = []
    real = tbase.ensemble_depth

    def spy(depth, **kw):
        calls.append((kw.get("reg_max_res"), kw.get("gauge_anchor")))
        return real(depth, **kw)

    monkeypatch.setattr(tbase, "ensemble_depth", spy)
    monkeypatch.chdir(REPO)  # the registry's config paths are repo-relative
    assert tbench.main([
        "--modality", "depth", "--benchmark", "nyu", "--checkpoint", ckpt,
        "--base_data_dir", nyu, "--output_dir", str(out),
        "--ensemble_size", "2", "--denoise_steps", "1",
        "--processing_res", "64", "--limit", "1", "--overwrite",
        "--device", "cpu"] + extra) == 0
    metric = out / "depth" / "nyu" / "eval_metric"
    assert (metric / "per_sample_metrics.csv").exists()
    return calls


def test_parity_pins_reach_the_port(ckpt, nyu, tmp_path, monkeypatch,
                                    restore_softmax):
    """--parity sets the online softmax (setter and environment) and hands
    the ensemble reg_max_res=1024 and gauge_anchor=False; explicit
    --ensemble_* flags beat the pins; without --parity nothing is pinned."""
    calls = _benchmark(ckpt, nyu, tmp_path / "a", monkeypatch, [])
    assert calls and all(c == (96, True) for c in calls)
    assert tattn.get_flash_softmax() == "shifted"
    calls = _benchmark(ckpt, nyu, tmp_path / "b", monkeypatch, ["--parity"])
    assert calls and all(c == (1024, False) for c in calls)
    assert tattn.get_flash_softmax() == "online"
    assert os.environ["MARIGOLD_TPU_FLASH_SOFTMAX"] == "online"
    calls = _benchmark(ckpt, nyu, tmp_path / "c", monkeypatch,
                       ["--parity", "--ensemble_reg_max_res", "48",
                        "--ensemble_gauge_anchor", "1"])
    assert calls and all(c == (48, True) for c in calls)


def test_decode_cap_follows_the_environment(monkeypatch):
    """MARIGOLD_DECODE_CAP is read at each call, as in the JAX package."""
    from marigold_tpu.pipelines.base import DiffusionCore as JaxCore

    cases = [(30, (768, 768), "depth", 1), (30, (480, 640), "normals", 1),
             (32, (640, 640), "iid", 2), (3, (768, 768), "iid", 3)]
    for cap, want in (("10", (3, 10)), ("30", (1, 30)), (None, (2, 15))):
        if cap is None:
            monkeypatch.delenv("MARIGOLD_DECODE_CAP", raising=False)
        else:
            monkeypatch.setenv("MARIGOLD_DECODE_CAP", cap)
        assert tbase.DiffusionCore.decode_chunking(30, (768, 768)) == want
        for case in cases:
            assert (tbase.DiffusionCore.decode_chunking(*case)
                    == JaxCore.decode_chunking(*case))


@pytest.mark.parametrize("value,want", [("online", "online"),
                                        ("shifted", "shifted"),
                                        (None, "shifted")])
def test_flash_softmax_environment_at_import(value, want):
    env = {k: v for k, v in os.environ.items()
           if k != "MARIGOLD_TPU_FLASH_SOFTMAX"}
    if value is not None:
        env["MARIGOLD_TPU_FLASH_SOFTMAX"] = value
    code = ("from marigold_tpu_torch.ops import attention; "
            "print(attention.get_flash_softmax())")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == want


def test_flash_softmax_environment_is_validated():
    env = dict(os.environ, MARIGOLD_TPU_FLASH_SOFTMAX="exact")
    res = subprocess.run(
        [sys.executable, "-c", "import marigold_tpu_torch.ops.attention"],
        capture_output=True, text=True, cwd=REPO, env=env)
    assert res.returncode != 0 and "shifted|online" in res.stderr


def _random_lpips_flat():
    """A random VGG16 + LPIPS weight set in the weight file's layout."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from export_lpips_weights import random_init_flat
    finally:
        sys.path.pop(0)
    return random_init_flat(seed=3)


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
def test_lpips_matches_jax_on_one_weight_file(tmp_path, fmt):
    import torch

    from marigold_tpu.eval.lpips import LPIPS as JaxLPIPS
    from marigold_tpu_torch.eval.lpips import LPIPS, get_lpips
    from marigold_tpu_torch.models.weights import write_safetensors

    flat = _random_lpips_flat()
    path = str(tmp_path / f"lpips.{fmt}")
    if fmt == "npz":
        np.savez(path, **flat)
    else:
        write_safetensors({k: torch.from_numpy(v) for k, v in flat.items()},
                          path)
    rng = np.random.default_rng(4)
    a, b = (rng.random((48, 40, 3)).astype(np.float32) for _ in range(2))
    ref = JaxLPIPS.from_file(path)
    got = LPIPS.from_file(path, device="cpu")
    for x, y in ((a, b), (b, a), (a, a)):
        assert abs(got(x, y) - ref(x, y)) <= LPIPS_ATOL
    assert got(a, b) > 0 and got(a, a) == 0.0
    assert get_lpips(str(tmp_path / "missing.npz")) is None


def test_eval_iid_runs_lpips_on_the_device_asked_for(tmp_path, monkeypatch):
    """IID eval scores LPIPS on --device. With --device cpu the port's CSV
    has the JAX eval's columns, psnr and ssim to the byte and LPIPS within
    LPIPS_ATOL; at the default (cuda) without a card it raises, and LPIPS
    never runs on the host unasked."""
    import torch

    from marigold_tpu_torch.config import recursive_load_config
    from marigold_tpu_torch.data import DatasetMode, get_dataset
    from test_benchmark_protocol import build_iid_hypersim

    cfg_rel = JAX_PROTOCOLS["iid"]["lighting_hypersim"][0]
    cfg = os.path.join(REPO, cfg_rel)
    ds_dir, lines = _split_lines(cfg_rel, 1)
    base = tmp_path / "base"
    rng = np.random.default_rng(5)
    build_iid_hypersim(str(base / ds_dir), lines, rng)
    ds = get_dataset(recursive_load_config(cfg)["dataset"],
                     base_data_dir=str(base), mode=DatasetMode.EVAL)
    rel = ds[0]["rgb_relative_path"]
    stem = (os.path.dirname(rel).replace(os.sep, "_") + "_"
            + os.path.splitext(os.path.basename(rel))[0])
    pred = tmp_path / "pred"
    pred.mkdir()
    for t in ("albedo", "shading", "residual"):
        np.save(pred / f"{stem}_{t}_pred.npy",
                rng.uniform(0, 1, (96, 128, 3)).astype(np.float32))
    weights = str(tmp_path / "lpips.npz")
    np.savez(weights, **_random_lpips_flat())
    argv = ["--modality", "iid", "--dataset_config", cfg, "--base_data_dir",
            str(base), "--prediction_dir", str(pred), "--lpips_weights",
            weights, "--limit", "1", "--output_dir"]
    assert jax_eval(argv + [str(tmp_path / "jax")]) == 0
    assert torch_eval(argv + [str(tmp_path / "torch"), "--device", "cpu"]) == 0
    rows = {}
    for name in ("jax", "torch"):
        with open(tmp_path / name / "per_sample_metrics.csv") as f:
            rows[name] = [ln.split(",") for ln in f.read().splitlines()]
    header = rows["torch"][0]
    assert header == rows["jax"][0]
    assert [c for c in header if c.startswith("lpips_")] == [
        "lpips_albedo", "lpips_shading", "lpips_residual"]
    for col, got, ref in zip(header, rows["torch"][1], rows["jax"][1]):
        if col.startswith("lpips_"):
            assert abs(float(got) - float(ref)) <= LPIPS_ATOL
        else:
            assert got == ref
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_eval(argv + [str(tmp_path / "cuda")])


def test_benchmark_hands_its_device_to_infer_and_eval(monkeypatch, tmp_path):
    from marigold_tpu_torch.cli import eval as teval
    from marigold_tpu_torch.cli import infer as tinfer

    seen = {}

    def spy(name):
        def main(argv):
            seen[name] = argv
            return 0
        return main

    monkeypatch.setattr(tinfer, "main", spy("infer"))
    monkeypatch.setattr(teval, "main", spy("eval"))
    assert tbench.main(["--modality", "iid", "--benchmark",
                        "lighting_hypersim", "--checkpoint", "ckpt",
                        "--base_data_dir", str(tmp_path), "--output_dir",
                        str(tmp_path / "out"), "--device", "cpu"]) == 0
    for argv in seen.values():
        assert argv[argv.index("--device") + 1] == "cpu"
    assert sorted(seen) == ["eval", "infer"]


def test_get_lpips_without_weights_is_none(monkeypatch):
    from marigold_tpu_torch.eval.lpips import get_lpips

    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    assert get_lpips(None) is None


def test_spectral_table_matches_matplotlib(monkeypatch):
    import matplotlib

    from marigold_tpu_torch.pipelines import image_util as tiu

    x = np.linspace(0.0, 1.0, 4096, dtype=np.float32)
    ref = matplotlib.colormaps["Spectral"](x)[..., :3]
    got = tiu.colorize_depth_maps(x[None], cmap="Spectral")[0, :, 0].T
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1.0 / 255
    # another colour map still needs matplotlib, and says so without it
    np.testing.assert_array_equal(
        tiu.colorize_depth_maps(x[None], cmap="viridis")[0, :, 0].T,
        matplotlib.colormaps["viridis"](x)[..., :3])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        tiu.colorize_depth_maps(x[None], cmap="viridis")
    assert tiu.colorize_depth_maps(x[None], cmap="Spectral").shape == (1, 3, 1, 4096)
