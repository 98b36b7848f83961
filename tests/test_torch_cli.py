"""The port's command-line entry points against the JAX package's, on the
tiny checkpoints of tests/fixtures.py (CPU, `--device cpu`).

`run` for depth, normals and IID runs both packages' CLIs on the same image
folder and checkpoint. The two frameworks draw different random numbers
from one seed, so both packages' initial noise is patched to the same
arrays keyed by shape (`jax.random.normal` in the JAX programs, the port's
`BasePipeline._noise`), as tests/test_torch_lcm.py does. Tolerances, fp32
at E=1: ATOL = 1e-4 on the npy maps (the pipelines' own); PNG16_LSB = 2 on
the 16-bit depth PNGs; PNG8_LSB = 1 on the 8-bit normals and IID PNGs; the
coloured depth PNGs within one step of the colour table (a map that moves
by 1e-4 can cross a bin).

`serve --once` writes the same file set as the JAX daemon's; the daemon's
own behaviours (retries, failures, eviction, the HTTP API, batching, the
413 limit, the drain) mirror tests/test_cli.py on the port.

A last test scans every module of the port and chip_smoke.py for imports
of JAX or the JAX package.
"""

import ast
import io
import json
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import make_tiny_checkpoint
from marigold_tpu.cli.run import main as jax_run
from marigold_tpu.cli.serve import main as jax_serve
from marigold_tpu_torch.cli import serve as tserve
from marigold_tpu_torch.cli.run import main as torch_run
from marigold_tpu_torch.pipelines import base as tbase
from marigold_tpu_torch.pipelines import image_util as tiu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
PNG16_LSB = 2
PNG8_LSB = 1
MODES = ("depth", "normals", "iid")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return {m: make_tiny_checkpoint(str(tmp_path_factory.mktemp(m)), mode=m)
            for m in MODES}


@pytest.fixture(autouse=True)
def _host_loader(monkeypatch):
    # the JAX package's per-tensor host loader, uncached compiles
    monkeypatch.setenv("MARIGOLD_TPU_FASTLOAD", "0")
    monkeypatch.setenv("MARIGOLD_TPU_COMPILE_CACHE", "0")


def _keyed(shape):
    """Standard normals keyed by an NHWC shape (the same array for the same
    shape in both packages)."""
    rng = np.random.default_rng(abs(hash(tuple(shape))) % (2**32))
    return rng.standard_normal(tuple(shape)).astype(np.float32)


@pytest.fixture
def shared_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_keyed(shape), dtype))

    def noise(self, n, h, w, seed):
        ch = self.core.vae_cfg.latent_channels * max(self.n_targets, 1)
        return torch.from_numpy(
            _keyed((n, h, w, ch)).transpose(0, 3, 1, 2).copy())

    monkeypatch.setattr(tbase.BasePipeline, "_noise", noise)


def _write_images(folder, shapes, seed=0):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(shapes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"img{i}.png"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _lut_step():
    """Largest change between neighbouring entries of the Spectral table,
    in 8-bit levels, plus one for the rounding."""
    return int(np.ceil(np.abs(np.diff(tiu.SPECTRAL_LUT, axis=0)).max() * 255)) + 1


@pytest.mark.parametrize("modality", MODES)
def test_run_matches_jax_run(ckpts, tmp_path, shared_noise, modality):
    src = str(tmp_path / "in")
    _write_images(src, [(40, 48), (36, 52)])
    args = ["--modality", modality, "--checkpoint", ckpts[modality],
            "--input_rgb_dir", src, "--denoise_steps", "1",
            "--processing_res", "32", "--full_precision", "--seed", "1"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_run(args + ["--output_dir", jout]) == 0
    assert torch_run(args + ["--output_dir", tout, "--device", "cpu"]) == 0
    names = _files(jout)
    assert names == _files(tout) and len(names) == {
        "depth": 6, "normals": 4, "iid": 8}[modality]
    for name in names:
        a, b = os.path.join(jout, name), os.path.join(tout, name)
        if name.endswith(".npy"):
            ref, got = np.load(a), np.load(b)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
            continue
        ref, got = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        diff = np.abs(got.astype(np.int64) - ref.astype(np.int64)).max()
        if name.endswith("_depth_bw.png"):
            assert got.dtype == np.uint16 and diff <= PNG16_LSB, name
        elif name.endswith("_depth_colored.png"):
            assert got.shape[-1] == 3 and diff <= _lut_step(), name
        else:
            assert got.dtype == np.uint8 and diff <= PNG8_LSB, name
    shapes = {"img0": (40, 48), "img1": (36, 52)}
    for stem, hw in shapes.items():
        pred = np.load(os.path.join(tout, f"{modality}_npy",
                                    f"{stem}_albedo_pred.npy" if modality == "iid"
                                    else f"{stem}_pred.npy"))
        assert pred.shape == {"depth": hw, "normals": hw + (3,),
                              "iid": (3,) + hw}[modality]


def test_run_needs_a_card_or_the_cpu(ckpts, tmp_path):
    """Without --device the CLIs run on the card: no card raises, and
    nothing runs on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    src = str(tmp_path / "in")
    _write_images(src, [(40, 48)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_run(["--checkpoint", ckpts["depth"], "--input_rgb_dir", src,
                   "--output_dir", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


# ---------------------------------------------------------------- serve


def _serve_args(ckpt, watch, out, *extra, modality="depth"):
    return ["--checkpoint", ckpt, "--modality", modality,
            "--watch_dir", str(watch), "--output_dir", str(out),
            "--ensemble_size", "1", "--denoise_steps", "1",
            "--processing_res", "32", "--color_map", "None", *extra]


def test_serve_once_writes_the_jax_file_set(ckpts, tmp_path):
    """Mixed-shape inputs are bucketed into same-shape batches (two full,
    one alone) and saved in the run.py layout, under the JAX daemon's
    names."""
    watch = tmp_path / "watch"
    _write_images(watch, [(48, 64), (48, 64), (64, 48)], seed=1)
    extra = ["--batch_images", "2", "--seed", "7", "--once"]
    assert jax_serve(_serve_args(ckpts["depth"], watch, tmp_path / "jax",
                                 *extra)) == 0
    assert tserve.main(_serve_args(ckpts["depth"], watch, tmp_path / "torch",
                                   *extra, "--device", "cpu")) == 0
    names = _files(tmp_path / "torch")
    assert names == _files(tmp_path / "jax") and len(names) == 6
    for i, hw in enumerate([(48, 64), (48, 64), (64, 48)]):
        pred = np.load(tmp_path / "torch" / "depth_npy" / f"img{i}_pred.npy")
        assert pred.shape == hw and np.isfinite(pred).all()


def test_serve_once_retries_partial_file(ckpts, tmp_path):
    """A file that fails to open (upload in progress) is retried on a clock
    until it becomes readable."""
    watch = tmp_path / "watch"
    _write_images(watch, [(48, 64)])
    buf = io.BytesIO()
    Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(buf, format="PNG")
    full = buf.getvalue()
    partial = watch / "late.png"
    partial.write_bytes(full[: len(full) // 2])
    timer = threading.Timer(1.5, lambda: partial.write_bytes(full))
    timer.start()
    try:
        rc = tserve.main(_serve_args(
            ckpts["depth"], watch, tmp_path / "out", "--batch_images", "1",
            "--poll_interval", "0.2", "--read_retry_window", "30", "--once",
            "--device", "cpu"))
    finally:
        timer.join()
    assert rc == 0
    assert (tmp_path / "out" / "depth_npy" / "img0_pred.npy").exists()
    assert (tmp_path / "out" / "depth_npy" / "late_pred.npy").exists()


def test_serve_once_corrupt_file_reports_failure(ckpts, tmp_path):
    watch = tmp_path / "watch"
    _write_images(watch, [(48, 64)])
    (watch / "bad.png").write_bytes(b"\x89PNG not really")
    rc = tserve.main(_serve_args(
        ckpts["depth"], watch, tmp_path / "out", "--batch_images", "1",
        "--poll_interval", "0.1", "--read_retry_window", "0.5", "--once",
        "--device", "cpu"))
    assert rc == 1
    assert (tmp_path / "out" / "depth_npy" / "img0_pred.npy").exists()
    assert not (tmp_path / "out" / "depth_npy" / "bad_pred.npy").exists()


def test_scan_new_evicts_deleted(tmp_path):
    d = tmp_path / "w"
    d.mkdir()
    (d / "a.png").write_bytes(b"x")
    (d / "b.png").write_bytes(b"x")
    seen, rf = set(), {}
    assert len(tserve._scan_new(str(d), seen, rf)) == 2
    rf[str(d / "a.png")] = [1, 0.0, 0.0]
    (d / "a.png").unlink()
    assert tserve._scan_new(str(d), seen, rf) == []
    assert seen == {str(d / "b.png")} and rf == {}
    (d / "a.png").write_bytes(b"x")
    assert tserve._scan_new(str(d), seen, rf) == [str(d / "a.png")]


def test_sigterm_sets_drain_event():
    old = signal.getsignal(signal.SIGTERM)
    try:
        stop = tserve._install_sigterm_drain()
        assert stop is not None and not stop.is_set()
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(200):
            if stop.is_set():
                break
            time.sleep(0.01)
        assert stop.is_set()
    finally:
        signal.signal(signal.SIGTERM, old)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Server:
    """serve() in a thread on a free loopback port, stopped by its event."""

    def __init__(self, argv):
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.args = tserve.build_parser().parse_args(
            argv + ["--http_port", str(self.port), "--device", "cpu"])
        self.stop = threading.Event()
        self.rc = []
        self.thread = threading.Thread(
            target=lambda: self.rc.append(tserve.serve(self.args, self.stop)),
            daemon=True)

    def __enter__(self):
        self.thread.start()
        for _ in range(600):
            try:
                with urllib.request.urlopen(f"{self.base}/healthz", timeout=5):
                    return self
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.1)
        raise AssertionError("http server never came up")

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=120)
        assert not self.thread.is_alive()

    def health(self):
        with urllib.request.urlopen(f"{self.base}/healthz", timeout=30) as r:
            return json.loads(r.read())

    def post(self, body, fmt=None, timeout=120):
        query = f"?format={fmt}" if fmt else ""
        req = urllib.request.Request(f"{self.base}/v1/predict{query}",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()


def _png(shape=(40, 48), seed=0):
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, shape + (3,), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def test_serve_http_api_depth(ckpts, tmp_path):
    """POST /v1/predict returns the map (npy, 16-bit png); malformed bodies
    get 400, wrong paths 404; /healthz reports what was served."""
    (tmp_path / "watch").mkdir()
    with _Server(_serve_args(ckpts["depth"], tmp_path / "watch",
                             tmp_path / "out", "--batch_images", "1",
                             "--poll_interval", "0.1", "--batch_wait", "0.2")
                 ) as srv:
        status, body = srv.post(_png(), "npy")
        pred = np.load(io.BytesIO(body))
        assert status == 200 and pred.shape == (40, 48)
        assert np.isfinite(pred).all() and 0 <= pred.min() <= pred.max() <= 1
        status, body = srv.post(_png(), "png")
        png = np.asarray(Image.open(io.BytesIO(body)))
        assert status == 200 and png.shape == (40, 48) and png.dtype == np.uint16
        with pytest.raises(urllib.error.HTTPError) as e:
            srv.post(b"not an image")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.base}/nope", timeout=30)
        assert e.value.code == 404
        for _ in range(100):
            h = srv.health()
            if h["served"] >= 2:
                break
            time.sleep(0.1)
        assert h["ok"] and h["served"] == 2 and h["pending"] == 0, h


def test_serve_http_api_iid(ckpts, tmp_path):
    """IID over HTTP: npz of every target, and the first target's PNG."""
    (tmp_path / "watch").mkdir()
    with _Server(_serve_args(ckpts["iid"], tmp_path / "watch", tmp_path / "out",
                             "--batch_images", "1", "--poll_interval", "0.1",
                             "--batch_wait", "0.2", "--full_precision",
                             modality="iid")) as srv:
        _, body = srv.post(_png(), "npy")
        z = np.load(io.BytesIO(body))
        assert sorted(z.files) == ["albedo", "material"]
        assert all(z[n].shape == (3, 40, 48) and np.isfinite(z[n]).all()
                   for n in z.files)
        _, body = srv.post(_png(), "png")
        assert Image.open(io.BytesIO(body)).size == (48, 40)


def test_serve_http_concurrent_requests_batch(ckpts, tmp_path):
    """Two same-shape requests arriving together run as one batch
    (batch_images 2, batch_wait 30 s) and both get answers."""
    (tmp_path / "watch").mkdir()
    with _Server(_serve_args(ckpts["depth"], tmp_path / "watch",
                             tmp_path / "out", "--batch_images", "2",
                             "--poll_interval", "0.1", "--batch_wait", "30")
                 ) as srv:
        results = {}

        def one(i):
            results[i] = np.load(io.BytesIO(srv.post(_png(seed=i),
                                                     timeout=180)[1]))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert set(results) == {0, 1}
        assert all(p.shape == (40, 48) for p in results.values())
        for _ in range(100):
            h = srv.health()
            if h["served"] == 2:
                break
            time.sleep(0.1)
        assert h["served"] == 2 and h["batches"] == 1, h


def test_serve_http_oversized_body_413(ckpts, tmp_path):
    (tmp_path / "watch").mkdir()
    with _Server(_serve_args(ckpts["depth"], tmp_path / "watch",
                             tmp_path / "out", "--batch_images", "1",
                             "--poll_interval", "0.1", "--batch_wait", "0.2",
                             "--http_max_body_mb", "1")) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            srv.post(b"\0" * (1024 * 1024 + 1))
        assert e.value.code == 413
        assert srv.health()["served"] == 0


def test_serve_drain_on_stop(ckpts, tmp_path):
    """A stop request drains accepted work: files in an under-full bucket
    still run before the daemon exits with 0."""
    watch = tmp_path / "watch"
    _write_images(watch, [(40, 48), (40, 48)])
    srv = _Server(_serve_args(ckpts["depth"], watch, tmp_path / "out",
                              "--batch_images", "4", "--batch_wait", "600",
                              "--poll_interval", "0.1"))
    with srv:
        for _ in range(600):
            if srv.health().get("pending", 0) >= 2:
                break
            time.sleep(0.1)
        else:
            raise AssertionError("files never accepted")
    assert srv.rc == [0]
    assert sorted(os.listdir(tmp_path / "out" / "depth_npy")) == [
        "img0_pred.npy", "img1_pred.npy"]


@pytest.mark.parametrize("name", ["run", "serve", "validate_ckpt", "infer",
                                  "eval", "benchmark"])
def test_cli_help(name, capsys):
    import importlib

    mod = importlib.import_module(f"marigold_tpu_torch.cli.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0 and "usage:" in capsys.readouterr().out


# ---------------------------------------------------------------- imports


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package (read from each file's import statements)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(REPO, "marigold_tpu_torch")):
        paths += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert any(p.endswith(os.path.join("cli", "serve.py")) for p in paths)
    bad = {os.path.relpath(p, REPO): sorted(r) for p in paths
           if (r := _imported_roots(p) & {"jax", "jaxlib", "marigold_tpu"})}
    assert not bad, bad


def test_cli_modules_import_without_jax():
    import subprocess
    import sys

    mods = ", ".join(f"marigold_tpu_torch.cli.{m}" for m in (
        "run", "serve", "validate_ckpt", "infer", "eval", "benchmark"))
    code = (f"import sys, {mods}, marigold_tpu_torch.models.manifest, "
            "marigold_tpu_torch.eval.lpips, marigold_tpu_torch.data, "
            "marigold_tpu_torch.utils.logging_util; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'marigold_tpu')]; print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
