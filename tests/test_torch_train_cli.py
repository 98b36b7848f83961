"""The port's training entry point (marigold_tpu_torch.cli.train) end to end
on the CPU (`--device cpu`): a tiny SD2-layout base checkpoint written by
the port itself (random weights, the JAX package's init scheme, no JAX
init), fabricated NYU depth, NYU normals and Hypersim IID trees, and the
JAX CLI test's debug config (tests/test_cli.py::test_cli_train_debug) for
each of the three trainers: the run-dir files, the exit code, the surgered
UNet's channels, a rerun refusing the existing run dir; a run paused after
one iteration and resumed from checkpoint/latest ending with the
parameters of an uninterrupted run, bit for bit, with Adam and with
Adafactor; and the device and multi-device flags."""

import copy
import json
import logging
import os
import tarfile
from datetime import datetime

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from fixtures import TINY_CLIP, TINY_VAE, tiny_unet_config
from marigold_tpu_torch.cli import train as cli_train
from marigold_tpu_torch.core.scheduler import DiffusionSchedule
from marigold_tpu_torch.models import weights as W
from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores several
    times over (tiny models gain nothing from it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HW = (32, 32)


def write_port_sd2(root: str, seed: int = 0) -> str:
    """The fixtures' tiny SD2 checkpoint (4-channel UNet) with random weights
    drawn by the port (`weights.random_state_dict`), in diffusers layout."""
    gen = torch.Generator().manual_seed(seed)
    parts = [
        ("unet", UNet2DConditionModel,
         UNetConfig.from_dict(tiny_unet_config(4, 4).to_dict()),
         "diffusion_pytorch_model.safetensors", ""),
        ("vae", AutoencoderKL, VAEConfig.from_dict(TINY_VAE.to_dict()),
         "diffusion_pytorch_model.safetensors", ""),
        ("text_encoder", CLIPTextModel, CLIPTextConfig.from_dict(TINY_CLIP.to_dict()),
         "model.safetensors", "text_model."),
    ]
    for sub, cls, cfg, fname, prefix in parts:
        with torch.device("meta"):
            model = cls(cfg)
        W.save_component(cfg.to_dict(), W.random_state_dict(model, gen),
                         os.path.join(root, sub), fname, prefix)
    DiffusionSchedule.create().save_pretrained(os.path.join(root, "scheduler"))
    W.write_config({"_class_name": "StableDiffusionPipeline",
                    "default_denoising_steps": 4,
                    "default_processing_resolution": 32}, root, "model_index.json")
    return root


def _write_data(base, rng):
    """nyu/ (depth), nyu_normals/ and hypersim_iid/ trees of 4 samples
    each, with their split lists; -> {modality: split path}."""
    splits = {}
    names, root = [], base / "nyu"
    os.makedirs(root)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (*HW, 3), dtype=np.uint8)).save(
            root / f"rgb_{i:05d}.png")
        mm = rng.integers(500, 9000, HW, dtype=np.uint16)
        Image.fromarray(mm).save(root / f"depth_{i:05d}.png")
        Image.fromarray(mm).save(root / f"filled_{i:05d}.png")
        names.append(f"rgb_{i:05d}.png depth_{i:05d}.png filled_{i:05d}.png")
    (base / "depth.txt").write_text("\n".join(names))
    splits["depth"] = base / "depth.txt"
    names, root = [], base / "nyu_normals"
    os.makedirs(root)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (*HW, 3), dtype=np.uint8)).save(
            root / f"rgb_{i}.png")
        n = rng.normal(size=(*HW, 3)).astype(np.float32)
        np.save(root / f"n_{i}.npy", n / np.linalg.norm(n, axis=-1, keepdims=True))
        names.append(f"rgb_{i}.png n_{i}.npy")
    (base / "normals.txt").write_text("\n".join(names))
    splits["normals"] = base / "normals.txt"
    names, root = [], base / "hypersim_iid"
    os.makedirs(root)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (*HW, 3), dtype=np.uint8)).save(
            root / f"rgb_{i}.png")
        for t in ("a", "s", "r"):
            np.save(root / f"{t}_{i}.npy",
                    rng.uniform(0.05, 1, (*HW, 3)).astype(np.float32))
        names.append(f"rgb_{i}.png a_{i}.npy s_{i}.npy r_{i}.npy")
    (base / "iid.txt").write_text("\n".join(names))
    splits["iid"] = base / "iid.txt"
    return splits


@pytest.fixture(autouse=True)
def _root_log_handlers():
    """The CLI adds console and file handlers to the root logger, as the
    JAX CLI does; each test closes the ones its runs added."""
    root = logging.getLogger()
    before, level = root.handlers[:], root.level
    yield
    for h in root.handlers[len(before):]:
        h.close()
    root.handlers[:] = before
    root.setLevel(level)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_cli")
    write_port_sd2(str(base / "ckpt_base" / "sd2"))
    os.makedirs(base / "data")
    return base, _write_data(base / "data", np.random.default_rng(0))


COMMON = {
    "model": {"name": "marigold_pipeline", "pretrained_path": "sd2"},
    "augmentation": {"lr_flip_p": 0.5},
    "dataloader": {"num_workers": 0, "effective_batch_size": 2,
                   "max_train_batch_size": 1, "seed": 2024},
    "multi_res_noise": {"strength": 0.9, "annealed": True,
                        "downscale_strategy": "original"},
    "max_epoch": 100, "max_iter": 2,
    "optimizer": {"name": "Adam"},
    "loss": {"name": "mse_loss", "kwargs": {"reduction": "mean"}},
    "lr": 1e-4,
    "lr_scheduler": {"name": "IterExponential", "kwargs": {
        "total_iter": 100, "final_ratio": 0.01, "warmup_steps": 0}},
    "logging": {"console_level": 30},
}
VALIDATION = {"denoising_steps": 1, "ensemble_size": 1, "processing_res": 0,
              "match_input_res": True, "resample_method": "bilinear",
              "init_seed": 2024}
LIGHTING = {
    "target_names": ["albedo", "shading", "residual"],
    "albedo": {"prediction_space": "linear", "up_to_scale": False},
    "shading": {"prediction_space": "linear", "up_to_scale": True},
    "residual": {"prediction_space": "linear", "up_to_scale": True},
}


def _config(modality, split, val=True, **over):
    """The debug config of tests/test_cli.py::test_cli_train_debug for the
    depth trainer, and its counterparts for the normals and IID ones."""
    cfg = copy.deepcopy(COMMON)
    trainer = {"init_seed": 2024, "save_period": 2, "backup_period": 0,
               "validation_period": 2 if val else 0, "visualization_period": 0}
    if modality == "depth":
        ds = {"name": "nyu_depth", "dir": "nyu", "eigen_valid_mask": False}
        cfg.update({
            "pipeline": {"name": "MarigoldDepthPipeline", "kwargs": {
                "scale_invariant": True, "shift_invariant": True,
                "default_denoising_steps": 1, "default_processing_resolution": 32}},
            "depth_normalization": {"type": "scale_shift_depth", "clip": True,
                                    "norm_min": -1.0, "norm_max": 1.0,
                                    "min_max_quantile": 0.02},
            "trainer": dict(trainer, name="MarigoldDepthTrainer"),
            "gt_depth_type": "depth_raw_norm", "gt_mask_type": "valid_mask_raw",
            "validation": dict(VALIDATION, main_val_metric="abs_relative_difference",
                               main_val_metric_goal="minimize"),
            "eval": {"alignment": "least_square", "align_max_res": None,
                     "eval_metrics": ["abs_relative_difference", "delta1_acc"]}})
    elif modality == "normals":
        ds = {"name": "nyu_normals", "dir": "nyu_normals"}
        cfg.update({
            "pipeline": {"name": "MarigoldNormalsPipeline", "kwargs": {
                "default_denoising_steps": 1, "default_processing_resolution": 32}},
            "trainer": dict(trainer, name="MarigoldNormalsTrainer"),
            "gt_normals_type": "normals", "gt_mask_type": None,
            "validation": dict(VALIDATION, main_val_metric="mean_angular_error",
                               main_val_metric_goal="minimize"),
            "eval": {"eval_metrics": ["mean_angular_error", "sub11_25_error"]}})
    else:
        ds = {"name": "hypersim_iid", "dir": "hypersim_iid"}
        cfg.update({
            "pipeline": {"name": "MarigoldIIDPipeline", "kwargs": {
                "default_denoising_steps": 1, "default_processing_resolution": 32,
                "target_properties": LIGHTING}},
            "trainer": dict(trainer, name="MarigoldIIDTrainer"),
            "gt_mask_type": None,
            "validation": dict(VALIDATION, main_val_metric="psnr",
                               main_val_metric_goal="minimize", use_mask=True),
            "eval": {"eval_metrics": ["psnr"]}})
    entry = dict(ds, filenames=str(split))
    cfg["dataset"] = {
        "train": {"name": "mixed", "prob_ls": [1.0], "dataset_list": [
            dict(entry, disp_name="tiny_train")]},
        "val": [dict(entry, disp_name="tiny_val")] if val else [],
        "vis": []}
    for k, v in over.items():
        cfg[k] = v
    return cfg


def _argv(base, cfg, name, *extra):
    path = base / "configs" / f"{name}.yaml"
    os.makedirs(path.parent, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return ["--config", str(path), "--output_dir", str(base / "runs"),
            "--base_data_dir", str(base / "data"),
            "--base_ckpt_dir", str(base / "ckpt_base"),
            "--device", "cpu", "--no_wandb", *extra]


@pytest.mark.parametrize("modality,channels", [
    ("depth", (8, 4)), ("normals", (8, 4)), ("iid", (16, 12))])
def test_cli_train_runs_each_trainer(env, modality, channels):
    base, splits = env
    argv = _argv(base, _config(modality, splits[modality]), f"run_{modality}",
                 "--data_parallel", "--shard_optimizer")  # one device: warn
    assert cli_train.main(argv) == 0
    run_dir = base / "runs" / f"run_{modality}"
    for rel in ("config.yaml", "code_snapshot.tar", "logging.log",
                "checkpoint/latest/unet/config.json",
                "checkpoint/latest/opt_state.safetensors",
                "checkpoint/iter_000002/unet/config.json", "checkpoint/best/unet",
                "tensorboard", "evaluation", "visualization"):
        assert (run_dir / rel).exists(), rel
    with open(run_dir / "checkpoint" / "latest" / "unet" / "config.json") as f:
        ucfg = json.load(f)
    assert (ucfg["in_channels"], ucfg["out_channels"]) == channels
    with open(run_dir / "checkpoint" / "latest" / "trainer.json") as f:
        state = json.load(f)
    assert state["effective_iter"] == 2 and state["step"] == 4
    with tarfile.open(run_dir / "code_snapshot.tar") as tar:
        names = tar.getnames()
    assert "marigold_tpu_torch/cli/train.py" in names
    assert "marigold_tpu_torch/csrc/flash_bwd_sm90.cu" in names
    assert "marigold_tpu_torch/csrc/sm90.cuh" in names
    # a rerun must not write into the existing run dir
    with pytest.raises(FileExistsError):
        cli_train.main(argv)


def _iter2_params(run_dir):
    return W.load_state_dict(str(run_dir / "checkpoint" / "iter_000002" / "unet"))


@pytest.mark.parametrize("optimizer", ["Adam", "Adafactor"])
def test_resume_reproduces_the_uninterrupted_run(env, optimizer):
    """1 iteration, paused by the time budget (which saves
    checkpoint/latest), then --resume_run for the second: the parameters
    of an uninterrupted 2-iteration run, bit for bit (the same batches
    from the loader's position, augmentation and noise seeds, lr and
    optimizer state)."""
    base, splits = env
    cfg = _config("depth", splits["depth"], val=False,
                  optimizer={"name": optimizer})
    cfg["trainer"]["save_period"] = 0
    name = f"resume_{optimizer}"
    assert cli_train.main(_argv(base, cfg, name + "_full")) == 0
    trainer, _ = cli_train.setup(_argv(base, cfg, name))
    trainer.train(t_end=datetime.now())  # time is up after iteration 1
    run_dir = base / "runs" / name
    with open(run_dir / "checkpoint" / "latest" / "trainer.json") as f:
        paused = json.load(f)
    assert (paused["effective_iter"], paused["n_batch_in_epoch"]) == (1, 2)
    assert not (run_dir / "checkpoint" / "iter_000002").exists()
    del trainer
    assert cli_train.main([
        "--resume_run", str(run_dir / "checkpoint" / "latest"),
        "--base_data_dir", str(base / "data"),
        "--base_ckpt_dir", str(base / "ckpt_base"),
        "--device", "cpu", "--no_wandb"]) == 0
    want = _iter2_params(base / "runs" / (name + "_full"))
    got = _iter2_params(run_dir)
    assert got.keys() == want.keys()
    for n, t in want.items():
        assert torch.equal(got[n], t), n
    start = W.load_state_dict(str(base / "ckpt_base" / "sd2" / "unet"))
    moved = sum(not torch.equal(start[n], t) for n, t in want.items()
                if start[n].shape == t.shape)
    assert moved > len(want) // 2


def test_device_and_multi_device_flags(env, monkeypatch):
    """cuda (the default) without a card raises before anything is
    written; --multihost with no cluster named raises the JAX CLI's error;
    --data_parallel with two GPUs visible and no process group spawns one
    rank per GPU over NCCL, each running the same command line."""
    from marigold_tpu_torch.parallel import mesh as M

    base, splits = env
    argv = _argv(base, _config("depth", splits["depth"]), "flags")
    argv = argv[:argv.index("--device")] + argv[argv.index("--device") + 2:]
    for k in ("MARIGOLD_TPU_COORDINATOR", "MARIGOLD_TPU_NUM_PROCESSES",
              "MARIGOLD_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_train.main(argv)
    with pytest.raises(ValueError, match="coordinator_address should be defined"):
        cli_train.main(argv + ["--device", "cpu", "--multihost"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    spawned = []

    def run_on_ranks(fn, n, args=(), **kw):
        spawned.append((fn, n, args, kw))
        return [0] * n

    monkeypatch.setattr(M, "run_on_ranks", run_on_ranks)
    assert cli_train.main(argv + ["--data_parallel"]) == 0
    (fn, n, args, kw), = spawned
    assert (fn, n, args) == (cli_train._spawned_rank, 2, (argv + ["--data_parallel"],))
    assert (kw["device"], kw["backend"], kw["timeout_s"]) == ("cuda", "nccl", None)
    assert not (base / "runs" / "flags").exists()
