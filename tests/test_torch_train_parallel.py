"""Fine-tuning across ranks: the port's train step, trainer and training CLI
over a `parallel.mesh.Mesh` of two gloo ranks on the CPU, against the JAX
package's single-device train step and against the port's one process, in
fp32 on the tiny UNet and VAE of tests/test_mesh.py.

One spawn of two ranks (`rank_cases`) runs every rank-side case; each rank
imports this module to find its function, so the module imports JAX and the
JAX package only inside fixtures and tests, never at the top: a rank runs the
port alone. The frameworks draw different random numbers, so each rank is
handed its rows of the JAX step's own timesteps and noise. Cases: (a) the
loss and the parameters after one apply against JAX on a global batch of 4
whose two halves have different valid-pixel counts (Adam at k=2 with a bf16
accumulator, Adafactor at k=1), and the global draws of a rank against the
one process's; (b) ZeRO-1 against the replicated run, bit for bit, and its
layout against JAX's `zero1_state_shardings`; (c) checkpoints between one
and two ranks; (d) `cli/train.py --multihost --data_parallel` (with
`--shard_optimizer` and validation); (e) single-host `--data_parallel`'s
global batch against the one-process loader's."""

import concurrent.futures
import json
import os
import shutil

import numpy as np
import pytest
import torch

from marigold_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)  # as the other model test modules do


@pytest.fixture(autouse=True)
def _root_log_handlers():
    """The CLI adds console and file handlers to the root logger; each test
    closes the ones its runs added."""
    import logging

    root = logging.getLogger()
    before, level = root.handlers[:], root.level
    yield
    for h in root.handlers[len(before):]:
        h.close()
    root.handlers[:] = before
    root.setLevel(level)

N_RANKS = 2
LR, SCHED = 5e-6, (100, 0.01, 0)
GLOBAL_B, HW = 4, (16, 16)
# (optimizer, accumulation steps, accumulator dtype): two applies each
OPT_CASES = [("adam", 2, "bfloat16"), ("adafactor", 1, None)]
MRN = {"strength": 0.9, "annealed": True, "downscale_strategy": "original"}
# tests/test_mesh.py:147-155, the JAX package's sharded-vs-single bound
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)


def _micro_batches(n: int) -> list:
    """n global micro-batches (NHWC numpy, the JAX step's layout): the first
    half of each batch with 5% invalid pixels, the second with an invalid
    block, so that the ranks' valid counts differ."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        depth = rng.uniform(-1, 1, (GLOBAL_B, *HW, 1)).astype(np.float32)
        valid = rng.uniform(size=(GLOBAL_B, *HW, 1)) > 0.05
        valid[GLOBAL_B // 2:, 2:12, 3:14] = False
        out.append({"rgb_norm": rng.uniform(-1, 1, (GLOBAL_B, *HW, 3)).astype(np.float32),
                    "gt_norm": np.repeat(depth, 3, axis=-1), "valid_mask": valid})
    return out


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def port_models(ckpt: str) -> dict:
    """The port's modules from the tiny SD2 checkpoint, after the depth
    trainer's conv_in surgery (fp32, CPU)."""
    from marigold_tpu_torch.core.scheduler import DiffusionSchedule
    from marigold_tpu_torch.models import surgery
    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.unet import UNet2DConditionModel

    unet4 = W.load_unet(os.path.join(ckpt, "unet"), device="cpu")
    cfg, sd = surgery.replace_conv_in(unet4.cfg, unet4.state_dict(), 8)
    return {"unet": W.build_module(UNet2DConditionModel, cfg, sd, torch.float32, "cpu"),
            "vae": W.load_vae(os.path.join(ckpt, "vae"), device="cpu"),
            "schedule": DiffusionSchedule.from_pretrained(os.path.join(ckpt, "scheduler")),
            "sd": sd}


def port_step(models, mesh, name, k, accum_dtype, shard=False, mrn=None):
    from marigold_tpu_torch.train import train_step as ts
    from marigold_tpu_torch.train.lr_schedule import iter_exponential

    opt = ts.make_optimizer(LR, iter_exponential(*SCHED), k, name=name,
                            accum_dtype=accum_dtype, mesh=mesh, shard_states=shard)
    micro, apply = ts.make_train_step(
        models["unet"], models["vae"], models["schedule"], opt, mesh=mesh,
        loss_name="mse_loss", multi_res_noise_cfg=mrn, use_mask=True,
        compute_dtype=torch.float32)
    state = opt.init({n: t.clone().requires_grad_() for n, t in models["sd"].items()})
    return opt, micro, apply, state


def _local(mesh, x):
    return x if mesh is None else x[mesh.rows(len(x))]


def run_steps(models, mesh, name, k, accum_dtype, batches, draws, text,
              shard=False) -> dict:
    """len(batches) micro-steps, an apply after every k-th: the losses and
    grad norms, the parameters after each apply and the state layout seen
    mid-window."""
    opt, micro, apply, state = port_step(models, mesh, name, k, accum_dtype, shard)
    out = {"loss": [], "grad_norm": [], "params": [], "layout": None}
    for i, (batch, (t, noise)) in enumerate(zip(batches, draws)):
        local = {key: _local(mesh, _nchw(v)) for key, v in batch.items()}
        m = micro(state, text, local, timesteps=_local(mesh, t),
                  noise=_local(mesh, noise))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if out["layout"] is None:
            out["layout"] = {g: {n: tuple(x.shape) for n, x in getattr(state, g).items()}
                             for g in ("acc",) + opt.groups}
            out["axes"] = dict(opt.axes)
        if (i + 1) % k == 0:
            apply(state)
            out["params"].append({n: p.detach().clone() for n, p in state.params.items()})
    return out


def drawn_step(models, mesh, text, batch) -> tuple:
    """One Adam micro-step and apply with the draws made by the step from a
    seeded generator (annealed multi-resolution noise): (loss, grad_norm)."""
    _, micro, apply, state = port_step(models, mesh, "adam", 1, None, mrn=MRN)
    local = {key: _local(mesh, _nchw(v)) for key, v in batch.items()}
    m = micro(state, text, local, torch.Generator().manual_seed(5))
    return float(m["loss"]), float(m["grad_norm"])


# ---------------------------------------------------------------------- #
# the trainer and the CLI


def trainer_cfg(max_epoch: int, shard: bool = False):
    from marigold_tpu_torch.config import Config

    return Config(
        lr=LR,
        lr_scheduler=Config(name="IterExponential", kwargs=Config(
            total_iter=100, final_ratio=0.01, warmup_steps=0)),
        loss=Config(name="mse_loss", kwargs=Config(reduction="mean")),
        trainer=Config(name="MarigoldDepthTrainer", init_seed=2024, save_period=0,
                       backup_period=0, validation_period=0, visualization_period=0),
        multi_res_noise=Config(MRN),
        optimizer=Config(name="Adam", shard_states=shard),
        gt_depth_type="depth_raw_norm", gt_mask_type="valid_mask_raw",
        max_epoch=max_epoch, max_iter=100,
        validation=Config(main_val_metric="abs_relative_difference",
                          main_val_metric_goal="minimize"),
    )


def trainer_batches() -> list:
    """3 global batches of 2 in the trainer's layout: with accumulation 2
    the epoch ends mid-window, so the epoch-end save holds an accumulator."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(3):
        valid = rng.uniform(size=(2, 32, 32, 1)) > 0.1
        valid[1, 4:20, 8:30] = False
        out.append({"rgb_norm": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                    "depth_raw_norm": rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32),
                    "valid_mask_raw": valid})
    return out


def make_trainer(sd2: str, out: str, max_epoch: int, mesh=None, shard=False):
    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.train.trainer import MarigoldDepthTrainer

    pipe = MarigoldDepthPipeline.from_pretrained(sd2, dtype=torch.float32, device="cpu")
    return MarigoldDepthTrainer(
        trainer_cfg(max_epoch, shard), pipe, trainer_batches(),
        os.path.join(out, "ckpt"), os.path.join(out, "eval"),
        os.path.join(out, "vis"), accumulation_steps=2, mesh=mesh)


def trainer_cases(mesh, sd2: str, root: str) -> dict:
    """(c) in each rank: one epoch replicated and under ZeRO-1 (each saves
    checkpoint/latest at the epoch end), the one-process checkpoint resumed
    on the ranks under ZeRO-1 for a second epoch, and a forged mid-epoch
    one-process checkpoint refused."""
    from marigold_tpu_torch.train.checkpoints import load_train_state

    out = {}
    for name, shard in (("rep", False), ("zero", True)):
        trainer = make_trainer(sd2, os.path.join(root, name), 1, mesh, shard)
        trainer.train()
        out[name] = {"losses": [e["loss"] for e in trainer.metrics_log]}
    trainer = make_trainer(sd2, os.path.join(root, "one_on_two"), 2, mesh, True)
    latest = os.path.join(root, "one", "ckpt", "latest")
    trainer.load_checkpoint(latest)
    _, _, _, _, saved = load_train_state(latest)
    opt, st = trainer.optimizer, trainer.state
    out["restored_blocks"] = all(
        torch.equal(getattr(st, g)[n], opt.local(n, saved[g][n]))
        for g in ("mu", "nu", "acc") for n in st.params)
    trainer.train()
    out["one_on_two"] = {"losses": [e["loss"] for e in trainer.metrics_log]}
    forged = os.path.join(root, f"forged_{mesh.rank}")
    shutil.copytree(latest, forged)
    with open(os.path.join(forged, "trainer.json")) as f:
        state = json.load(f)
    state["n_batch_in_epoch"] = 1
    with open(os.path.join(forged, "trainer.json"), "w") as f:
        json.dump(state, f)
    with pytest.raises(ValueError, match="mid-epoch by 1 process"):
        trainer.load_checkpoint(forged)
    return out


def cli_run(argv: list) -> dict:
    """setup and run of cli/train.py in this rank, each micro-batch it
    trains on recorded: -> the rank's view of the run."""
    from marigold_tpu_torch.cli import train as cli_train

    trainer, t_end = cli_train.setup(argv)
    seen, assemble = [], trainer._assemble_batch

    def recorded(batch):
        out = assemble(batch)
        seen.append({"paths": list(batch["rgb_relative_path"]),
                     **{k: v.clone() for k, v in out.items()}})
        return out

    trainer._assemble_batch = recorded
    rc = cli_train.run(trainer, t_end)
    return {"rc": rc, "seen": seen, "shard": (trainer.train_loader.shard_index,
                                              trainer.train_loader.shard_count),
            "losses": [e["loss"] for e in trainer.metrics_log if "loss" in e],
            "val": [e for e in trainer.metrics_log if "val" in e],
            "out_dir": trainer.out_dir_ckpt, "zero": trainer.optimizer.mesh is not None}


def rank_cases(mesh, spec: dict) -> dict:
    """Every rank-side case of the module, in one spawn."""
    import sys

    # TensorBoard's writer (rank 0 of the CLI) falls back to its own event
    # writer without TensorFlow, which this sandbox's site-packages would
    # otherwise spend seconds importing
    sys.modules["tensorflow"] = None
    models = port_models(spec["ckpt"])
    text = torch.from_numpy(spec["text"])
    out = {"a": {}, "b": {}}
    for name, k, accum in OPT_CASES:
        for shard in (False, True):
            out["a" if not shard else "b"][name] = run_steps(
                models, mesh, name, k, accum, spec["batches"][:2 * k],
                spec["draws"][:2 * k], text, shard)
    out["drawn"] = drawn_step(models, mesh, text, spec["batches"][0])
    out["c"] = trainer_cases(mesh, spec["sd2"], spec["trainers"])
    out["d"] = {name: cli_run(argv) for name, argv in spec["cli"].items()}
    return out


# ---------------------------------------------------------------------- #
# the parent's side


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The checkpoints, data and JAX references, then the ranks' results."""
    import jax
    import jax.numpy as jnp

    from marigold_tpu.core.scheduler import DiffusionSchedule as JSchedule
    from marigold_tpu.models import surgery as jsurgery
    from marigold_tpu.models import vae as jvae
    from marigold_tpu.models import weights as JW
    from test_torch_train_cli import _config, _write_data, write_port_sd2

    root = tmp_path_factory.mktemp("train_parallel")
    sd2 = write_port_sd2(str(root / "ckpt_base" / "sd2"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MARIGOLD_TPU_FASTLOAD", "0")
        jcfg4, jparams4 = JW.load_unet(os.path.join(sd2, "unet"))
        vae_cfg, vae_params = JW.load_vae(os.path.join(sd2, "vae"))
    jcfg, jparams = jsurgery.replace_conv_in(jcfg4, jparams4, 8)
    jsched = JSchedule.from_pretrained(os.path.join(sd2, "scheduler"))
    text = np.random.default_rng(5).standard_normal(
        (1, 2, jcfg.cross_attention_dim)).astype(np.float32)
    batches = _micro_batches(4)
    draws = []
    for i, batch in enumerate(batches):
        k_t, k_noise = jax.random.split(jax.random.PRNGKey(200 + i))
        t = jax.random.randint(k_t, (GLOBAL_B,), 0, jsched.num_train_timesteps)
        lat = jax.eval_shape(lambda x: jvae.encode_mean_scaled(vae_params, vae_cfg, x),
                             jnp.asarray(batch["gt_norm"]))
        noise = jax.random.normal(k_noise, lat.shape, jnp.float32)
        draws.append((torch.from_numpy(np.array(t)), _nchw(noise)))

    data = root / "data"
    os.makedirs(data)
    splits = _write_data(data, np.random.default_rng(0))
    cli_common = ["--base_data_dir", str(data), "--base_ckpt_dir", str(root / "ckpt_base"),
                  "--device", "cpu", "--no_wandb"]

    def cli_argv(name, cfg, *flags):
        path = root / "configs" / f"{name}.yaml"
        os.makedirs(path.parent, exist_ok=True)
        import yaml

        path.write_text(yaml.safe_dump(cfg))
        return ["--config", str(path), "--output_dir", str(root / "runs" / name),
                *cli_common, *flags]

    # (d): batches of 1 on each rank's stride, k 2, 2 iterations; (e): the
    # global batch of 2 cut over the ranks
    cfg_mh = _config("depth", splits["depth"], val=False)
    cfg_mh_zero = _config("depth", splits["depth"], val=True)
    cfg_sh = _config("depth", splits["depth"], val=False)
    # the loader's forked workers inside a rank, as the recipes run it
    cfg_sh["dataloader"] = dict(cfg_sh["dataloader"], effective_batch_size=4,
                                max_train_batch_size=2, num_workers=2)
    cli = {"mh": cli_argv("mh", cfg_mh, "--multihost", "--data_parallel",
                          "--add_datetime_prefix"),
           "mh_zero": cli_argv("mh_zero", cfg_mh_zero, "--multihost",
                               "--data_parallel", "--shard_optimizer"),
           "sh": cli_argv("sh", cfg_sh, "--data_parallel")}

    # (c): the one-process checkpoint, at the end of its one epoch
    trainers = root / "trainers"
    make_trainer(sd2, str(trainers / "one"), 1).train()
    spec = {"ckpt": sd2, "sd2": sd2, "text": text, "batches": batches,
            "draws": draws, "trainers": str(trainers), "cli": cli}
    # the ranks run while this process runs the JAX step
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(M.run_on_ranks, rank_cases, N_RANKS, (spec,),
                            store_dir=str(tmp_path_factory.mktemp("store")))
        jax_ref = jax_runs(dict(cfg=jcfg, params=jparams, vae_cfg=vae_cfg,
                                vae=vae_params, sched=jsched), spec)
        ranks = ranks.result()
    # the same configs in one process, for the loaders' streams, read inline
    # here (no fork of this multithreaded process; the loader's batches do
    # not depend on its workers, tests/test_torch_train_data.py)
    cfg_sh_one = dict(cfg_sh, dataloader=dict(cfg_sh["dataloader"], num_workers=0))
    cli_one = {"mh": cli_argv("mh_one", cfg_mh), "mh_zero": cli_argv("mh_zero_one", cfg_mh_zero),
               "sh": cli_argv("sh_one", cfg_sh_one)}
    return dict(ranks=ranks, spec=spec, root=root, cli_one=cli_one, jax=jax_ref,
                jax_params=jparams)


def jax_runs(j: dict, spec: dict) -> dict:
    """The JAX make_train_step (compute_dtype None: fp32) on one device, on
    each global batch with its key, as its two halves: its loss_and_grad,
    jitted once for both optimizers, then the optimizer's update and
    apply_updates. Per case the losses and the parameters after each
    apply."""
    import jax
    import jax.numpy as jnp
    import optax

    from marigold_tpu.train import train_step as jts
    from marigold_tpu.train.lr_schedule import iter_exponential
    from marigold_tpu_torch.models import weights as TW

    loss_and_grad = jax.jit(jts._make_loss_and_grad(
        j["cfg"], j["vae_cfg"], j["sched"], "mse_loss", None, True, None, "none",
        None))
    text = jnp.asarray(spec["text"])
    out = {}
    for name, k, accum in OPT_CASES:
        opt = jts.make_optimizer(LR, iter_exponential(*SCHED), k, name=name,
                                 accum_dtype=jnp.dtype(accum) if accum else None)
        update = jax.jit(lambda g, s, p, opt=opt: (
            lambda u, s2: (optax.apply_updates(p, u), s2))(*opt.update(g, s, p)))
        params, opt_state = j["params"], opt.init(j["params"])
        losses, applied = [], []
        for i, batch in enumerate(spec["batches"][:2 * k]):
            loss, grads = loss_and_grad(
                params, j["vae"], text, {key: jnp.asarray(v) for key, v in batch.items()},
                jax.random.PRNGKey(200 + i))
            params, opt_state = update(grads, opt_state, params)
            losses.append(float(loss))
            if (i + 1) % k == 0:
                applied.append(TW.from_jax_tree(params))
        out[name] = (losses, applied)
    return out


def test_the_halves_have_different_valid_counts(world):
    counts = [b["valid_mask"][:GLOBAL_B // 2].sum() - b["valid_mask"][GLOBAL_B // 2:].sum()
              for b in world["spec"]["batches"]]
    assert min(counts) > 100


@pytest.mark.parametrize("name", [c[0] for c in OPT_CASES])
def test_two_ranks_match_the_jax_step(world, name):
    """Each rank's logged loss (the global batch's) and its parameters after
    the first apply against the JAX step on the whole global batch."""
    losses, params = world["jax"][name]
    ranks = [r["a"][name] for r in world["ranks"]]
    for r in ranks:
        # fp32 forward of the same model, the sums over ranks: rtol 1e-5
        np.testing.assert_allclose(r["loss"], losses, rtol=1e-5)
        assert r["params"][0].keys() == params[0].keys()
        for n, p in r["params"][0].items():
            np.testing.assert_allclose(p.numpy(), params[0][n].numpy(),
                                       err_msg=n, **PARAM_TOL)
    # The first update moves each parameter by about lr in the direction
    # of its gradient's sign: the ranks' directions are JAX's, but where the
    # window's mean cancels to within the accumulator's rounding (bf16:
    # 2^-8), its sign may flip: at most 1 in 1000 entries.
    sd = port_models(world["spec"]["ckpt"])["sd"]
    got = torch.cat([(p - sd[n]).flatten() for n, p in ranks[0]["params"][0].items()])
    want = torch.cat([(params[0][n] - sd[n]).flatten() for n in ranks[0]["params"][0]])
    assert (want.abs() > 0.5 * LR).float().mean() > 0.9
    assert (torch.sign(got) != torch.sign(want)).float().mean() < 1e-3


@pytest.mark.parametrize("name", [c[0] for c in OPT_CASES])
def test_ranks_agree_bit_for_bit(world, name):
    r0, r1 = (r["a"][name] for r in world["ranks"])
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    for a, b in zip(r0["params"], r1["params"]):
        for n in a:
            assert torch.equal(a[n], b[n]), n


def test_global_draws_match_one_process(world):
    """The step's own draws (timesteps and annealed multi-resolution noise of
    the global batch, each rank keeping its rows) against one process on
    the global batch: the same loss and grad norm."""
    models = port_models(world["spec"]["ckpt"])
    one = drawn_step(models, None, torch.from_numpy(world["spec"]["text"]),
                     world["spec"]["batches"][0])
    for r in world["ranks"]:
        np.testing.assert_allclose(r["drawn"][0], one[0], rtol=1e-5)
        np.testing.assert_allclose(r["drawn"][1], one[1], rtol=1e-4)


@pytest.mark.parametrize("name", [c[0] for c in OPT_CASES])
def test_zero1_matches_the_replicated_update_bit_for_bit(world, name):
    """Two applies under ZeRO-1 against the replicated two ranks: the same
    parameters bit for bit on each rank, the same losses."""
    for r in world["ranks"]:
        rep, zero = r["a"][name], r["b"][name]
        assert len(zero["params"]) == 2
        assert zero["loss"] == rep["loss"]
        for a, b in zip(rep["params"], zero["params"]):
            for n in a:
                assert torch.equal(a[n], b[n]), n
        np.testing.assert_allclose(zero["grad_norm"], rep["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("name", [c[0] for c in OPT_CASES])
def test_zero1_layout_halves_the_split_state(world, name):
    """Each rank holds 1/2 of mu, nu (Adam) and the accumulator along the
    split axis of every leaf the rule splits, and the whole of the rest;
    Adafactor's second moments stay whole."""
    for r in world["ranks"]:
        rep, zero = r["a"][name]["layout"], r["b"][name]["layout"]
        axes = r["b"][name]["axes"]
        split = [n for n, a in axes.items() if a is not None]
        assert len(split) > len(axes) // 2
        for group, shapes in zero.items():
            for n, shape in shapes.items():
                want = list(rep[group][n])
                if axes[n] is not None and (group == "acc" or name == "adam"):
                    want[axes[n]] //= N_RANKS
                assert list(shape) == want, (group, n)


def test_zero1_axes_are_the_jax_rule(world):
    """The port's zero1_state_shardings against the JAX package's on a
    2-device mesh of the conftest's CPU devices, leaf for leaf, axes mapped
    through the layouts (HWIO and [in, out] in JAX)."""
    import jax

    from marigold_tpu.parallel.mesh import get_mesh
    from marigold_tpu.train.train_step import TrainState, zero1_state_shardings
    from marigold_tpu_torch.models import weights as TW

    shapes = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.float32), world["jax_params"])
    jshard = zero1_state_shardings(get_mesh(N_RANKS), TrainState(
        step=jax.ShapeDtypeStruct((), np.int32), params=shapes, opt_state=shapes))
    # a tree of the JAX axes, converted as weights are (a leaf's axis
    # index travels through from_jax_tree's transpose)
    specs = jax.tree_util.tree_map(
        lambda s, x: np.full(np.shape(x), -1 if all(a is None for a in s.spec)
                             else [a for a in s.spec].index("data"), np.int64),
        jshard.opt_state, world["jax_params"])
    jax_axes = TW.from_jax_tree(specs)
    port_axes = world["ranks"][0]["b"]["adam"]["axes"]
    assert port_axes.keys() == jax_axes.keys()
    perm = {4: (3, 2, 0, 1), 2: (1, 0)}  # port axis i is JAX axis perm[i]
    for n, axis in port_axes.items():
        a, ndim = int(jax_axes[n].flatten()[0]), jax_axes[n].ndim
        want = -1 if a < 0 else list(perm.get(ndim, range(ndim))).index(a)
        assert (-1 if axis is None else axis) == want, n


def _ckpt_tensors(path: str) -> dict:
    from marigold_tpu_torch.models import weights as W

    out = {f"unet.{n}": t for n, t in W.load_state_dict(os.path.join(path, "unet")).items()}
    out.update(W.read_safetensors(os.path.join(path, "opt_state.safetensors")))
    return out


def test_zero1_checkpoint_equals_the_replicated_one(world):
    """Both two-rank runs saved checkpoint/latest at the epoch's end, mid-
    window: ZeRO-1's gathered state equals the replicated state, tensor for
    tensor, and both record the two ranks."""
    root = world["spec"]["trainers"]
    rep = _ckpt_tensors(os.path.join(root, "rep", "ckpt", "latest"))
    zero = _ckpt_tensors(os.path.join(root, "zero", "ckpt", "latest"))
    assert rep.keys() == zero.keys() and any(k.startswith("acc.") for k in rep)
    for k, t in rep.items():
        assert torch.equal(t, zero[k]), k
    for name in ("rep", "zero"):
        with open(os.path.join(root, name, "ckpt", "latest", "trainer.json")) as f:
            state = json.load(f)
        assert (state["process_count"], state["n_batch_in_epoch"], state["epoch"]) \
            == (N_RANKS, 0, 2)
    r0, r1 = (r["c"] for r in world["ranks"])
    assert r0["rep"]["losses"] == r0["zero"]["losses"] == r1["zero"]["losses"]


def test_checkpoints_move_between_one_and_two_ranks(world, tmp_path):
    """The one-process checkpoint resumed on two ranks under ZeRO-1 (each
    rank restores its blocks) and the one process's own resume give the same
    second epoch; the two-rank ZeRO-1 checkpoint resumes in one process with
    every tensor as saved; a mid-epoch checkpoint of another rank count is
    refused."""
    from marigold_tpu_torch.train.checkpoints import load_train_state

    root = world["spec"]["trainers"]
    sd2 = world["spec"]["sd2"]
    assert all(r["c"]["restored_blocks"] for r in world["ranks"])
    one = make_trainer(sd2, str(tmp_path / "one"), 2)
    one.load_checkpoint(os.path.join(root, "one", "ckpt", "latest"))
    one.train()
    losses = [e["loss"] for e in one.metrics_log]
    for r in world["ranks"]:
        np.testing.assert_allclose(r["c"]["one_on_two"]["losses"], losses, rtol=1e-5)
    two = _ckpt_tensors(os.path.join(root, "one_on_two", "ckpt", "latest"))
    mine = _ckpt_tensors(str(tmp_path / "one" / "ckpt" / "latest"))
    for k in (k for k in mine if k.startswith("unet.")):
        np.testing.assert_allclose(two[k].numpy(), mine[k].numpy(), err_msg=k,
                                   **PARAM_TOL)

    zero_latest = os.path.join(root, "zero", "ckpt", "latest")
    back = make_trainer(sd2, str(tmp_path / "back"), 2)
    back.load_checkpoint(zero_latest)
    _, params, _, _, opt = load_train_state(zero_latest)
    st = back.state
    for n, p in params.items():
        assert torch.equal(st.params[n].detach(), p), n
        for g in ("mu", "nu", "acc"):
            assert torch.equal(getattr(st, g)[n], opt[g][n]), (g, n)
    back.train()  # its window restarts at the resume, as in one rank's
    assert back.state.count == 2 and all(np.isfinite(e["loss"]) for e in back.metrics_log)

    forged = tmp_path / "forged"
    shutil.copytree(zero_latest, forged)
    with open(forged / "trainer.json") as f:
        state = json.load(f)
    state["n_batch_in_epoch"] = 1
    with open(forged / "trainer.json", "w") as f:
        json.dump(state, f)
    with pytest.raises(ValueError, match="mid-epoch by 2 process"):
        back.load_checkpoint(str(forged))


def one_process_stream(argv: list, epochs: int = 1) -> list:
    """(paths, assembled batch) of each batch the one-process CLI's loader
    yields over `epochs` epochs (setup only: nothing trains, nothing goes
    to TensorBoard)."""
    from marigold_tpu_torch.cli import train as cli_train
    from marigold_tpu_torch.utils.logging_util import tb_logger

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb_logger, "set_dir", lambda log_dir: None)
        trainer, _ = cli_train.setup(argv)
    return [(list(b["rgb_relative_path"]), trainer._assemble_batch(b))
            for _ in range(epochs) for b in trainer.train_loader]


def _run_dirs(world, name) -> list:
    return [d for d in (world["root"] / "runs" / name).iterdir() if d.is_dir()]


@pytest.mark.parametrize("name", ["mh", "mh_zero"])
def test_multihost_cli_strides_the_stream(world, name):
    """cli/train.py --multihost --data_parallel in the ranks' group: one run
    dir with rank 0's marker; rank r takes batches r, r + 2, ... of the
    shared stream; both ranks log the same losses; rank 0 alone writes the
    checkpoints and (with --shard_optimizer) validates."""
    d0, d1 = (r["d"][name] for r in world["ranks"])
    assert d0["rc"] == d1["rc"] == 0
    assert (d0["shard"], d1["shard"]) == ((0, 2), (1, 2))
    assert d0["zero"] == d1["zero"] == (name == "mh_zero")
    runs = _run_dirs(world, name)
    assert len(runs) == 1 and d0["out_dir"] == d1["out_dir"] == str(runs[0] / "checkpoint")
    marker = (runs[0] / ".run_marker").read_text()
    if name == "mh":  # --add_datetime_prefix: rank 0's token
        assert runs[0].name == f"{marker}-mh"
    assert (runs[0] / "checkpoint" / "latest" / "opt_state.safetensors").exists()
    assert (runs[0] / "checkpoint" / "iter_000002" / "unet").exists()
    assert d0["losses"] == d1["losses"] and len(d0["losses"]) == 2
    assert all(np.isfinite(d0["losses"]))
    with open(runs[0] / "checkpoint" / "latest" / "trainer.json") as f:
        assert json.load(f)["process_count"] == 2
    # 2 iterations of k=2 on each rank: 2 epochs of the shared stream of 4
    # batches of 1, of which rank r takes batches r and r + 2
    stream = [paths for paths, _ in one_process_stream(world["cli_one"][name], 2)]
    assert len(stream) == 8
    assert [s["paths"] for s in d0["seen"]] == stream[0::2]
    assert [s["paths"] for s in d1["seen"]] == stream[1::2]
    if name == "mh_zero":
        assert len(d0["val"]) == 1 and not d1["val"]
        assert (runs[0] / "checkpoint" / "best" / "unet").exists()
    assert (runs[0] / "logging.log").exists()


def test_single_host_data_parallel_cuts_the_global_batch(world):
    """cli/train.py --data_parallel in the ranks' group: each micro-step the
    ranks' rows, concatenated in rank order, are the one-process loader's
    batch, array for array."""
    from marigold_tpu_torch.cli import train as cli_train

    d0, d1 = (r["d"]["sh"] for r in world["ranks"])
    assert d0["rc"] == d1["rc"] == 0 and d0["shard"] == d1["shard"] == (0, 1)
    assert d0["losses"] == d1["losses"] and len(d0["losses"]) == 2
    assert len(_run_dirs(world, "sh")) == 1
    stream = one_process_stream(world["cli_one"]["sh"], 2)
    assert len(stream) == len(d0["seen"]) == 4  # 2 iterations of k=2
    for (paths, batch), a, b in zip(stream, d0["seen"], d1["seen"]):
        assert a["paths"] + b["paths"] == paths
        for k, t in batch.items():
            assert torch.equal(torch.cat([a[k], b[k]]), t), k
