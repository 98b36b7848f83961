"""The training step: frozen-VAE latent diffusion fine-tuning.

Counterpart of `marigold_tpu/train/train_step.py`. Per micro-step: VAE
encode of RGB and target under `no_grad`, a per-sample random timestep,
(optionally annealed multi-resolution) noise, DDPM `add_noise`, the UNet
forward on [rgb_latent, noisy_latent], the target of the schedule's
prediction type, and the latent loss masked by the 8x max-pooled valid
mask; then the gradients of the fp32 master parameters.

Mixed precision as in the JAX package: the fp32 masters are cast to
`compute_dtype` inside the differentiated function
(`torch.func.functional_call` of the UNet module with the cast tensors), so
the matmuls and convs run in bf16 and the gradients arrive in fp32 through
the cast; latents, targets and the loss stay fp32. `torch.autocast` is not
used: its per-op casts follow another policy. `grad_dtype` (e.g. bf16)
differentiates with respect to the cast parameters instead, so the
gradients are stored in that dtype; the forward runs in `compute_dtype`
whatever `grad_dtype` says (the JAX package runs it in `grad_dtype` when
`compute_dtype` is None, a fault the port does not copy).

Remat modes for the UNet forward, as `_apply_remat` in the JAX package:
"none" keeps every activation, "full" recomputes the forward in the
backward (`torch.utils.checkpoint`), "save_heavy" recomputes only the
elementwise chains: a selective-checkpoint policy keeps the outputs of
matmuls, convolutions and the flash lse forward (the dispatcher op
`ops/flash_attention.py:flash_attention_lse_op`), so the flash forward does
not launch again in the backward. Both run block by block: each down
block, the mid block and each up block of the UNet is its own checkpoint
region (`models/unet.py`'s `block_runner`), whose outputs, the skip
connections among them, are saved, so the backward recomputes and holds one
region's activations at a time; XLA's recompute in the reference is
scheduled per consumer, and this is the port's nearest eager form. One
checkpoint around the whole forward would recompute every activation at
the start of the backward and hold them all, saving no memory. A region
recomputed in the backward runs after `functional_call` has restored the
module's own parameters, so each region substitutes its block's cast
parameters itself.

The optimizers have optax's semantics: Adam (b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias correction) and Adafactor
(`optax.adafactor(lr, multiply_by_parameter_scale=False,
clipping_threshold=1.0)` with its defaults: decay rate 0.8, factored second
moments for tensors whose two largest dims are >= 128, eps 1e-30, block-RMS
clipping at 1, no momentum, no weight decay), learning rate lr *
schedule(count) with count the number of updates already applied, behind
k-step gradient accumulation that averages like `optax.MultiSteps`.
Accumulation is always the two-step shape of the JAX package's
`make_accum_pair`: `micro_step` adds a micro-batch's gradients to the
accumulator, `apply_step` applies the mean at each k-th micro-step, so
`split_accum` true and false are one implementation here. `accum_dtype`
(e.g. bf16) keeps the running sum in that dtype, as the JAX
`gradient_accumulation` does. Between windows the accumulator is freed.

Data parallel over a `parallel.mesh.Mesh` of several ranks (the JAX step
sharded over its `data` mesh, where XLA inserts the psum): each rank runs
its rows of the global batch and draws the timesteps and noise of the whole
global batch from the micro-step's generator (seeded alike on every rank),
keeping its own rows, as the JAX step draws them from one key; the masked
loss divides by the global batch's mask count (all-reduced before the
backward), so each rank's loss is its share of the global loss and the
gradients are summed over the ranks, in their own dtype, in flat buckets of
BUCKET_BYTES (one collective each). ZeRO-1 (`shard_states`): Adam's mu and
nu and the window accumulator are split along the axis
`zero1_state_shardings` picks for each parameter; each micro-step's
gradient is reduce-scattered into the rank's block of the accumulator, each
rank updates its block of the masters and the ranks all-gather them.
Adafactor's factored second moments need whole rows and columns: under
ZeRO-1 only its accumulator is split, and each apply gathers the window's
whole gradient and runs the replicated update on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from marigold_tpu_torch.core.scheduler import DiffusionSchedule
# imported for its dispatcher op, which SAVE_HEAVY_OPS names
from marigold_tpu_torch.ops import flash_attention  # noqa: F401
from marigold_tpu_torch.parallel.mesh import AXIS, Mesh
from marigold_tpu_torch.train.loss import get_loss
from marigold_tpu_torch.train.multi_res_noise import multi_res_noise_like

# the size of one collective's flat buffer when gradients, parameters or
# optimizer state cross the ranks (about 700 UNet tensors)
BUCKET_BYTES = 1 << 27


def as_dtype(name) -> Optional[torch.dtype]:
    """A config dtype ("bfloat16", a torch.dtype or None) -> torch.dtype."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype: {name!r}")
    return dtype


def downsample_valid_mask(valid_mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """[B, 1, H, W] bool -> [B, 1, H/f, W/f]: a latent pixel is valid iff no
    invalid pixel falls in its f x f window (max-pool of the invalid mask,
    VALID windows)."""
    invalid = (~valid_mask.bool()).float()
    return F.max_pool2d(invalid, factor, factor) < 0.5


# The ops whose outputs "save_heavy" keeps: the products whose recompute
# costs real FLOPs (the JAX policy's dot_general, conv_general_dilated and
# the flash custom_vjp call).
_aten = torch.ops.aten
SAVE_HEAVY_OPS = frozenset({
    _aten.mm.default, _aten.addmm.default, _aten.bmm.default,
    _aten.baddbmm.default, _aten.convolution.default,
    torch.ops.marigold_tpu_torch.flash_attention_lse.default,
})


def _save_heavy_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVE_HEAVY_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_runner(remat) -> Callable:
    """-> run(fn, *args): fn(*args) as one region under the remat mode,
    "none"/False/None (a plain call), "full"/True or "save_heavy" (its own
    checkpoint; module docstring)."""
    if remat in (False, None, "none"):
        return lambda fn, *args: fn(*args)
    if remat in (True, "full"):
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)
    if remat == "save_heavy":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _save_heavy_policy)
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False,
                                            context_fn=context)
    raise ValueError(f"unknown remat mode: {remat!r}")


def unet_block_runner(unet: torch.nn.Module, params: dict,
                      run: Callable) -> Callable:
    """The UNet forward's `block_runner` for remat: each down, mid and up
    block through `run` (`remat_runner`), on its own entries of `params`
    (name -> tensor, the UNet's parameter names) by `functional_call`, so
    that the region recomputed in the backward, after the outer
    `functional_call` has returned, still runs on them."""
    prefixes = {id(m): name + "." for name, m in unet.named_modules()
                if name == "mid_block" or
                name.rsplit(".", 1)[0] in ("down_blocks", "up_blocks")}
    block_params = {
        key: {n[len(prefix):]: t for n, t in params.items()
              if n.startswith(prefix)}
        for key, prefix in prefixes.items()}

    def block_runner(region, block, *args):
        mine = block_params[id(block)]
        return run(lambda *a: torch.func.functional_call(
            block, mine, (region, *a)), *args)

    return block_runner


def make_loss_and_grad(
    unet: torch.nn.Module,
    vae: torch.nn.Module,
    schedule: DiffusionSchedule,
    loss_name: str = "mse_loss",
    multi_res_noise_cfg: Optional[dict] = None,
    use_mask: bool = True,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    remat="none",
    grad_dtype=None,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """-> loss_and_grad(params, text_embed, batch, generator=None,
    timesteps=None, noise=None) -> (loss, grads).

    params: name -> fp32 master tensor (the UNet's parameter names);
    `unet` is only the module skeleton run by functional_call. batch:
    rgb_norm [B, 3, H, W] and gt_norm [B, 3k, H, W] in [-1, 1], optional
    valid_mask [B, 1, H, W] bool, on the model's device; each 3-channel
    group of gt_norm is encoded on its own and the latents concatenated
    (IID targets). timesteps [B] and noise (the latent-shaped fp32 noise)
    are drawn from `generator` unless given, so a test can pass the JAX
    package's draws. Returns the fp32 loss (0-d) and name -> gradient,
    fp32 or `grad_dtype`. With a mesh of several ranks (module docstring)
    the batch is this rank's rows of the global batch, the draws made here
    are the global batch's (given timesteps and noise are this rank's
    rows), and the loss and gradients are this rank's share of the global
    batch's: their sums over the ranks are the global ones."""
    loss_inner = get_loss(loss_name)
    ds = vae.cfg.downscale_factor
    grad_dtype = as_dtype(grad_dtype)
    run_region = remat_runner(remat)
    blockwise = remat not in (False, None, "none")
    sharded = mesh is not None and mesh.size > 1

    def encode(x: torch.Tensor) -> torch.Tensor:
        dtype = next(vae.parameters()).dtype
        return vae.encode_mean_scaled(x.to(dtype))

    def loss_and_grad(params: dict, text_embed: torch.Tensor, batch: dict,
                      generator: Optional[torch.Generator] = None,
                      timesteps: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None):
        rgb, gt = batch["rgb_norm"], batch["gt_norm"]
        bsz, device = rgb.shape[0], rgb.device
        with torch.no_grad():  # the frozen encoder: no gradient into the VAE
            rgb_latent = encode(rgb)
            gt_latent = torch.cat(
                [encode(gt[:, 3 * i:3 * i + 3]) for i in range(max(gt.shape[1] // 3, 1))],
                dim=1).float()
        n_all = bsz * mesh.size if sharded else bsz  # the global batch
        rows = mesh.rows(n_all) if sharded else slice(None)
        t_all = None
        if timesteps is None:
            t_all = torch.randint(0, schedule.num_train_timesteps, (n_all,),
                                  generator=generator, device=device)
            timesteps = t_all[rows]
        timesteps = timesteps.to(device)
        if noise is None:
            if t_all is None:  # the annealed strengths of every row
                t_all = mesh.all_gather(timesteps) if sharded else timesteps
            noise = _draw_noise(gt_latent.new_empty((n_all,) + gt_latent.shape[1:]),
                                t_all, schedule, multi_res_noise_cfg,
                                generator)[rows]
        noise = noise.to(device=device, dtype=torch.float32)
        noisy = schedule.add_noise(gt_latent, noise, timesteps)
        target = schedule.training_target(gt_latent, noise, timesteps)
        mask = None
        if use_mask and "valid_mask" in batch:
            mask = downsample_valid_mask(batch["valid_mask"], ds).expand(
                -1, gt_latent.shape[1], -1, -1)

        names = list(params)
        with torch.enable_grad():
            cast = {n: params[n].to(compute_dtype or params[n].dtype)
                    for n in names}
            x = torch.cat([rgb_latent, noisy.to(rgb_latent.dtype)], dim=1)
            x = x.to(cast["conv_in.weight"].dtype)

            kwargs = ({"block_runner": unet_block_runner(unet, cast, run_region)}
                      if blockwise else {})
            pred = torch.func.functional_call(
                unet, cast, (x, timesteps, text_embed), kwargs).float()
            if mask is not None:
                diff = loss_inner(pred, target, reduction="none")
                n = mask.sum()
                if sharded:  # the global batch's count, as the JAX step's
                    n = mesh.all_reduce(n)
                loss = torch.where(mask, diff, torch.zeros_like(diff)).sum() / \
                    n.clamp(min=1)
            elif sharded:  # the local sum over the global element count
                loss = loss_inner(pred, target, reduction="none").sum() / (
                    pred.numel() * mesh.size)
            else:
                loss = loss_inner(pred, target, reduction="mean")
            # grad_dtype: the gradients of the cast parameters, stored in
            # grad_dtype (no fp32 copy when it is the compute dtype)
            wrt = cast if grad_dtype is not None else params
            grads = torch.autograd.grad(loss, [wrt[n] for n in names],
                                        allow_unused=True)
        grads = {n: (torch.zeros_like(wrt[n]) if g is None else g).to(
                     grad_dtype or torch.float32)
                 for n, g in zip(names, grads)}
        return loss.detach(), grads

    return loss_and_grad


def _draw_noise(gt_latent, timesteps, schedule, multi_res_noise_cfg, generator):
    if multi_res_noise_cfg is None:
        return torch.randn(gt_latent.shape, generator=generator,
                           device=gt_latent.device, dtype=torch.float32)
    strength = torch.full((gt_latent.shape[0],),
                          float(multi_res_noise_cfg.get("strength", 0.9)),
                          dtype=torch.float32, device=gt_latent.device)
    if multi_res_noise_cfg.get("annealed", False):
        strength = strength * (timesteps.float() / schedule.num_train_timesteps)
    return multi_res_noise_like(
        gt_latent, strength,
        multi_res_noise_cfg.get("downscale_strategy", "original"), generator)


# ---------------------------------------------------------------------- #
# ZeRO-1 layout and the collectives of the step


# The axis order of the JAX package's layout of the port's 4-D (HWIO for
# OIHW) and 2-D ([in, out] for [out, in]) parameters
# (`models/weights.py:from_jax_tree`)
_JAX_AXIS_ORDER = {4: (2, 3, 1, 0), 2: (1, 0)}


def zero1_state_shardings(mesh: Mesh, params: dict, axis_name: str = AXIS) -> dict:
    """ZeRO-1's layout, the rule of `marigold_tpu/train/train_step.py:
    zero1_state_shardings`: name -> the axis of that parameter's optimizer
    state (Adam's mu and nu, the window accumulator) along which each rank
    keeps 1/n of it, or None where it stays whole. The axis is the largest
    one whose size n divides (and is >= n); between axes of equal size, the
    one the JAX layout stores first, so that both packages split the same
    axis of a tensor (the UNet has no embedding table, whose 2-D layout
    both share)."""
    n = mesh.shape[axis_name]
    out = {}
    for name, p in params.items():
        shape = tuple(p.shape)
        best = None
        for ax in _JAX_AXIS_ORDER.get(len(shape), range(len(shape))):
            if shape[ax] % n == 0 and shape[ax] >= n and (
                    best is None or shape[ax] > shape[best]):
                best = ax
        out[name] = best
    return out


def _block_shape(shape, axis: int, n: int) -> torch.Size:
    shape = list(shape)
    shape[axis] //= n
    return torch.Size(shape)


def _blocks(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """t's n blocks along axis, each flattened in its own layout:
    [n, t.numel() // n]."""
    return t.unflatten(axis, (n, -1)).movedim(axis, 0).reshape(n, -1)


def _from_blocks(rows: torch.Tensor, axis: int, shape) -> torch.Tensor:
    """The inverse of _blocks: [n, numel // n] -> the tensor of `shape`."""
    n = rows.shape[0]
    block = _block_shape(shape, axis, n)
    return rows.reshape(n, *block).movedim(0, axis).reshape(shape)


def _buckets(names: list, tensors: dict) -> list:
    """names in order, cut into runs of at most BUCKET_BYTES (a larger
    tensor is a run of its own)."""
    out, run, size = [], [], 0
    for n in names:
        b = tensors[n].numel() * tensors[n].element_size()
        if run and size + b > BUCKET_BYTES:
            out.append(run)
            run, size = [], 0
        run.append(n)
        size += b
    return out + [run] if run else out


def _unpack(flat: torch.Tensor, names: list, shapes: dict) -> dict:
    out, o = {}, 0
    for n in names:
        k = shapes[n].numel()
        out[n] = flat[o:o + k].view(shapes[n])
        o += k
    return out


def reduce_gradients(mesh: Mesh, grads: dict, axes: dict) -> dict:
    """The sum over the ranks of each gradient, in its own dtype (as the JAX
    psum): whole where axes gives None (all-reduce), else this rank's block
    along that axis (reduce-scatter, ZeRO-1). One collective per flat
    bucket; `grads` is emptied as it is packed."""
    names = list(grads)
    shapes = {n: g.shape for n, g in grads.items()}
    whole = [n for n in names if axes.get(n) is None]
    split = [n for n in names if axes.get(n) is not None]
    out = {}
    for run in _buckets(whole, grads):
        flat = mesh.all_reduce(torch.cat([grads.pop(n).reshape(-1) for n in run]))
        out.update(_unpack(flat, run, shapes))
    for run in _buckets(split, grads):
        rows = torch.cat([_blocks(grads.pop(n), axes[n], mesh.size) for n in run], 1)
        out.update(_unpack(mesh.reduce_scatter(rows, 0)[0], run, {
            n: _block_shape(shapes[n], axes[n], mesh.size) for n in run}))
    return {n: out[n] for n in names}


@torch.no_grad()
def broadcast_params(mesh: Mesh, params: dict) -> dict:
    """params with rank 0's values on every rank, in place: one broadcast
    per flat bucket."""
    shapes = {n: p.shape for n, p in params.items()}
    for run in _buckets(list(params), params):
        flat = torch.cat([params[n].detach().reshape(-1) for n in run])
        mesh.broadcast(flat)
        for n, t in _unpack(flat, run, shapes).items():
            params[n].copy_(t)
    return params


def _gathered(mesh: Mesh, blocks: dict, axes: dict, shapes: dict):
    """(name, the whole tensor): every rank's block of each tensor in
    `blocks`, joined along axes[name]; one all_gather per flat bucket (every
    rank iterates to the end)."""
    for run in _buckets(list(blocks), blocks):
        rows = mesh.all_gather(torch.cat([blocks[n].reshape(-1) for n in run])[None], 0)
        o = 0
        for n in run:
            k = blocks[n].numel()
            yield n, _from_blocks(rows[:, o:o + k], axes[n], shapes[n])
            o += k


# ---------------------------------------------------------------------- #
# optimizer state


@dataclasses.dataclass
class TrainState:
    """fp32 master parameters and the optimizer state, by parameter name.

    step counts micro-steps (as the JAX TrainState.step does), count the
    updates applied, mini_step the micro-steps of the current window; acc
    is the window's gradient sum (None between windows). Adam keeps mu and
    nu; Adafactor keeps v_row and v_col for factored tensors and v for the
    others. Under ZeRO-1 acc (and Adam's mu and nu) hold this rank's block
    of each tensor the optimizer's `axes` split."""

    params: dict
    mu: dict = dataclasses.field(default_factory=dict)
    nu: dict = dataclasses.field(default_factory=dict)
    step: int = 0
    count: int = 0
    mini_step: int = 0
    acc: Optional[dict] = None
    v_row: dict = dataclasses.field(default_factory=dict)
    v_col: dict = dataclasses.field(default_factory=dict)
    v: dict = dataclasses.field(default_factory=dict)


class _AccumulatingOptimizer:
    """k-step accumulation (optax.MultiSteps' mean, the JAX
    `gradient_accumulation` running sum in `accum_dtype`) in front of one
    update rule. Updates run in place under no_grad.

    With `shard_states` on a mesh of several ranks, ZeRO-1 (module
    docstring): `axes` (set by init and restore) is the
    zero1_state_shardings layout of the parameters; without such a mesh
    shard_states is ignored, as in the JAX trainer."""

    groups: tuple = ()  # the TrainState fields of the update rule
    split_groups: tuple = ()  # those ZeRO-1 splits (besides acc)

    def __init__(self, lr: float, lr_schedule_fn: Optional[Callable] = None,
                 accumulation_steps: int = 1, accum_dtype=None,
                 mesh: Optional[Mesh] = None, shard_states: bool = False):
        self.lr = float(lr)
        self.lr_schedule_fn = lr_schedule_fn
        self.k = int(accumulation_steps)
        # as in the JAX make_optimizer, a narrower accumulator only exists
        # behind accumulation
        self.accum_dtype = as_dtype(accum_dtype) if self.k > 1 else None
        self.mesh = mesh if shard_states and mesh is not None and mesh.size > 1 \
            else None
        self.axes: dict = {}
        self.shapes: dict = {}

    def learning_rate(self, count: int) -> float:
        """lr at the update that follows `count` applied updates."""
        if self.lr_schedule_fn is None:
            return self.lr
        return float(np.float32(self.lr) * np.float32(self.lr_schedule_fn(count)))

    def _layout(self, params: dict) -> None:
        self.shapes = {n: p.shape for n, p in params.items()}
        self.axes = (zero1_state_shardings(self.mesh, params)
                     if self.mesh is not None else {})

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of t (a view) where ZeRO-1 splits `name`, else
        t."""
        axis = self.axes.get(name)
        if axis is None:
            return t
        per = t.shape[axis] // self.mesh.size
        return t.narrow(axis, self.mesh.rank * per, per)

    def init(self, params: dict) -> TrainState:
        """A fresh state; under ZeRO-1 built block by block (the whole state
        never exists on one rank)."""
        self._layout(params)
        return self._init(params)

    def _init(self, params: dict) -> TrainState:
        raise NotImplementedError

    def export(self, state: TrainState) -> dict:
        """The optimizer state as train/checkpoints.py stores it: whole
        tensors, gathered (to the host) under ZeRO-1, which makes it a
        collective of every rank."""
        out = {**{g: getattr(state, g) for g in self.groups},
               "acc": state.acc, "count": state.count,
               "mini_step": state.mini_step}
        if self.mesh is None:
            return out
        for g in self.split_groups + (("acc",) if state.acc is not None else ()):
            whole = {n: t for n, t in out[g].items() if self.axes[n] is None}
            split = {n: t for n, t in out[g].items() if self.axes[n] is not None}
            whole.update((n, t.cpu()) for n, t in
                         _gathered(self.mesh, split, self.axes, self.shapes))
            out[g] = {n: whole[n] for n in out[g]}
        return out

    def restore(self, params: dict, opt_state: Optional[dict],
                device) -> TrainState:
        """A TrainState from checkpointed masters and optimizer state (a
        fresh state when opt_state is None), re-split under ZeRO-1 whatever
        the rank count that wrote it."""
        if opt_state is None:
            return self.init(params)
        groups = {g: opt_state.get(g) or {} for g in self.groups}
        if set().union(*groups.values()) != set(params):
            raise ValueError("the checkpoint's optimizer state does not cover the "
                             "parameters: it was written by another optimizer "
                             f"than {type(self).__name__}")
        self._layout(params)

        def on(group: dict, split: bool) -> dict:
            return {n: (self.local(n, t) if split else t).to(device, copy=True)
                    for n, t in group.items()}

        return TrainState(
            params=params, count=opt_state["count"],
            mini_step=opt_state["mini_step"],
            acc=None if opt_state["acc"] is None else on(opt_state["acc"], True),
            **{g: on(t, g in self.split_groups) for g, t in groups.items()})

    @torch.no_grad()
    def accumulate(self, state: TrainState, grads: dict) -> None:
        """Adds one micro-step's gradients (reduced over the ranks: under
        ZeRO-1 the rank's blocks) to the window's sum (in accum_dtype: each
        gradient rounded to it, then the sum rounded, as
        `a + g.astype(a.dtype)` in the JAX package)."""
        dtype = self.accum_dtype or torch.float32
        if state.acc is None:
            state.acc = {n: g.to(dtype) for n, g in grads.items()}
        else:
            for n, g in grads.items():
                state.acc[n].add_(g.to(dtype))
        state.step += 1
        state.mini_step += 1

    @torch.no_grad()
    def apply(self, state: TrainState) -> None:
        """One update with the mean of the window's gradients (fp32); frees
        the accumulator. Under ZeRO-1 a collective of every rank."""
        if state.acc is None:
            raise RuntimeError("apply without accumulated gradients")
        scalars = self._scalars(state.count)
        acc, state.acc = state.acc, None
        if self.mesh is not None and not self.split_groups:
            # the update rule needs whole tensors: the window's whole sum
            split = {n: acc.pop(n) for n in list(acc) if self.axes[n] is not None}
            acc.update(_gathered(self.mesh, split, self.axes, self.shapes))
        blocks = {}
        for n, p in state.params.items():
            g = acc.pop(n).float()
            if self.k > 1:
                g.div_(self.k)
            if self.mesh is not None and self.split_groups and \
                    self.axes[n] is not None:
                # this rank's block of the update (mu, nu hold their blocks)
                p = blocks[n] = self.local(n, p).clone(
                    memory_format=torch.contiguous_format)
            self._update(state, n, p, g, *scalars)
        for n, whole in _gathered(self.mesh, blocks, self.axes, self.shapes):
            state.params[n].copy_(whole)
        state.count += 1
        state.mini_step = 0

    def _scalars(self, count: int) -> tuple:
        """The update's host scalars after `count` applied updates."""
        raise NotImplementedError

    def _update(self, state: TrainState, n: str, p: torch.Tensor,
                g: torch.Tensor, *scalars) -> None:
        raise NotImplementedError


class Adam(_AccumulatingOptimizer):
    """optax.adam's semantics and defaults."""

    b1, b2, eps = 0.9, 0.999, 1e-8
    groups = split_groups = ("mu", "nu")

    def _init(self, params: dict) -> TrainState:
        return TrainState(
            params=params,
            mu={n: torch.zeros_like(self.local(n, p)) for n, p in params.items()},
            nu={n: torch.zeros_like(self.local(n, p)) for n, p in params.items()},
        )

    def _scalars(self, count):
        """(lr, bias corrections 1 and 2), in fp32 as optax computes them."""
        t = np.float32(count + 1)
        return (self.learning_rate(count),
                float(1.0 - np.float32(self.b1) ** t),
                float(1.0 - np.float32(self.b2) ** t))

    def _update(self, state, n, p, g, lr, bc1, bc2):
        mu, nu = state.mu[n], state.nu[n]
        mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        denom = (nu / bc2).sqrt_().add_(self.eps)
        p.sub_((mu / bc1).div_(denom), alpha=lr)


class Adafactor(_AccumulatingOptimizer):
    """optax.adafactor(lr, multiply_by_parameter_scale=False,
    clipping_threshold=1.0) with optax's other defaults.

    A tensor is factored over its two largest dims (d1 second, d0 largest,
    chosen by `np.argsort` of the shape as optax chooses them) when the
    second is >= min_dim_size_to_factor: v_row averages g^2 over d0, v_col
    over d1. The port's layouts (OIHW, [out, in]) differ from the JAX
    package's (HWIO, [in, out]), so the two may factor a tensor with d0 and
    d1 swapped; the estimate v_row * v_col / mean(v_row) is symmetric in
    them, so the update is the same up to rounding."""

    decay_rate, eps, min_dim_size_to_factor, clipping_threshold = (
        0.8, 1e-30, 128, 1.0)
    groups = ("v_row", "v_col", "v")  # whole on every rank under ZeRO-1

    def factored_dims(self, shape) -> Optional[tuple[int, int]]:
        """(d1, d0) of optax's `_factored_dims`, or None."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim_size_to_factor:
            return None
        return int(order[-2]), int(order[-1])

    def _init(self, params: dict) -> TrainState:
        state = TrainState(params=params)
        for n, p in params.items():
            dims = self.factored_dims(tuple(p.shape))
            if dims is None:
                state.v[n] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                state.v_row[n] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                state.v_col[n] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        return state

    def _scalars(self, count):
        """(lr, decay, 1 - decay): optax's _decay_rate_pow, in fp32."""
        decay = np.float32(1.0) - np.float32(count + 1) ** np.float32(
            -self.decay_rate)
        return self.learning_rate(count), float(decay), float(np.float32(1.0) - decay)

    def _update(self, state, n, p, g, lr, keep, take):
        g2 = g * g + self.eps
        dims = self.factored_dims(tuple(p.shape))
        if dims is None:
            v = state.v[n].mul_(keep).add_(g2, alpha=take)
            u = g * v.rsqrt()
        else:
            d1, d0 = dims
            v_row = state.v_row[n].mul_(keep).add_(g2.mean(d0), alpha=take)
            v_col = state.v_col[n].mul_(keep).add_(g2.mean(d1), alpha=take)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt_()
            u = g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        del g2
        rms = u.square().mean().sqrt()
        u.div_(torch.clamp(rms / self.clipping_threshold, min=1.0))
        p.sub_(u, alpha=lr)


_OPTIMIZERS = {"adam": Adam, "adafactor": Adafactor}


def make_optimizer(lr: float, lr_schedule_fn: Optional[Callable] = None,
                   accumulation_steps: int = 1, name: str = "adam",
                   accum_dtype=None, mesh: Optional[Mesh] = None,
                   shard_states: bool = False) -> _AccumulatingOptimizer:
    """Adam (the reference's optimizer) or Adafactor, with the schedule and
    k-step accumulation, the running sum in accum_dtype (fp32 when None);
    shard_states: ZeRO-1 over `mesh` (ignored without a mesh of several
    ranks)."""
    cls = _OPTIMIZERS.get(name.lower())
    if cls is None:
        raise ValueError(f"unknown optimizer: {name}")
    return cls(lr, lr_schedule_fn, accumulation_steps, accum_dtype, mesh,
               shard_states)


def global_norm(grads: dict, mesh: Optional[Mesh] = None,
                axes: Optional[dict] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, fp32 (optax's
    global_norm of the upcast gradients). Where `axes` splits a gradient
    (ZeRO-1's blocks), the blocks' squares are summed over the mesh."""
    norms = {n: torch.linalg.vector_norm(g.float()) for n, g in grads.items()}
    split = [norms.pop(n) for n in list(norms) if (axes or {}).get(n) is not None]
    if not split:
        return torch.linalg.vector_norm(torch.stack(list(norms.values())))
    sq = mesh.all_reduce(torch.stack(split).square().sum())
    if norms:
        sq = sq + torch.stack(list(norms.values())).square().sum()
    return sq.sqrt()


def make_train_step(unet, vae, schedule: DiffusionSchedule,
                    optimizer: _AccumulatingOptimizer,
                    mesh: Optional[Mesh] = None, **loss_kwargs):
    """-> (micro_step, apply_step).

    micro_step(state, text_embed, batch, generator=None, timesteps=None,
    noise=None) -> {"loss", "grad_norm"} (0-d fp32 device tensors) computes
    one micro-batch's loss and gradients and adds them to the accumulator;
    apply_step(state) applies the update with their mean. The caller runs
    apply_step after every `optimizer.k`-th micro_step. With a mesh of
    several ranks, every rank calls both at once on its rows of the global
    batch; the gradients are reduced over the ranks (into the optimizer's
    ZeRO-1 blocks where it splits them) before they are accumulated, and
    the loss and grad_norm are the global batch's."""
    if optimizer.mesh is not None and optimizer.mesh is not mesh:
        raise ValueError("the optimizer's ZeRO-1 mesh is not the step's mesh")
    loss_and_grad = make_loss_and_grad(unet, vae, schedule, mesh=mesh,
                                       **loss_kwargs)
    sharded = mesh is not None and mesh.size > 1

    def micro_step(state: TrainState, text_embed, batch, generator=None,
                   timesteps=None, noise=None) -> dict:
        loss, grads = loss_and_grad(state.params, text_embed, batch,
                                    generator, timesteps, noise)
        if sharded:
            grads = reduce_gradients(mesh, grads, optimizer.axes)
            loss = mesh.all_reduce(loss)
        metrics = {"loss": loss,
                   "grad_norm": global_norm(grads, mesh, optimizer.axes)}
        optimizer.accumulate(state, grads)
        return metrics

    return micro_step, optimizer.apply
