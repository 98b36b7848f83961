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

Not ported (ROADMAP queue 1, "Multi-GPU"): ZeRO-sharded optimizer state;
asking for it raises NotImplementedError.
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
from marigold_tpu_torch.train.loss import get_loss
from marigold_tpu_torch.train.multi_res_noise import multi_res_noise_like

ROADMAP_MULTI_GPU = "ROADMAP queue 1, 'Multi-GPU'"


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {ROADMAP_MULTI_GPU}")


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
    fp32 or `grad_dtype`."""
    loss_inner = get_loss(loss_name)
    ds = vae.cfg.downscale_factor
    grad_dtype = as_dtype(grad_dtype)
    run_region = remat_runner(remat)
    blockwise = remat not in (False, None, "none")

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
        if timesteps is None:
            timesteps = torch.randint(0, schedule.num_train_timesteps, (bsz,),
                                      generator=generator, device=device)
        timesteps = timesteps.to(device)
        if noise is None:
            noise = _draw_noise(gt_latent, timesteps, schedule,
                                multi_res_noise_cfg, generator)
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
                n = mask.sum().clamp(min=1)
                loss = torch.where(mask, diff, torch.zeros_like(diff)).sum() / n
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
# optimizer state


@dataclasses.dataclass
class TrainState:
    """fp32 master parameters and the optimizer state, by parameter name.

    step counts micro-steps (as the JAX TrainState.step does), count the
    updates applied, mini_step the micro-steps of the current window; acc
    is the window's gradient sum (None between windows). Adam keeps mu and
    nu; Adafactor keeps v_row and v_col for factored tensors and v for the
    others."""

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
    update rule. Updates run in place under no_grad."""

    groups: tuple = ()  # the TrainState fields of the update rule

    def __init__(self, lr: float, lr_schedule_fn: Optional[Callable] = None,
                 accumulation_steps: int = 1, accum_dtype=None):
        self.lr = float(lr)
        self.lr_schedule_fn = lr_schedule_fn
        self.k = int(accumulation_steps)
        # as in the JAX make_optimizer, a narrower accumulator only exists
        # behind accumulation
        self.accum_dtype = as_dtype(accum_dtype) if self.k > 1 else None

    def learning_rate(self, count: int) -> float:
        """lr at the update that follows `count` applied updates."""
        if self.lr_schedule_fn is None:
            return self.lr
        return float(np.float32(self.lr) * np.float32(self.lr_schedule_fn(count)))

    def init(self, params: dict) -> TrainState:
        raise NotImplementedError

    def export(self, state: TrainState) -> dict:
        """The optimizer state as train/checkpoints.py stores it."""
        return {**{g: getattr(state, g) for g in self.groups},
                "acc": state.acc, "count": state.count,
                "mini_step": state.mini_step}

    def restore(self, params: dict, opt_state: Optional[dict],
                device) -> TrainState:
        """A TrainState from checkpointed masters and optimizer state (a
        fresh state when opt_state is None)."""
        if opt_state is None:
            return self.init(params)
        groups = {g: opt_state.get(g) or {} for g in self.groups}
        if set().union(*groups.values()) != set(params):
            raise ValueError("the checkpoint's optimizer state does not cover the "
                             "parameters: it was written by another optimizer "
                             f"than {type(self).__name__}")
        on = lambda group: {n: t.to(device) for n, t in group.items()}  # noqa: E731
        return TrainState(
            params=params, count=opt_state["count"],
            mini_step=opt_state["mini_step"],
            acc=None if opt_state["acc"] is None else on(opt_state["acc"]),
            **{g: on(t) for g, t in groups.items()})

    @torch.no_grad()
    def accumulate(self, state: TrainState, grads: dict) -> None:
        """Adds one micro-step's gradients to the window's sum (in
        accum_dtype: each gradient rounded to it, then the sum rounded, as
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
        the accumulator."""
        if state.acc is None:
            raise RuntimeError("apply without accumulated gradients")
        scalars = self._scalars(state.count)
        for n, p in state.params.items():
            g = state.acc.pop(n).float()
            if self.k > 1:
                g.div_(self.k)
            self._update(state, n, p, g, *scalars)
        state.acc = None
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
    groups = ("mu", "nu")

    def init(self, params: dict) -> TrainState:
        return TrainState(
            params=params,
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
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
    groups = ("v_row", "v_col", "v")

    def factored_dims(self, shape) -> Optional[tuple[int, int]]:
        """(d1, d0) of optax's `_factored_dims`, or None."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim_size_to_factor:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, params: dict) -> TrainState:
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
                   accum_dtype=None) -> _AccumulatingOptimizer:
    """Adam (the reference's optimizer) or Adafactor, with the schedule and
    k-step accumulation, the running sum in accum_dtype (fp32 when None)."""
    cls = _OPTIMIZERS.get(name.lower())
    if cls is None:
        raise ValueError(f"unknown optimizer: {name}")
    return cls(lr, lr_schedule_fn, accumulation_steps, accum_dtype)


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, fp32 (optax's
    global_norm of the upcast gradients)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads.values()]))


def make_train_step(unet, vae, schedule: DiffusionSchedule,
                    optimizer: _AccumulatingOptimizer, **loss_kwargs):
    """-> (micro_step, apply_step).

    micro_step(state, text_embed, batch, generator=None, timesteps=None,
    noise=None) -> {"loss", "grad_norm"} (0-d fp32 device tensors) computes
    one micro-batch's loss and gradients and adds them to the accumulator;
    apply_step(state) applies the update with their mean. The caller runs
    apply_step after every `optimizer.k`-th micro_step."""
    loss_and_grad = make_loss_and_grad(unet, vae, schedule, **loss_kwargs)

    def micro_step(state: TrainState, text_embed, batch, generator=None,
                   timesteps=None, noise=None) -> dict:
        loss, grads = loss_and_grad(state.params, text_embed, batch,
                                    generator, timesteps, noise)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        optimizer.accumulate(state, grads)
        return metrics

    return micro_step, optimizer.apply
