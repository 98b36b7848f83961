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
used: its per-op casts follow another policy.

The optimizer is Adam with optax's semantics (b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias correction, learning rate lr * schedule(count)
with count the number of updates already applied), behind k-step gradient
accumulation that averages like `optax.MultiSteps`. Accumulation is always
the two-step shape of the JAX package's `make_accum_pair`: `micro_step`
adds a micro-batch's gradients to the accumulator, `apply_step` applies the
mean at each k-th micro-step, so `split_accum` true and false are one
implementation here. Between windows the accumulator is freed.

Not ported (ROADMAP queue 1, "Training"): the `save_heavy` remat policy,
`grad_dtype`, `accum_dtype`, Adafactor and ZeRO-sharded optimizer state;
asking for one raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from marigold_tpu_torch.core.scheduler import DiffusionSchedule
from marigold_tpu_torch.train.loss import get_loss
from marigold_tpu_torch.train.multi_res_noise import multi_res_noise_like

ROADMAP_TRAIN = "ROADMAP queue 1, 'Training'"


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {ROADMAP_TRAIN}")


def downsample_valid_mask(valid_mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """[B, 1, H, W] bool -> [B, 1, H/f, W/f]: a latent pixel is valid iff no
    invalid pixel falls in its f x f window (max-pool of the invalid mask,
    VALID windows)."""
    invalid = (~valid_mask.bool()).float()
    return F.max_pool2d(invalid, factor, factor) < 0.5


def _check_remat(remat) -> bool:
    """-> whether to recompute the UNet forward in the backward."""
    if remat in (False, None, "none"):
        return False
    if remat in (True, "full"):
        return True
    if remat == "save_heavy":
        raise not_ported("the 'save_heavy' remat policy")
    raise ValueError(f"unknown remat mode: {remat!r}")


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
    valid_mask [B, 1, H, W] bool, on the model's device. timesteps [B] and
    noise (the latent-shaped fp32 noise) are drawn from `generator` unless
    given, so a test can pass the JAX package's draws. Returns the fp32
    loss (0-d) and name -> fp32 gradient."""
    if grad_dtype is not None:
        raise not_ported("grad_dtype (gradients stored in a narrower dtype)")
    loss_inner = get_loss(loss_name)
    ds = vae.cfg.downscale_factor
    full_remat = _check_remat(remat)

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

            def fwd(xx):
                return torch.func.functional_call(
                    unet, cast, (xx, timesteps, text_embed))

            pred = (checkpoint(fwd, x, use_reentrant=False) if full_remat
                    else fwd(x)).float()
            if mask is not None:
                diff = loss_inner(pred, target, reduction="none")
                n = mask.sum().clamp(min=1)
                loss = torch.where(mask, diff, torch.zeros_like(diff)).sum() / n
            else:
                loss = loss_inner(pred, target, reduction="mean")
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
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
    Adam updates applied, mini_step the micro-steps of the current window;
    acc is the window's gradient sum (None between windows)."""

    params: dict
    mu: dict
    nu: dict
    step: int = 0
    count: int = 0
    mini_step: int = 0
    acc: Optional[dict] = None


class Adam:
    """Adam with optax.adam's semantics (and its defaults) under
    optax.MultiSteps-style accumulation of `accumulation_steps`
    micro-steps. Updates run in place under no_grad."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, lr_schedule_fn: Optional[Callable] = None,
                 accumulation_steps: int = 1):
        self.lr = float(lr)
        self.lr_schedule_fn = lr_schedule_fn
        self.k = int(accumulation_steps)

    def learning_rate(self, count: int) -> float:
        """lr at the update that follows `count` applied updates."""
        if self.lr_schedule_fn is None:
            return self.lr
        return float(np.float32(self.lr) * np.float32(self.lr_schedule_fn(count)))

    def init(self, params: dict) -> TrainState:
        return TrainState(
            params=params,
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    @torch.no_grad()
    def accumulate(self, state: TrainState, grads: dict) -> None:
        """Adds one micro-step's gradients to the window's sum."""
        if state.acc is None:
            state.acc = {n: g.float() for n, g in grads.items()}
        else:
            for n, g in grads.items():
                state.acc[n].add_(g)
        state.step += 1
        state.mini_step += 1

    @torch.no_grad()
    def apply(self, state: TrainState) -> None:
        """One Adam update with the mean of the window's gradients; frees
        the accumulator."""
        if state.acc is None:
            raise RuntimeError("apply without accumulated gradients")
        count = state.count + 1
        bc1 = float(1.0 - np.float32(self.b1) ** np.float32(count))
        bc2 = float(1.0 - np.float32(self.b2) ** np.float32(count))
        step_size = self.learning_rate(state.count)
        for n, p in state.params.items():
            g = state.acc.pop(n)
            if self.k > 1:
                g.div_(self.k)
            mu, nu = state.mu[n], state.nu[n]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (nu / bc2).sqrt_().add_(self.eps)
            p.sub_((mu / bc1).div_(denom), alpha=step_size)
        state.acc = None
        state.count = count
        state.mini_step = 0


def make_optimizer(lr: float, lr_schedule_fn: Optional[Callable] = None,
                   accumulation_steps: int = 1, name: str = "adam",
                   accum_dtype=None) -> Adam:
    """Adam (+ schedule) with k-step accumulation: the reference's
    optimizer. Adafactor and a narrower accumulator are not ported."""
    if name.lower() != "adam":
        raise not_ported(f"optimizer {name!r} (Adam is ported)")
    if accum_dtype is not None:
        raise not_ported("accum_dtype (a narrower gradient accumulator)")
    return Adam(lr, lr_schedule_fn, accumulation_steps)


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, fp32 (optax's
    global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads.values()]))


def make_train_step(unet, vae, schedule: DiffusionSchedule, optimizer: Adam,
                    **loss_kwargs):
    """-> (micro_step, apply_step).

    micro_step(state, text_embed, batch, generator=None, timesteps=None,
    noise=None) -> {"loss", "grad_norm"} (0-d fp32 device tensors) computes
    one micro-batch's loss and gradients and adds them to the accumulator;
    apply_step(state) applies the Adam update with their mean. The caller
    runs apply_step after every `optimizer.k`-th micro_step."""
    loss_and_grad = make_loss_and_grad(unet, vae, schedule, **loss_kwargs)

    def micro_step(state: TrainState, text_embed, batch, generator=None,
                   timesteps=None, noise=None) -> dict:
        loss, grads = loss_and_grad(state.params, text_embed, batch,
                                    generator, timesteps, noise)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        optimizer.accumulate(state, grads)
        return metrics

    return micro_step, optimizer.apply
