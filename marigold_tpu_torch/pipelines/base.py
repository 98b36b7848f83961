"""Shared pipeline machinery of the port: checkpoint loading, the diffusion
core, preprocessing and batched serving.

Counterpart of `marigold_tpu/pipelines/base.py`. PyTorch runs eagerly, so
the JAX package's compiled-program cache has no counterpart: the core runs
encode -> trailing DDIM over the UNet -> decode as plain module calls under
`torch.inference_mode`. Noise comes from an explicit `torch.Generator` on
the pipeline's device, and `DiffusionCore.infer` takes it as an argument,
as the JAX core's infer does, so the two can be compared on shared noise.

Modes: depth, normals and IID (`BasePipeline.mode`, with `n_targets`
latent groups of `latent_channels` each; IID decodes each group with its
own VAE call). Ensembles: E = 1 passes the decoded map through (the library
default); E > 1 denoises and decodes the members in chunks sized by the
device's memory and reduces them with `pipelines/ensemble.py`. Depth aligns
them on the device (`gauge_anchor=True`, the default) or with the
reference's host scipy solve (`ensemble_kwargs={"gauge_anchor": False}`).

LCM checkpoints (an `LCMScheduler` config, the deprecated v1-0 LCM depth
model) load with `core.lcm` set: the denoise loop then takes the
consistency step and re-noises with fresh noise drawn from the request's
generator at every step but the last (`DiffusionCore.step_noise`), in a
fixed order, so that a seed fixes the map for a fixed chunking. With no
compiled-program cache there is no cache key to carry the sampler.

`BasePipeline.phase_timer`, None by default, takes a
`utils/profiling.py:PhaseTimer`: the single-image path then times its
phases, "host pre" (decode, resize, pad and upload: two calls per
request), "encode", "denoise", "decode" (one each per member chunk),
"ensemble" and "host post" (readback and the resize back), synchronizing
the device at each edge, so it is a measurement, not a serving mode.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import secrets
from typing import Any, Optional, Union

import numpy as np
import torch

from marigold_tpu_torch.core.lcm import LCMSchedule
from marigold_tpu_torch.core.scheduler import (
    DiffusionSchedule,
    check_trailing_zero_snr,
)
from marigold_tpu_torch.models import weights as W
from marigold_tpu_torch.parallel.mesh import pad_to_multiple, replicate
from marigold_tpu_torch.pipelines import image_util
from marigold_tpu_torch.pipelines.batchsize import find_batch_size
from marigold_tpu_torch.pipelines.ensemble import (
    ensemble_depth,
    ensemble_iid,
    ensemble_normals,
)

logger = logging.getLogger(__name__)

# decoded 768 px images per VAE decode call (the JAX package's base cap);
# MARIGOLD_DECODE_CAP overrides it
DECODE_CAP_768 = 20


def _depth_ensemble_call_kwargs(ens_kwargs: dict) -> dict:
    """Caller ensemble_kwargs merged over ensemble_depth's serving
    defaults: one mapping for both serving forms."""
    return dict(
        scale_invariant=ens_kwargs.get("scale_invariant", True),
        shift_invariant=ens_kwargs.get("shift_invariant", True),
        reduction=ens_kwargs.get("reduction", "median"),
        regularizer_strength=ens_kwargs.get("regularizer_strength", 0.02),
        max_iter=ens_kwargs.get("max_iter", 50),
        tol=ens_kwargs.get("tol", 1e-6),
        max_res=ens_kwargs.get("max_res", 1024),
        reg_max_res=ens_kwargs.get("reg_max_res", 96),
        gauge_anchor=ens_kwargs.get("gauge_anchor", True),
    )


def _is_reference_ensemble(mode: str, ensemble_size: int,
                           ens_kwargs: dict) -> bool:
    """True when a depth ensemble runs the reference-exact host solve
    (gauge_anchor=False): the members are cropped to the valid region
    first, so no mask is needed. Only depth has that solve."""
    return (mode == "depth" and ensemble_size > 1
            and not ens_kwargs.get("gauge_anchor", True))


def _unit_normals(n: torch.Tensor, dim: int) -> torch.Tensor:
    """n divided by its L2 norm over `dim`, the norm clipped at 1e-6."""
    return n / torch.linalg.vector_norm(n, dim=dim, keepdim=True).clamp_min(1e-6)


def _pil_image_class():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image.Image


class DiffusionCore:
    """UNet + VAE + text encoder + schedule on one device; `mesh` (a
    `parallel.mesh.Mesh`, None for one device) when the pipeline serves
    across ranks, each holding the same replicated weights."""

    def __init__(self, unet, vae, text_encoder, schedule: DiffusionSchedule,
                 dtype: torch.dtype, device):
        self.unet = unet
        self.vae = vae
        self.text_encoder = text_encoder
        self.unet_cfg = unet.cfg
        self.vae_cfg = vae.cfg
        self.schedule = schedule
        self.dtype = dtype
        self.device = torch.device(device)
        self.lcm: Optional[LCMSchedule] = None  # legacy v1-0 LCM checkpoints
        self.mesh = None
        self._empty_text_embed = None

    @property
    def empty_text_embed(self) -> torch.Tensor:
        """[1, 2, cross_dim]: the empty-prompt conditioning, computed once."""
        if self._empty_text_embed is None:
            if self.text_encoder is None:
                raise RuntimeError("no text encoder loaded")
            with torch.inference_mode():
                emb = self.text_encoder.encode_empty_prompt()
            self._empty_text_embed = emb.to(self.dtype)
        return self._empty_text_embed

    @torch.inference_mode()
    def encode_rgb(self, rgb: torch.Tensor, spatial=None) -> torch.Tensor:
        """[B, 3, H, W] in [-1, 1] -> [B, 4, H/8, W/8] scaled latent
        (spatial: the mesh when rgb is this rank's block of H rows)."""
        return self.vae.encode_mean_scaled(rgb.to(self.dtype), spatial)

    def step_noise(self, shape: tuple, generator: Optional[torch.Generator]
                   ) -> torch.Tensor:
        """Fresh fp32 noise of `shape` for one LCM re-noising step, drawn
        from the request's generator."""
        if generator is None:
            raise ValueError("LCM sampling with more than one step needs the "
                             "request's torch.Generator")
        return torch.randn(shape, generator=generator, device=self.device,
                           dtype=torch.float32)

    @torch.inference_mode()
    def denoise(self, rgb_latent: torch.Tensor, noise: torch.Tensor,
                num_steps: int, text_embed: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                spatial=None, noise_rows: Optional[tuple] = None
                ) -> torch.Tensor:
        """Trailing DDIM (or, with `lcm` set, LCM sampling) from `noise`
        [Eb, 4n, h, w], conditioned on rgb_latent [1 or Eb, 4, h, w] ->
        target latents [Eb, 4n, h, w]. `generator` feeds LCM's fresh noise.
        noise_rows (offset, total): each fresh draw is `total` rows, of
        which these Eb rows are those from `offset`, so that ranks drawing
        one stream re-noise their members with distinct rows of one draw
        (the JAX package's chunk-distinct fresh noise). spatial: the mesh
        when the latents are this rank's block of H rows."""
        if text_embed is None:
            text_embed = self.empty_text_embed
        sampler = self.lcm or self.schedule
        ts = sampler.inference_timesteps(num_steps)
        prev_ts = sampler.prev_timesteps(ts)
        rgb = rgb_latent.to(self.dtype).expand(noise.shape[0], -1, -1, -1)
        target = noise.to(self.dtype)
        for i, (t, pt) in enumerate(zip(ts, prev_ts)):
            out = self.unet(torch.cat([rgb, target], dim=1), int(t), text_embed,
                            spatial=spatial)
            if self.lcm is None:
                target = self.schedule.ddim_step(out, int(t), int(pt), target)
            else:
                last = i == len(ts) - 1
                shape = tuple(target.shape)
                if noise_rows is not None:
                    shape = (noise_rows[1],) + shape[1:]
                fresh = None if last else self.step_noise(shape, generator)
                if fresh is not None and noise_rows is not None:
                    fresh = fresh[noise_rows[0]:noise_rows[0] + target.shape[0]]
                target, _ = self.lcm.step(out, int(t), int(pt), target, fresh,
                                          last)
        return target

    @torch.inference_mode()
    def decode(self, latent: torch.Tensor, mode: str = "depth",
               n_targets: int = 1, spatial=None) -> torch.Tensor:
        """Latents [B, 4n, h, w] -> maps, fp32: depth [B, 1, H, W] in [0, 1]
        (the mean of the three decoded channels); normals [B, 3, H, W],
        clipped to [-1, 1] and renormalized; IID [B, 3n, H, W] in [0, 1],
        each 4-channel group decoded by its own VAE call. spatial: the mesh
        when the latents are this rank's block of H rows."""
        if mode == "depth":
            img = self.vae.decode_scaled(latent, spatial)
            depth = img.float().mean(dim=1, keepdim=True).clamp(-1.0, 1.0)
            return (depth + 1.0) / 2.0
        if mode == "normals":
            n = self.vae.decode_scaled(latent, spatial).float().clamp(-1.0, 1.0)
            return _unit_normals(n, dim=1)
        if mode == "iid":
            lc = self.vae_cfg.latent_channels
            return torch.cat([
                (self.vae.decode_scaled(latent[:, i * lc:(i + 1) * lc], spatial)
                 .float().clamp(-1.0, 1.0) + 1.0) / 2.0
                for i in range(n_targets)], dim=1)
        raise ValueError(f"unknown mode: {mode}")

    def infer(self, rgb_latent: torch.Tensor, noise: torch.Tensor,
              num_steps: int, text_embed: Optional[torch.Tensor] = None,
              mode: str = "depth", n_targets: int = 1,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The JAX core's infer (`_build_infer_fn`): rgb_latent [1, 4, h, w],
        noise [Eb, 4n, h, w] -> maps [Eb, C, 8h, 8w] (see `decode`)."""
        return self.decode(
            self.denoise(rgb_latent, noise, num_steps, text_embed, generator),
            mode, n_targets)

    @staticmethod
    def decode_chunking(total: int, crop_hw: tuple, mode: str = "depth",
                        n_targets: int = 1) -> tuple[int, int]:
        """(n_chunks, rows_per_chunk) of the decode stage: at most
        DECODE_CAP_768 decoded 768 px images per call ($MARIGOLD_DECODE_CAP
        when set, read at each call), scaled inversely with output pixels,
        chunks balanced. The cap counts decoded images: an IID row decodes
        n_targets of them. The port caches no program, so the JAX package's
        fault of a cap read at trace time but missing from its cache key
        has no counterpart here."""
        px = max(crop_hw[0] * crop_hw[1], 1)
        if mode == "iid":
            px *= max(n_targets, 1)
        base_cap = int(os.environ.get("MARIGOLD_DECODE_CAP", DECODE_CAP_768))
        cap = max(1, int(base_cap * (768 * 768) / px))
        n_dec = -(-total // min(cap, total))
        return n_dec, -(-total // n_dec)


# ------------------------------------------------------------------ #
# checkpoint loading


def load_pipeline_components(ckpt_dir: str, dtype=torch.bfloat16, device=None,
                             variant: Optional[str] = None):
    """A diffusers pipeline dir (model_index.json + unet/ vae/ text_encoder/
    scheduler/) -> (DiffusionCore, pipeline config dict), on `device`: the
    CUDA device when None, raising without one (`weights.resolve_device`);
    the CPU only when asked for."""
    device = W.resolve_device(device)
    pipe_cfg: dict[str, Any] = {}
    index_path = os.path.join(ckpt_dir, "model_index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            pipe_cfg = json.load(f)
    sched_dir = os.path.join(ckpt_dir, "scheduler")
    sched_cfg = W.read_config(sched_dir, "scheduler_config.json")
    schedule = DiffusionSchedule.from_config(sched_cfg)

    unet = W.load_unet(os.path.join(ckpt_dir, "unet"), dtype, device, variant)
    vae = W.load_vae(os.path.join(ckpt_dir, "vae"), dtype, device, variant)
    text_dir = os.path.join(ckpt_dir, "text_encoder")
    text = (W.load_text_encoder(text_dir, dtype, device, variant)
            if os.path.isdir(text_dir) else None)
    core = DiffusionCore(unet, vae, text, schedule, dtype, device)
    # legacy LCM checkpoints (v1-0): detected from the scheduler class name
    if "LCM" in str(sched_cfg.get("_class_name", "")):
        core.lcm = LCMSchedule.create(
            base=schedule, original_inference_steps=int(
                sched_cfg.get("original_inference_steps", 50)))
    return core, pipe_cfg


# ------------------------------------------------------------------ #
# host-side helpers


def image_to_array(input_image) -> np.ndarray:
    """PIL image / [H, W, 3] uint8 / float array -> float32 [H, W, 3] in
    [-1, 1]. Integer inputs scale by 1/255; float inputs are expected in
    [0, 1] (a float max above 1.5 is taken as 0..255)."""
    pil = _pil_image_class()
    if pil is not None and isinstance(input_image, pil):
        arr = np.asarray(input_image.convert("RGB"), np.float32) / 255.0
    else:
        arr = np.asarray(input_image)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        if arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] != 3:
            arr = np.moveaxis(arr, 0, -1)  # CHW -> HWC
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
    return np.clip(arr * 2.0 - 1.0, -1.0, 1.0)


def pad_to_multiple_of(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int, int]:
    """Edge-pad H, W of [..., H, W, C] up to a multiple."""
    h, w = x.shape[-3], x.shape[-2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph or pw:
        pad = [(0, 0)] * (x.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
        x = np.pad(x, pad, mode="edge")
    return x, h, w


class BasePipeline:
    """Common orchestration for the three modality pipelines."""

    mode: str = "depth"
    n_targets: int = 1

    def __init__(self, core: DiffusionCore, pipe_cfg: dict):
        self.core = core
        self.pipe_cfg = pipe_cfg
        self.phase_timer = None  # a utils.profiling.PhaseTimer, when timing
        self.default_denoising_steps = pipe_cfg.get("default_denoising_steps")
        self.default_processing_resolution = pipe_cfg.get(
            "default_processing_resolution")
        self.scale_invariant = pipe_cfg.get("scale_invariant", True)
        self.shift_invariant = pipe_cfg.get("shift_invariant", True)

    @classmethod
    def from_pretrained(cls, ckpt_dir: str, dtype=torch.bfloat16, device=None,
                        variant: Optional[str] = None, mesh=None):
        """device: "cuda" (the default), "cpu" or a torch.device. Without a
        CUDA device the caller must ask for the CPU: there is no silent
        fallback, and a CUDA device asked for without one raises.
        mesh: a `parallel.mesh.Mesh` (`get_mesh()`, in every rank) to serve
        across ranks: the weights load on the rank's device (the mesh's
        unless `device` names it) and rank 0's are broadcast to every rank;
        __call__ then shards the ensemble members over the ranks, or with
        spatial=True the image's H rows."""
        if mesh is not None:
            device = mesh.device if device is None else torch.device(device)
            if device != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
        core, pipe_cfg = load_pipeline_components(ckpt_dir, dtype, device, variant)
        if mesh is not None:
            core.mesh = mesh
            for module in (core.unet, core.vae, core.text_encoder):
                if module is not None:
                    replicate(mesh, module)
        return cls(core, pipe_cfg)

    def _noise_generator(self, seed: Union[None, int, torch.Generator]
                         ) -> torch.Generator:
        """The reference's seed semantics: None draws fresh noise on every
        call, an integer seed is deterministic; a torch.Generator (on the
        pipeline's device) is used as it is."""
        if isinstance(seed, torch.Generator):
            return seed
        if seed is None:
            seed = secrets.randbits(31)
        return torch.Generator(device=self.core.device).manual_seed(
            int(seed) % (2**31))

    def _check_inference_step(self, n_step: int) -> None:
        for msg in check_trailing_zero_snr(self.core.schedule, n_step):
            logger.warning(msg)

    def _noise(self, n: int, h: int, w: int, seed) -> torch.Tensor:
        """Initial noise [n, latent_channels * n_targets, h, w]."""
        ch = self.core.vae_cfg.latent_channels * max(self.n_targets, 1)
        return torch.randn((n, ch, h, w), generator=self._noise_generator(seed),
                           device=self.core.device, dtype=torch.float32)

    def _ensemble_kwargs(self, ensemble_kwargs: Optional[dict]) -> dict:
        """Depth: the checkpoint's invariances merged under the caller's
        ensemble_kwargs, mapped to ensemble_depth's arguments. Normals and
        IID: the caller's ensemble_kwargs."""
        if self.mode != "depth":
            return dict(ensemble_kwargs or {})
        merged = dict(scale_invariant=self.scale_invariant,
                      shift_invariant=self.shift_invariant)
        merged.update(ensemble_kwargs or {})
        return _depth_ensemble_call_kwargs(merged)

    def _ensemble(self, members: torch.Tensor, kw: dict,
                  valid_mask: Optional[torch.Tensor] = None):
        """members [E, C, h, w] -> (pred [1, C, h, w], uncertainty): depth
        aligned by ensemble_depth (with valid_mask), normals reduced
        "closest" and IID "median" unless kw names another reduction."""
        if self.mode == "depth":
            if valid_mask is not None:
                kw = dict(kw, valid_mask=valid_mask)
            return ensemble_depth(members, output_uncertainty=True, **kw)
        if self.mode == "normals":
            return ensemble_normals(members, output_uncertainty=True,
                                    reduction=kw.get("reduction", "closest"))
        return ensemble_iid(members, output_uncertainty=True,
                            reduction=kw.get("reduction", "median"))

    def _chunk(self, total: int, hp: int, wp: int, batch_size: int,
               n_devices: int = 1) -> int:
        """Rows per denoise call on each of n_devices ranks: batch_size, or
        from the device's memory when 0."""
        per_device = -(-total // n_devices)
        if batch_size <= 0:
            batch_size = find_batch_size(
                ensemble_size=total, input_res=max(hp, wp),
                dtype_bytes=torch.finfo(self.core.dtype).bits // 8,
                n_devices=n_devices, device=self.core.device)
        return min(batch_size, per_device)

    def _infer_fused(self, rgb_norm: np.ndarray, denoising_steps: int,
                     ensemble_size: int, batch_size: int = 0, seed=None,
                     out_hw: Optional[tuple] = None,
                     ensemble_kwargs: Optional[dict] = None,
                     resample_method: str = "bilinear",
                     shape_bucketing: bool = False, spatial: bool = False):
        """Single-image inference. rgb_norm: [H, W, 3] in [-1, 1] at
        processing resolution, edge-padded to the VAE's /8 grid (a 64-px
        grid with shape_bucketing, as the JAX package pads to bound its
        compiles). The E members run in chunks of `batch_size` (from the
        device's memory when 0), each denoised then decoded; E > 1 ensembles
        them (depth with a mask of the padding or, in the reference-exact
        mode, cropped; normals and IID per pixel, cropped). The result is
        cropped and resized on the host to out_hw, normals renormalized
        after the resize. Returns (pred [h, w, C] float32, uncertainty
        [h, w, C'] or None).

        With a mesh (`from_pretrained(..., mesh=)`) every rank returns the
        same result. The E members, padded to a multiple of the mesh size
        with copies of the first, shard over the ranks: every rank draws
        the same global noise, denoises and decodes its own members, and
        one all_gather precedes the ensemble. spatial=True instead shards
        the image's H rows over the ranks, the >1k-px mode where one
        trajectory outgrows a card (`parallel/spatial.py`): H is edge-padded
        to vae_ds x 2^(levels-1) x ranks, which the mask keeps out of the
        ensemble; each rank encodes, denoises and decodes its rows of all E
        members from its rows of the global noise, and the maps are
        gathered along H before the ensemble."""
        core = self.core
        mesh = core.mesh
        if spatial:
            if mesh is None:
                raise ValueError(
                    "spatial=True needs a pipeline built with a mesh "
                    "(from_pretrained(..., mesh=get_mesh()))")
            if core.lcm is not None:
                raise ValueError("spatial inference does not support LCM")
        ds = core.vae_cfg.downscale_factor
        with self._phase("host pre"):
            x, h0, w0 = pad_to_multiple_of(
                rgb_norm[None], max(64, ds) if shape_bucketing else ds)
            if spatial:
                # every UNet level's shard-local H must stay even
                # (`parallel/spatial.py:check_spatial_divisibility`)
                need_h = ds * (1 << (len(core.unet_cfg.block_out_channels) - 1)
                               ) * mesh.size
                ph = -x.shape[1] % need_h
                if ph:
                    x = np.pad(x, [(0, 0), (0, ph), (0, 0), (0, 0)], mode="edge")
            hp, wp = x.shape[1:3]
            if spatial:
                x = x[:, mesh.rows(hp)]
            rgb = torch.from_numpy(np.ascontiguousarray(x)).to(core.device)
        with self._phase("encode"):
            rgb_lat = core.encode_rgb(rgb.permute(0, 3, 1, 2).contiguous(),
                                      mesh if spatial else None)
        gen = self._noise_generator(seed)
        if spatial:
            preds = self._spatial_members(rgb_lat, hp, wp, ensemble_size,
                                          denoising_steps, gen)
        else:
            preds = self._members(rgb_lat, hp, wp, ensemble_size,
                                  denoising_steps, batch_size, gen)
        unc = None
        with self._phase("ensemble"):
            if ensemble_size == 1:
                pred = preds[:, :, :h0, :w0]
            else:
                kw = self._ensemble_kwargs(ensemble_kwargs)
                if self.mode == "depth" and not _is_reference_ensemble(
                        self.mode, ensemble_size, kw):
                    mask = torch.zeros((1, 1, hp, wp), dtype=torch.bool,
                                       device=core.device)
                    mask[:, :, :h0, :w0] = True
                    pred, unc = self._ensemble(preds, kw, valid_mask=mask)
                    pred, unc = pred[:, :, :h0, :w0], unc[:, :, :h0, :w0]
                else:
                    pred, unc = self._ensemble(preds[:, :, :h0, :w0], kw)
        with self._phase("host post"):
            maps = [t[0].permute(1, 2, 0).cpu().numpy().astype(np.float32)
                    for t in ((pred,) if unc is None else (pred, unc))]
            if out_hw is not None and out_hw != (h0, w0):
                maps = [image_util.resize_host(m, out_hw, resample_method)
                        for m in maps]
                if self.mode == "normals":
                    norm = np.linalg.norm(maps[0], axis=-1, keepdims=True)
                    maps[0] = maps[0] / np.clip(norm, 1e-6, None)
            maps = [m.astype(np.float32) for m in maps]
        return maps[0], (maps[1] if unc is not None else None)

    def _members(self, rgb_lat: torch.Tensor, hp: int, wp: int,
                 ensemble_size: int, denoising_steps: int, batch_size: int,
                 gen: torch.Generator) -> torch.Tensor:
        """The decoded members [E, C, hp, wp] of one image's latent, in
        chunks of `batch_size`; with a mesh each rank runs its block of the
        padded members and the blocks are gathered."""
        core, mesh = self.core, self.core.mesh
        noise = self._noise(ensemble_size, *rgb_lat.shape[2:], gen)
        rows, n_devices = None, 1
        if mesh is not None:
            # pad E with copies of the members (with few members on many
            # ranks the pad can exceed E, so tile rather than slice)
            n_devices = mesh.size
            e_pad = pad_to_multiple(ensemble_size, n_devices)
            noise = noise.repeat(-(-e_pad // ensemble_size), 1, 1, 1)[:e_pad]
            rows = mesh.rows(e_pad)
            noise = noise[rows]
        chunk = self._chunk(ensemble_size, hp, wp, batch_size, n_devices)
        preds = []
        for s in range(0, noise.shape[0], chunk):  # core.infer, phase by phase
            with self._phase("denoise"):
                lat = core.denoise(
                    rgb_lat, noise[s:s + chunk], denoising_steps, generator=gen,
                    noise_rows=None if rows is None else (rows.start + s, e_pad))
            with self._phase("decode"):
                preds.append(core.decode(lat, self.mode, self.n_targets))
        preds = torch.cat(preds)
        if mesh is not None:
            preds = mesh.all_gather(preds, 0)[:ensemble_size]
        return preds

    def _spatial_members(self, rgb_lat: torch.Tensor, hp: int, wp: int,
                         ensemble_size: int, denoising_steps: int,
                         gen: torch.Generator) -> torch.Tensor:
        """The decoded members [E, C, hp, wp] from this rank's block of the
        latent's rows, all E in one batch, gathered along H."""
        core, mesh = self.core, self.core.mesh
        ds = core.vae_cfg.downscale_factor
        noise = self._noise(ensemble_size, hp // ds, wp // ds, gen)
        noise = noise[:, :, mesh.rows(hp // ds)]
        with self._phase("denoise"):
            lat = core.denoise(rgb_lat, noise, denoising_steps, generator=gen,
                               spatial=mesh)
        with self._phase("decode"):
            local = core.decode(lat, self.mode, self.n_targets, spatial=mesh)
        return mesh.all_gather(local, dim=2)

    def _phase(self, name: str):
        """`phase_timer.phase(name)`, or a no-op without a timer."""
        if self.phase_timer is None:
            return contextlib.nullcontext()
        return self.phase_timer.phase(name)

    def _single_infer(self, input_image, denoising_steps: Optional[int],
                      ensemble_size: int, processing_res: Optional[int],
                      match_input_res: bool, resample_method: str,
                      batch_size: int, seed, ensemble_kwargs: Optional[dict],
                      shape_bucketing: bool, spatial: bool,
                      default_steps: int = 4):
        """Single-image front half of the modality __call__s: defaults,
        checks, processing-resolution resize, then _infer_fused with the
        resize back to the input size when match_input_res. Returns
        (pred [h, w, C], uncertainty [h, w, C'] or None)."""
        if denoising_steps is None:
            denoising_steps = self.default_denoising_steps or default_steps
        if processing_res is None:
            processing_res = self.default_processing_resolution or 768
        if processing_res < 0 or ensemble_size < 1:
            raise ValueError(f"processing_res={processing_res}, "
                             f"ensemble_size={ensemble_size}")
        self._check_inference_step(denoising_steps)
        with self._phase("host pre"):
            rgb_norm = image_to_array(input_image)
            input_h, input_w = rgb_norm.shape[:2]
            if processing_res > 0 and max(input_h, input_w) != processing_res:
                nh, nw = image_util.resize_max_res_shape(input_h, input_w,
                                                         processing_res)
                rgb_norm = image_util.resize_np(rgb_norm, (nh, nw),
                                                method=resample_method)
        return self._infer_fused(
            rgb_norm, denoising_steps=denoising_steps,
            ensemble_size=ensemble_size, batch_size=batch_size, seed=seed,
            out_hw=(input_h, input_w) if match_input_res else None,
            ensemble_kwargs=ensemble_kwargs, resample_method=resample_method,
            shape_bucketing=shape_bucketing, spatial=spatial)

    def _batch_infer(self, input_images, denoising_steps: Optional[int],
                     ensemble_size: int, processing_res: Optional[int],
                     match_input_res: bool, resample_method: str,
                     batch_size: int, seed, ensemble_kwargs: Optional[dict],
                     default_steps: int = 4, compact_readback: bool = False):
        """Batched serving front half: defaults, step check, one input
        shape, processing-resolution resize. uint8 inputs that need no
        resize upload as uint8 and normalize on the device. Returns
        (preds [NI, h, w, C], uncertainties [NI, h, w, C'] or None)."""
        if denoising_steps is None:
            denoising_steps = self.default_denoising_steps or default_steps
        if processing_res is None:
            processing_res = self.default_processing_resolution or 768
        self._check_inference_step(denoising_steps)
        pil = _pil_image_class()

        def as_u8(im):
            if pil is not None and isinstance(im, pil):
                return np.asarray(im.convert("RGB"), np.uint8)
            a = np.asarray(im)
            return a if a.dtype == np.uint8 and a.ndim == 3 and a.shape[-1] == 3 else None

        kw = dict(denoising_steps=denoising_steps, ensemble_size=ensemble_size,
                  batch_size=batch_size, seed=seed,
                  ensemble_kwargs=ensemble_kwargs,
                  compact_output=compact_readback,
                  resample_method=resample_method)
        u8 = [as_u8(im) for im in input_images]
        if all(a is not None for a in u8):
            if len({a.shape for a in u8}) != 1:
                raise ValueError(f"images must share one shape, got "
                                 f"{sorted({a.shape for a in u8})}")
            ih, iw = u8[0].shape[:2]
            if not (processing_res > 0 and max(ih, iw) != processing_res):
                return self._infer_fused_batch(
                    np.stack(u8), out_hw=(ih, iw) if match_input_res else None,
                    **kw)

        rgbs = [image_to_array(im) for im in input_images]
        if len({r.shape for r in rgbs}) != 1:
            raise ValueError(f"images must share one shape, got "
                             f"{sorted({r.shape for r in rgbs})}")
        ih, iw = rgbs[0].shape[:2]
        if processing_res > 0 and max(ih, iw) != processing_res:
            nh, nw = image_util.resize_max_res_shape(ih, iw, processing_res)
            rgbs = [image_util.resize_np(r, (nh, nw), method=resample_method)
                    for r in rgbs]
        return self._infer_fused_batch(
            np.stack(rgbs), out_hw=(ih, iw) if match_input_res else None, **kw)

    def _infer_fused_batch(self, rgb_batch: np.ndarray, denoising_steps: int,
                           ensemble_size: int, batch_size: int = 0, seed=None,
                           out_hw: Optional[tuple] = None,
                           ensemble_kwargs: Optional[dict] = None,
                           compact_output: bool = False,
                           resample_method: str = "bilinear"):
        """Batched serving of NI same-shape images. rgb_batch: [NI, H, W, 3]
        float in [-1, 1], or uint8 (normalized on the device). The NI x E
        rows share the denoise batch, in chunks of `batch_size` rows (from
        the device's memory when 0); the decode runs in chunks sized by
        decode_chunking. E > 1 ensembles each image's cropped members on the
        device, then the resize to out_hw runs on the device (normals
        renormalized after it); in the depth reference-exact mode the solve,
        the resize and the quantization run on the host, as in the JAX
        package. compact_output reads back uint16 (16-bit-PNG precision;
        normals map through (x+1)/2 and back). Returns (pred [NI, h, w, C]
        float32, uncertainty [NI, h, w, C'] or None)."""
        core = self.core
        x, h0, w0 = pad_to_multiple_of(rgb_batch, core.vae_cfg.downscale_factor)
        ni, hp, wp = x.shape[:3]
        total = ni * ensemble_size
        chunk = self._chunk(total, hp, wp, batch_size)

        rgb = torch.from_numpy(np.ascontiguousarray(x)).to(core.device)
        if rgb.dtype == torch.uint8:
            rgb = rgb.float() / 127.5 - 1.0
        rgb_lat = core.encode_rgb(rgb.permute(0, 3, 1, 2).contiguous())
        rows = rgb_lat.repeat_interleave(ensemble_size, dim=0)
        gen = self._noise_generator(seed)
        noise = self._noise(total, *rgb_lat.shape[2:], gen)
        latents = torch.cat([
            core.denoise(rows[s:s + chunk], noise[s:s + chunk], denoising_steps,
                         generator=gen)
            for s in range(0, total, chunk)])
        _, dec = core.decode_chunking(total, (h0, w0), self.mode,
                                      self.n_targets)
        pred = torch.cat([core.decode(latents[s:s + dec], self.mode,
                                      self.n_targets)
                          for s in range(0, total, dec)])[:, :, :h0, :w0]
        normals = self.mode == "normals"

        def to_host(t):
            return t.permute(0, 2, 3, 1).cpu().numpy().astype(np.float32)

        def quantize(t):
            return torch.round(t.clamp(0.0, 1.0) * 65535.0).to(torch.uint16)

        if ensemble_size == 1:
            maps = [pred]
        else:
            kw = self._ensemble_kwargs(ensemble_kwargs)
            members = pred.reshape((ni, ensemble_size) + pred.shape[1:])
            reduced = [self._ensemble(m, kw) for m in members]
            maps = [torch.cat([r[0] for r in reduced]),
                    torch.cat([r[1] for r in reduced])]
            if _is_reference_ensemble(self.mode, ensemble_size, kw):
                host = [to_host(m) for m in maps]
                if out_hw is not None and out_hw != (h0, w0):
                    host = [np.stack([image_util.resize_host(im, out_hw,
                                                             resample_method)
                                      for im in m]) for m in host]
                if compact_output:
                    host = [np.round(np.clip(m, 0.0, 1.0) * 65535.0)
                            .astype(np.uint16).astype(np.float32) / 65535.0
                            for m in host]
                return host[0], host[1]
        if out_hw is not None and out_hw != (h0, w0):
            maps = [image_util.resize_torch(m, out_hw, resample_method)
                    for m in maps]
            if normals:
                maps[0] = _unit_normals(maps[0], dim=1)
        if compact_output:
            if normals:
                maps[0] = (maps[0] + 1.0) / 2.0
            maps = [quantize(m) for m in maps]
        host = [to_host(m) for m in maps]
        if compact_output:
            host = [m / 65535.0 for m in host]
            if normals:
                host[0] = host[0] * 2.0 - 1.0
        return host[0], (host[1] if ensemble_size > 1 else None)
