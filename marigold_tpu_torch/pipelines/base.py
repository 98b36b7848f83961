"""Shared pipeline machinery of the port: checkpoint loading, the diffusion
core, preprocessing and batched serving.

Counterpart of `marigold_tpu/pipelines/base.py`. PyTorch runs eagerly, so
the JAX package's compiled-program cache has no counterpart: the core runs
encode -> trailing DDIM over the UNet -> decode as plain module calls under
`torch.inference_mode`. Noise comes from an explicit `torch.Generator` on
the pipeline's device, and `DiffusionCore.infer` takes it as an argument,
as the JAX core's infer does, so the two can be compared on shared noise.

This slice serves ensemble_size = 1 (the library default), where the
ensemble step passes the decoded map through; larger ensembles and LCM
checkpoints raise NotImplementedError naming the ROADMAP item that brings
them.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
from typing import Any, Optional, Union

import numpy as np
import torch

from marigold_tpu_torch.core.scheduler import (
    DiffusionSchedule,
    check_trailing_zero_snr,
)
from marigold_tpu_torch.models import weights as W
from marigold_tpu_torch.pipelines import image_util
from marigold_tpu_torch.pipelines.batchsize import find_batch_size

logger = logging.getLogger(__name__)

ENSEMBLE_TODO = ("ensemble_size > 1 is not ported yet: ROADMAP queue 1, "
                 "'ensemble_depth' (E>1, the E=10 protocol)")
LCM_TODO = "LCM checkpoints are not ported yet: ROADMAP queue 1, 'LCM'"
# decoded 768 px images per VAE decode call (the JAX package's base cap)
DECODE_CAP_768 = 20


def _pil_image_class():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image.Image


class DiffusionCore:
    """UNet + VAE + text encoder + schedule on one device."""

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
    def encode_rgb(self, rgb: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] in [-1, 1] -> [B, 4, H/8, W/8] scaled latent."""
        return self.vae.encode_mean_scaled(rgb.to(self.dtype))

    @torch.inference_mode()
    def denoise(self, rgb_latent: torch.Tensor, noise: torch.Tensor,
                num_steps: int, text_embed: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Trailing DDIM from `noise` [Eb, 4, h, w], conditioned on
        rgb_latent [1 or Eb, 4, h, w] -> target latents [Eb, 4, h, w]."""
        if text_embed is None:
            text_embed = self.empty_text_embed
        ts = self.schedule.inference_timesteps(num_steps)
        prev_ts = self.schedule.prev_timesteps(ts)
        rgb = rgb_latent.to(self.dtype).expand(noise.shape[0], -1, -1, -1)
        target = noise.to(self.dtype)
        for t, pt in zip(ts, prev_ts):
            out = self.unet(torch.cat([rgb, target], dim=1), int(t), text_embed)
            target = self.schedule.ddim_step(out, int(t), int(pt), target)
        return target

    @torch.inference_mode()
    def decode_depth(self, latent: torch.Tensor) -> torch.Tensor:
        """Latents -> depth [B, 1, H, W] fp32 in [0, 1]: decode, mean of the
        three channels, [-1, 1] -> [0, 1]."""
        img = self.vae.decode_scaled(latent)
        depth = img.float().mean(dim=1, keepdim=True).clamp(-1.0, 1.0)
        return (depth + 1.0) / 2.0

    def infer(self, rgb_latent: torch.Tensor, noise: torch.Tensor,
              num_steps: int, text_embed: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """The JAX core's infer (`_build_infer_fn`, depth mode): rgb_latent
        [1, 4, h, w], noise [Eb, 4, h, w] -> depth [Eb, 1, 8h, 8w]."""
        return self.decode_depth(
            self.denoise(rgb_latent, noise, num_steps, text_embed))

    @staticmethod
    def decode_chunking(total: int, crop_hw: tuple) -> tuple[int, int]:
        """(n_chunks, rows_per_chunk) of the decode stage: at most
        DECODE_CAP_768 decoded 768 px images per call, scaled inversely
        with output pixels, chunks balanced."""
        px = max(crop_hw[0] * crop_hw[1], 1)
        cap = max(1, int(DECODE_CAP_768 * (768 * 768) / px))
        n_dec = -(-total // min(cap, total))
        return n_dec, -(-total // n_dec)


# ------------------------------------------------------------------ #
# checkpoint loading


def load_pipeline_components(ckpt_dir: str, dtype=torch.bfloat16, device="cpu",
                             variant: Optional[str] = None):
    """A diffusers pipeline dir (model_index.json + unet/ vae/ text_encoder/
    scheduler/) -> (DiffusionCore, pipeline config dict)."""
    pipe_cfg: dict[str, Any] = {}
    index_path = os.path.join(ckpt_dir, "model_index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            pipe_cfg = json.load(f)
    sched_dir = os.path.join(ckpt_dir, "scheduler")
    sched_cfg = W.read_config(sched_dir, "scheduler_config.json")
    if "LCM" in str(sched_cfg.get("_class_name", "")):
        raise NotImplementedError(LCM_TODO)
    schedule = DiffusionSchedule.from_config(sched_cfg)

    unet = W.load_unet(os.path.join(ckpt_dir, "unet"), dtype, device, variant)
    vae = W.load_vae(os.path.join(ckpt_dir, "vae"), dtype, device, variant)
    text_dir = os.path.join(ckpt_dir, "text_encoder")
    text = (W.load_text_encoder(text_dir, dtype, device, variant)
            if os.path.isdir(text_dir) else None)
    return DiffusionCore(unet, vae, text, schedule, dtype, device), pipe_cfg


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
    def __init__(self, core: DiffusionCore, pipe_cfg: dict):
        self.core = core
        self.pipe_cfg = pipe_cfg
        self.default_denoising_steps = pipe_cfg.get("default_denoising_steps")
        self.default_processing_resolution = pipe_cfg.get(
            "default_processing_resolution")

    @classmethod
    def from_pretrained(cls, ckpt_dir: str, dtype=torch.bfloat16, device=None,
                        variant: Optional[str] = None):
        """device: "cuda", "cpu", a torch.device; default cuda when present."""
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        core, pipe_cfg = load_pipeline_components(ckpt_dir, dtype, device, variant)
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
        ch = self.core.vae_cfg.latent_channels
        return torch.randn((n, ch, h, w), generator=self._noise_generator(seed),
                           device=self.core.device, dtype=torch.float32)

    def _infer_fused(self, rgb_norm: np.ndarray, denoising_steps: int,
                     ensemble_size: int, seed=None,
                     out_hw: Optional[tuple] = None,
                     resample_method: str = "bilinear"):
        """Single-image inference. rgb_norm: [H, W, 3] in [-1, 1] at
        processing resolution; edge-padded to the VAE's /8 grid, cropped back
        and resized on the host to out_hw. Returns pred [h, w, 1] float32."""
        if ensemble_size > 1:
            raise NotImplementedError(ENSEMBLE_TODO)
        core = self.core
        x, h0, w0 = pad_to_multiple_of(rgb_norm[None],
                                       core.vae_cfg.downscale_factor)
        rgb = torch.from_numpy(np.ascontiguousarray(x)).to(core.device)
        rgb_lat = core.encode_rgb(rgb.permute(0, 3, 1, 2).contiguous())
        noise = self._noise(ensemble_size, *rgb_lat.shape[2:], seed)
        pred = core.infer(rgb_lat, noise, denoising_steps)
        pred_np = pred[0, :, :h0, :w0].permute(1, 2, 0).cpu().numpy()
        if out_hw is not None and out_hw != (h0, w0):
            pred_np = image_util.resize_host(pred_np, out_hw, resample_method)
        return pred_np.astype(np.float32)

    def _batch_infer(self, input_images, denoising_steps: Optional[int],
                     ensemble_size: int, processing_res: Optional[int],
                     match_input_res: bool, resample_method: str,
                     batch_size: int, seed, default_steps: int = 4,
                     compact_readback: bool = False):
        """Batched serving front half: defaults, step check, one input
        shape, processing-resolution resize. uint8 inputs that need no
        resize upload as uint8 and normalize on the device. Returns
        preds [NI, h, w, 1]."""
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
                           compact_output: bool = False,
                           resample_method: str = "bilinear"):
        """Batched serving of NI same-shape images. rgb_batch: [NI, H, W, 3]
        float in [-1, 1], or uint8 (normalized on the device). The denoise
        runs in chunks of `batch_size` rows (from the device's memory when
        0), the decode in chunks sized by decode_chunking; the resize to
        out_hw runs on the device. compact_output reads predictions back as
        uint16 (16-bit-PNG precision). Returns pred [NI, h, w, 1] float32."""
        if ensemble_size > 1:
            raise NotImplementedError(ENSEMBLE_TODO)
        core = self.core
        x, h0, w0 = pad_to_multiple_of(rgb_batch, core.vae_cfg.downscale_factor)
        ni, hp, wp = x.shape[:3]
        total = ni * ensemble_size
        if batch_size <= 0:
            batch_size = find_batch_size(
                ensemble_size=total, input_res=max(hp, wp),
                dtype_bytes=torch.finfo(core.dtype).bits // 8,
                device=core.device)
        chunk = min(batch_size, total)

        rgb = torch.from_numpy(np.ascontiguousarray(x)).to(core.device)
        if rgb.dtype == torch.uint8:
            rgb = rgb.float() / 127.5 - 1.0
        rgb_lat = core.encode_rgb(rgb.permute(0, 3, 1, 2).contiguous())
        rows = rgb_lat.repeat_interleave(ensemble_size, dim=0)
        noise = self._noise(total, *rgb_lat.shape[2:], seed)
        latents = torch.cat([
            core.denoise(rows[s:s + chunk], noise[s:s + chunk], denoising_steps)
            for s in range(0, total, chunk)])
        _, dec = core.decode_chunking(total, (h0, w0))
        pred = torch.cat([core.decode_depth(latents[s:s + dec])
                          for s in range(0, total, dec)])[:, :, :h0, :w0]
        if out_hw is not None and out_hw != (h0, w0):
            pred = image_util.resize_torch(pred, out_hw, resample_method)
        if compact_output:
            pred = torch.round(pred.clamp(0.0, 1.0) * 65535.0).to(torch.uint16)
        pred_np = pred.permute(0, 2, 3, 1).cpu().numpy().astype(np.float32)
        if compact_output:
            pred_np /= 65535.0
        return pred_np
