"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none of which catches its own failure:
  1. the card: its name and power limit (nvidia-smi);
  2. build the flash-attention kernel from marigold_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at the main path's shapes,
     both softmax modes, with errors and CUDA-event times;
  4. a full-SD2-width checkpoint with random weights from a seed, written in
     diffusers layout and loaded through MarigoldDepthPipeline.from_pretrained;
  5. serving: single-image requests and one batch, checked for shape, range,
     determinism and the exact number of flash-kernel launches, and the
     768 px map against the same request on plain attention;
  6. a torch.profiler breakdown of one 768 px request per softmax mode.
Prints a JSON line of kernels, then, last, {"ok": true, "device": {...}}.
Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check_card():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return smi


def build_kernels():
    from marigold_tpu_torch.ops import cuda_build
    from marigold_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa._library()
    wall = time.perf_counter() - t0
    info = cuda_build.BUILD_INFO["flash_attention"]
    print(f"build: flash_attention nvcc {info['seconds']:.2f} s "
          f"(load total {wall:.2f} s)", flush=True)
    with open(info["log"]) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip(), flush=True)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# (name, B, N, C, heads): the main path's attention shapes at 768 px, the
# ragged 576x768 latent, and the clamp case of
# tests/test_flash_attention.py::test_flash_dt_shifted_spiky_k_graceful
KERNEL_CASES = [
    ("unet_l0", 1, 9216, 320, 5),
    ("unet_l1", 1, 2304, 640, 10),
    ("unet_l0_ragged", 1, 6912, 320, 5),
    ("vae_mid", 1, 9216, 512, 1),
    ("spiky_k", 1, 512, 64, 1),
]

# Kernel rows of the JSON line: TPU pallas_call sites replaced, and the case
# whose times stand for the kernel (its main-path shape).
KERNEL_ROWS = [
    ("flash_shifted_d64", "marigold_tpu/ops/flash_attention.py:396",
     ("shifted", 64), "unet_l0"),
    ("flash_shifted_d512", "marigold_tpu/ops/flash_attention.py:429",
     ("shifted", 512), "vae_mid"),
    ("flash_online", "marigold_tpu/ops/flash_attention.py:460",
     ("online", None), "unet_l0"),
]

# bf16 output rounding is 2^-8 relative; the kernel and the plain version
# sum in different orders and round P to bf16 at the same place, so the
# error is a few output ulps: max|err| <= TOL_REL * max|ref| + TOL_ABS.
TOL_REL = 1e-2
TOL_ABS = 1e-3
# The 768 px depth map with the kernels against the same request with every
# attention on the plain fp32-softmax path: both run the bf16 UNet, so the
# maps differ by bf16 rounding carried through 4 steps and the decoder.
DEPTH_TOL = 5e-2
# timed runs per request shape: the first (cold) and the rest (warm)
REQUEST_RUNS = 4


def check_kernels() -> dict:
    import torch

    from marigold_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, n, c, heads in KERNEL_CASES:
        def rand():
            return torch.randn((b, n, c), generator=gen, device="cuda")
        q, k, v = rand(), rand(), rand()
        if name == "spiky_k":
            k[0, 137] *= 200.0
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        for mode in fa.SOFTMAX_MODES:
            ref = fa.flash_attention_plain(q, k, v, heads, mode)
            out = fa.flash_attention(q, k, v, heads, mode)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            max_err = err.max().item()
            mean_err = err.mean().item()
            ref_max = ref.float().abs().max().item()
            finite = bool(torch.isfinite(out.float()).all())
            tol = TOL_REL * ref_max + TOL_ABS
            ms = _time_ms(lambda: fa.flash_attention(q, k, v, heads, mode),
                          iters=20)
            plain_ms = _time_ms(
                lambda: fa.flash_attention_plain(q, k, v, heads, mode),
                iters=5 if n >= 4096 else 20,
            )
            d = c // heads
            flops = 4.0 * b * heads * n * n * d
            print(
                f"kernel {name:15s} {mode:7s} [{b},{n},{c}] h={heads} d={d}: "
                f"max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} "
                f"max|ref| {ref_max:.3e} tol {tol:.3e} | kernel {ms:.3f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.3f} ms",
                flush=True,
            )
            if not finite or not max_err <= tol:
                _fail(f"kernel {name}/{mode}: max_abs_err {max_err} > {tol} "
                      f"or non-finite output")
            results[(name, mode, d)] = dict(
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms)
        del q, k, v
        torch.cuda.empty_cache()
    return results


def kernel_rows(results: dict, counts: dict) -> list:
    rows = []
    for name, replaces, (mode, d), case in KERNEL_ROWS:
        mine = {key: r for key, r in results.items()
                if key[1] == mode and (d is None or key[2] == d)}
        timed = next(r for key, r in mine.items() if key[0] == case)
        launches = sum(n for key, n in counts.items()
                       if key.startswith(mode) and
                       (d is None or key == f"{mode}_d{d}"))
        rows.append({
            "name": name, "route": "cuda",
            "source": "marigold_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine.values()),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        })
    return rows


def main() -> None:
    import torch

    check_card()
    build_kernels()
    results = check_kernels()
    rows = kernel_rows(results, serve())
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        _fail(f"kernels never launched by the main path: {missing}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def write_checkpoint(root: str, seed: int) -> None:
    """A diffusers-layout Marigold depth checkpoint at full SD2 width with
    random weights by the JAX package's init scheme, drawn from a seeded
    generator, stored as the fp16 weight variant."""
    import os

    import torch

    from marigold_tpu_torch.core.scheduler import DiffusionSchedule
    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
    from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    parts = [
        ("unet", UNet2DConditionModel, UNetConfig(),
         "diffusion_pytorch_model.fp16.safetensors", ""),
        ("vae", AutoencoderKL, VAEConfig(),
         "diffusion_pytorch_model.fp16.safetensors", ""),
        ("text_encoder", CLIPTextModel, CLIPTextConfig(),
         "model.fp16.safetensors", "text_model."),
    ]
    for sub, cls, cfg, fname, prefix in parts:
        with torch.device("meta"):
            model = cls(cfg)
        sd = W.random_state_dict(model, gen, dtype=torch.float16)
        n = sum(t.numel() for t in sd.values())
        W.save_component(cfg.to_dict(), sd, os.path.join(root, sub), fname,
                         prefix)
        print(f"  {sub}: {n / 1e6:.1f} M parameters", flush=True)
        del sd
    DiffusionSchedule.create().save_pretrained(os.path.join(root, "scheduler"))
    W.write_config({
        "_class_name": "MarigoldDepthPipeline",
        "default_denoising_steps": 4,
        "default_processing_resolution": 768,
        "scale_invariant": True,
        "shift_invariant": True,
        "unet": ["diffusers", "UNet2DConditionModel"],
        "vae": ["diffusers", "AutoencoderKL"],
        "scheduler": ["diffusers", "DDIMScheduler"],
        "text_encoder": ["transformers", "CLIPTextModel"],
        "tokenizer": ["transformers", "CLIPTokenizer"],
    }, root, "model_index.json")


def expected_flash_launches(pipe, hw: tuple, steps: int,
                            n_images: int = 1) -> int:
    """Attentions with >= 1024 query and key tokens that one request at input
    size hw runs: UNet self-attentions per level (stride-2 downsampling
    rounds up) per forward per denoise chunk, plus the VAE mid attention in
    the encode call and in each decode chunk."""
    from marigold_tpu_torch.ops.attention import FLASH_MIN_SEQ
    from marigold_tpu_torch.pipelines import image_util
    from marigold_tpu_torch.pipelines.batchsize import find_batch_size

    core = pipe.core
    ucfg = core.unet_cfg
    ph, pw = image_util.resize_max_res_shape(*hw, 768) if max(hw) != 768 else hw
    ds = core.vae_cfg.downscale_factor
    h, w = -(-ph // ds), -(-pw // ds)
    vae = int(h * w >= FLASH_MIN_SEQ)
    n_levels = len(ucfg.block_out_channels)
    per_fwd = 0
    for i in range(n_levels):
        if h * w >= FLASH_MIN_SEQ:
            if ucfg.down_block_types[i] == "CrossAttnDownBlock2D":
                per_fwd += ucfg.layers_per_block
            if ucfg.up_block_types[n_levels - 1 - i] == "CrossAttnUpBlock2D":
                per_fwd += ucfg.layers_per_block + 1
            if i == n_levels - 1:
                per_fwd += 1  # mid block
        h, w = -(-h // 2), -(-w // 2)
    if n_images == 1:  # __call__: one UNet batch per step, one decode
        return per_fwd * steps + 2 * vae
    bs = find_batch_size(n_images, max(-(-ph // ds), -(-pw // ds)) * ds,
                         device=core.device)
    _, dec = core.decode_chunking(n_images, (ph, pw))
    return (per_fwd * steps * -(-n_images // min(bs, n_images))
            + vae * (1 + -(-n_images // dec)))


def serve() -> dict:
    """Phases 4 to 6. Returns the flash launch counts of the main path."""
    import os
    import tempfile

    import numpy as np
    import torch

    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.ops import attention as attn
    from marigold_tpu_torch.ops import flash_attention as fa

    seed = 0
    steps = 4
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_checkpoint(root, seed)
        print(f"checkpoint written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        pipe = MarigoldDepthPipeline.from_pretrained(
            root, dtype=torch.bfloat16, device="cuda", variant="fp16")
        torch.cuda.synchronize()
        print(f"from_pretrained(device='cuda', bf16) in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
              flush=True)

    rng = np.random.default_rng(seed)
    shapes = [(768, 768), (480, 640), (375, 1242)]
    images = {hw: rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in shapes}
    batch = [rng.integers(0, 256, (768, 768, 3), dtype=np.uint8) for _ in range(3)]

    def check(depth, hw, what):
        if depth.shape != hw or not np.isfinite(depth).all() or \
                depth.min() < 0.0 or depth.max() > 1.0:
            _fail(f"{what}: shape {depth.shape} (want {hw}), range "
                  f"[{np.nanmin(depth)}, {np.nanmax(depth)}]")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    fa.launches.clear()  # the main path's run starts here
    total_expected = 0
    outputs = {}
    for mode in ("shifted", "online"):
        attn.set_flash_softmax(mode)
        for hw in shapes if mode == "shifted" else shapes[:1]:
            maps, times = [], []
            want = expected_flash_launches(pipe, hw, steps)
            for _ in range(REQUEST_RUNS):
                before = sum(fa.launches.values())
                out, ms = timed(lambda: pipe(
                    images[hw], denoising_steps=steps, ensemble_size=1,
                    seed=seed, color_map=None))
                got = sum(fa.launches.values()) - before
                total_expected += want
                check(out.depth_np, hw, f"__call__ {hw} {mode}")
                if got != want:
                    _fail(f"flash launches {got} != {want} for {hw} {mode}")
                maps.append(out.depth_np)
                times.append(ms)
            if any(not np.array_equal(maps[0], m) for m in maps[1:]):
                _fail(f"same seed gave different maps for {hw} {mode}")
            warm = sorted(times[1:])
            print(f"request {hw[0]}x{hw[1]} softmax={mode}: first "
                  f"{times[0]:.1f} ms, then median {warm[len(warm) // 2]:.1f} "
                  f"ms/map (runs {', '.join(f'{t:.1f}' for t in times[1:])}); "
                  f"flash launches {want} per request, as expected; depth "
                  f"mean {maps[0].mean():.4f} std {maps[0].std():.4f}; "
                  f"identical maps from one seed", flush=True)
            outputs[(hw, mode)] = maps[0]
    attn.set_flash_softmax("shifted")

    want = expected_flash_launches(pipe, (768, 768), steps, n_images=len(batch))
    runs = []
    for _ in range(2):
        before = sum(fa.launches.values())
        outs, ms = timed(lambda: pipe.batch_call(
            batch, denoising_steps=steps, ensemble_size=1, seed=seed,
            processing_res=768, compact_readback=True))
        got = sum(fa.launches.values()) - before
        total_expected += want
        if got != want:
            _fail(f"batch flash launches {got} != {want}")
        for i, o in enumerate(outs):
            check(o.depth_np, (768, 768), f"batch_call image {i}")
        runs.append((np.stack([o.depth_np for o in outs]), ms))
    if not np.array_equal(runs[0][0], runs[1][0]):
        _fail("same seed gave different batch maps")
    ms = runs[1][1]
    print(f"batch_call 3x768x768 (uint16 readback): first {runs[0][1]:.1f} ms, "
          f"then {ms:.1f} ms = {ms / len(batch):.1f} ms/map; flash launches "
          f"{want} per batch, as expected; identical maps from one seed",
          flush=True)
    counts = dict(fa.launches)  # the main path's run ends here
    if sum(counts.values()) != total_expected:
        _fail(f"flash launches {counts} != {total_expected} in total")
    print(f"main-path flash launches by variant: {counts}", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)

    # the slice against its plain versions: the 768 px request again with
    # every attention on the plain fp32-softmax path
    shifted, online = outputs[((768, 768), "shifted")], outputs[((768, 768), "online")]
    saved = attn.FLASH_MIN_SEQ
    attn.FLASH_MIN_SEQ = 1 << 30
    try:
        plain = pipe(images[(768, 768)], denoising_steps=steps, seed=seed,
                     color_map=None).depth_np
    finally:
        attn.FLASH_MIN_SEQ = saved
    d_sh = np.abs(shifted - plain)
    d_on = np.abs(online - plain)
    print(f"768 px depth, kernels vs plain attention: shifted max "
          f"{d_sh.max():.3e} mean {d_sh.mean():.3e}; online max "
          f"{d_on.max():.3e} mean {d_on.mean():.3e}", flush=True)
    if max(d_sh.max(), d_on.max()) > DEPTH_TOL:
        _fail(f"depth with kernels differs from plain by more than {DEPTH_TOL}")
    for mode in fa.SOFTMAX_MODES:
        attn.set_flash_softmax(mode)
        print(f"softmax={mode}:", flush=True)
        profile_request(lambda: pipe(images[(768, 768)], denoising_steps=steps,
                                     seed=seed, color_map=None))
    attn.set_flash_softmax("shifted")
    return counts


def profile_request(fn) -> None:
    """Device time by kernel class and the device's busy share over one
    request, from torch.profiler (single stream: kernels do not overlap)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    classes = [("flash", r"flash_fwd_kernel"),
               ("cudnn NCHW<->NHWC copies", r"nchwToNhwc|nhwcToNchw"),
               ("conv", r"fprop|dgrad|conv|winograd"),
               ("gemm", r"gemm|cutlass|cublas|matmul"),
               ("norm/elementwise/other", r".")]
    by_class: dict = {}
    total = 0.0
    for e in events:
        us = e.self_device_time_total
        total += us
        cls = next(c for c, pat in classes if re.search(pat, e.key, re.I))
        by_class[cls] = by_class.get(cls, 0.0) + us
    print(f"profile of one 768x768 request: wall {wall:.1f} ms, device busy "
          f"{total / 1e3:.1f} ms ({100 * total / 1e3 / wall:.1f}% of wall)",
          flush=True)
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:24s} {us / 1e3:8.2f} ms  {100 * us / max(total, 1):5.1f}%",
              flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:110]}", flush=True)
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU]
    print("  host ops by self CPU time:", flush=True)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  {e.self_cpu_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:110]}", flush=True)


if __name__ == "__main__":
    main()
