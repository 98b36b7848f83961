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
    """Builds every kernel library from marigold_tpu_torch/csrc, one nvcc per
    source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from marigold_tpu_torch.ops import cuda_build
    from marigold_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda f: f(), (fa._library, fa._bwd_library)))
    wall = time.perf_counter() - t0
    for name in ("flash_attention", "flash_attention_bwd"):
        info = cuda_build.BUILD_INFO[name]
        print(f"build: {name} nvcc {info['seconds']:.2f} s", flush=True)
        with open(info["log"]) as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print("  ptxas:", line.strip(), flush=True)
    print(f"build: both libraries in {wall:.2f} s", flush=True)


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


# (name, B, Nq, Nk, C, heads): the training path's self-attentions at a
# 480x640 input with micro-batch 2 (60x80 latent: level 0 and level 1), one
# 768 px training case, and a ragged nq != nk case.
TRAIN_KERNEL_CASES = [
    ("train_l0", 2, 4800, 4800, 320, 5),
    ("train_l1", 2, 1200, 1200, 640, 10),
    ("train_768_l0", 1, 9216, 9216, 320, 5),
    ("ragged_nq_nk", 1, 1000, 1300, 128, 2),
]
# The backward kernels round dS and P to bf16 at the same places as the
# plain backward, which recomputes P by a softmax instead of from the lse,
# so a few bf16 roundings fall differently; dq/dk/dv and the forward output
# are held to max|err| <= TOL_REL * max|ref| + GRAD_TOL_ABS, the lse (fp32,
# sums in another order) to LSE_TOL_REL * max|lse| + LSE_TOL_ABS.
GRAD_TOL_ABS = 1e-5
LSE_TOL_REL = 1e-5
LSE_TOL_ABS = 1e-4
# FlashAttentionFunction's gradients against autograd through the plain
# forward: autograd rounds dP (not dS) to bf16, so the two round at
# different places: max|err| <= FN_TOL_REL * max|ref|.
FN_TOL_REL = 3e-2


def check_train_kernels() -> dict:
    """The training kernels (lse forward, dQ, dK/dV) against their plain
    versions at the training shapes, CUDA-event times of both, and
    FlashAttentionFunction's gradients against autograd of the plain
    forward. Returns {(case, what): {max_abs_err, ms, plain_ms}}."""
    import torch

    from marigold_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    results, failures = {}, []
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def record(name, what, got, ref, tol_rel, tol_abs, ms, plain_ms):
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = tol_rel * ref_max + tol_abs
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol
        print(f"kernel {name:13s} {what:4s}: max_abs_err {err:.3e} max|ref| "
              f"{ref_max:.3e} tol {tol:.3e} {'ok' if ok else 'FAILED'}"
              + (f" | kernel {ms:.3f} ms plain {plain_ms:.3f} ms"
                 if ms is not None else ""), flush=True)
        if not ok:
            failures.append(f"{name}/{what}: {err} > {tol}")
        results[(name, what)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    for name, b, nq, nk, c, heads in TRAIN_KERNEL_CASES:
        q, g = rand(b, nq, c), rand(b, nq, c)
        k, v = rand(b, nk, c), rand(b, nk, c)
        out, lse = fa.flash_attention_lse(q, k, v, heads)
        out_p, lse_p = fa.flash_attention_lse_plain(q, k, v, heads)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, g, heads)
        dq_p, dk_p, dv_p = fa.flash_attention_bwd_plain(q, k, v, g, heads)
        torch.cuda.synchronize()
        iters = 5 if nq >= 4096 else 20
        ms = _time_ms(lambda: fa.flash_attention_lse(q, k, v, heads), 20)
        plain_ms = _time_ms(lambda: fa.flash_attention_lse_plain(q, k, v, heads),
                            iters)
        record(name, "out", out, out_p, TOL_REL, GRAD_TOL_ABS, ms, plain_ms)
        record(name, "lse", lse, lse_p, LSE_TOL_REL, LSE_TOL_ABS, None, None)
        delta = fa.row_delta(out, g, heads)
        bwd_plain_ms = _time_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, g, heads), iters)
        dq_ms = _time_ms(
            lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, heads), 20)
        dkv_ms = _time_ms(
            lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, heads), 20)
        bwd_ms = _time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, g, heads), 20)
        record(name, "dq", dq, dq_p, TOL_REL, GRAD_TOL_ABS, dq_ms, bwd_plain_ms)
        record(name, "dk", dk, dk_p, TOL_REL, GRAD_TOL_ABS, dkv_ms, bwd_plain_ms)
        record(name, "dv", dv, dv_p, TOL_REL, GRAD_TOL_ABS, dkv_ms, bwd_plain_ms)
        d = c // heads
        print(f"  [{b},{nq}x{nk},{c}] h={heads}: lse fwd "
              f"{4.0 * b * heads * nq * nk * d / ms / 1e9:.1f} TFLOP/s; whole "
              f"backward (delta + dQ + dK/dV) {bwd_ms:.3f} ms "
              f"({10.0 * b * heads * nq * nk * d / bwd_ms / 1e9:.1f} TFLOP/s) "
              f"against plain {bwd_plain_ms:.3f} ms", flush=True)
        del q, k, v, g, out, lse, out_p, lse_p, dq, dk, dv, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()

    # the autograd Function against autograd through the plain forward
    b, n, c, heads = 2, 1200, 640, 10
    q, k, v, w = (rand(b, n, c) for _ in range(4))
    grads = []
    for fn in (lambda q, k, v: fa.FlashAttentionFunction.apply(q, k, v, heads,
                                                                "shifted"),
               lambda q, k, v: fa.flash_attention_plain(q, k, v, heads,
                                                        "online")):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        (fn(*leaves).float() * w.float()).sum().backward()
        grads.append([t.grad for t in leaves])
    for what, got, ref in zip(("dq", "dk", "dv"), *grads):
        record("autograd_fn", what, got, ref, FN_TOL_REL, 0.0, None, None)
    if failures:
        _fail(f"training kernels disagree with plain: {failures}")
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
    train_results = check_train_kernels()
    serve_counts = serve()
    train_counts = train_phase()
    rows = (kernel_rows(results, serve_counts)
            + train_kernel_rows(train_results, train_counts))
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        _fail(f"kernels never launched by the main path: {missing}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def write_checkpoint(root: str, seed: int, sd2: bool = False) -> None:
    """A diffusers-layout Marigold depth checkpoint at full SD2 width with
    random weights by the JAX package's init scheme, drawn from a seeded
    generator, stored as the fp16 weight variant. sd2=True writes the
    Stable Diffusion 2 base the depth trainer starts from instead: a
    4-channel UNet (conv_in surgery widens it to 8)."""
    import os

    import torch

    from marigold_tpu_torch.core.scheduler import DiffusionSchedule
    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
    from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    unet_cfg = UNetConfig(in_channels=4) if sd2 else UNetConfig()
    parts = [
        ("unet", UNet2DConditionModel, unet_cfg,
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
        "_class_name": "StableDiffusionPipeline" if sd2 else "MarigoldDepthPipeline",
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


def flash_self_attentions(ucfg, h: int, w: int) -> list:
    """[(count, head_dim)] per UNet level: the self-attentions of one
    forward at latent size h x w with >= FLASH_MIN_SEQ query and key tokens
    (stride-2 downsampling rounds up)."""
    from marigold_tpu_torch.ops.attention import FLASH_MIN_SEQ

    n_levels = len(ucfg.block_out_channels)
    out = []
    for i in range(n_levels):
        n = 0
        if h * w >= FLASH_MIN_SEQ:
            if ucfg.down_block_types[i] == "CrossAttnDownBlock2D":
                n += ucfg.layers_per_block
            if ucfg.up_block_types[n_levels - 1 - i] == "CrossAttnUpBlock2D":
                n += ucfg.layers_per_block + 1
            if i == n_levels - 1:
                n += 1  # mid block
        out.append((n, ucfg.block_out_channels[i] // ucfg.attention_head_dim[i]))
        h, w = -(-h // 2), -(-w // 2)
    return out


def expected_flash_launches(pipe, hw: tuple, steps: int,
                            n_images: int = 1) -> int:
    """Attentions with >= 1024 query and key tokens that one request at input
    size hw runs: UNet self-attentions per forward per denoise chunk, plus
    the VAE mid attention in the encode call and in each decode chunk."""
    from marigold_tpu_torch.ops.attention import FLASH_MIN_SEQ
    from marigold_tpu_torch.pipelines import image_util
    from marigold_tpu_torch.pipelines.batchsize import find_batch_size

    core = pipe.core
    ph, pw = image_util.resize_max_res_shape(*hw, 768) if max(hw) != 768 else hw
    ds = core.vae_cfg.downscale_factor
    h, w = -(-ph // ds), -(-pw // ds)
    vae = int(h * w >= FLASH_MIN_SEQ)
    per_fwd = sum(n for n, _ in flash_self_attentions(core.unet_cfg, h, w))
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


# The training phase: the depth fine-tuning recipe of
# config/train_marigold_depth.yaml (Adam lr 3e-5, IterExponential, annealed
# multi-resolution noise 0.9, mse_loss masked by valid_mask_raw, bf16 compute
# over fp32 masters, remat none) with warmup 0 so that the parameters move,
# on synthetic 480x640 batches of 2 with some invalid pixels, accumulation 2.
TRAIN_HW = (480, 640)
TRAIN_BATCH = 2
TRAIN_ACCUM = 2
TRAIN_ITERS = 2
# One micro-step's loss and gradients with the kernels against the same
# draws with every attention on the plain path: both run the bf16 UNet, so
# they differ by bf16 rounding in attention carried through the network.
# Loss: relative difference; gradients: relative L2 distance of the whole
# gradient and of each level-0/1 self-attention projection.
TRAIN_LOSS_TOL = 2e-2
TRAIN_GRAD_TOL = 1e-1
TRAIN_PROJ_TOL = 2e-1
TRAIN_CLASSES = [("flash backward (dQ, dK/dV)", r"flash_bwd_"),
                 ("flash forward", r"flash_fwd_kernel"),
                 ("cudnn NCHW<->NHWC copies", r"nchwToNhwc|nhwcToNchw"),
                 ("conv (fprop, dgrad, wgrad)", r"fprop|dgrad|wgrad|conv|winograd"),
                 ("gemm", r"gemm|cutlass|cublas|matmul"),
                 ("norm/elementwise/optimizer/other", r".")]


def expected_train_launches(core, hw: tuple, micro_steps: int) -> dict:
    """Flash launches of `micro_steps` micro-steps at input size hw, from
    the shapes: each UNet self-attention with >= FLASH_MIN_SEQ tokens runs
    the lse forward, the dQ and the dK/dV kernel once (64-wide heads, no
    remat); the two VAE encodes (rgb, target) under no_grad run the serving
    kernel of the mid attention (one head)."""
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.ops.attention import FLASH_MIN_SEQ

    ds = core.vae_cfg.downscale_factor
    h, w = -(-hw[0] // ds), -(-hw[1] // ds)
    vae_mid = f"shifted_d{core.vae_cfg.block_out_channels[-1]}"
    want = {vae_mid: 2 * micro_steps} if h * w >= FLASH_MIN_SEQ else {}
    for n, d in flash_self_attentions(core.unet_cfg, h, w):
        if not n:
            continue
        if d not in fa.TRAIN_HEAD_DIMS:
            raise AssertionError(f"head dim {d} has no training kernel")
        for key in ("lse", "bwd_dq", "bwd_dkv"):
            want[f"{key}_d{d}"] = want.get(f"{key}_d{d}", 0) + n * micro_steps
    return want


def _train_batches(seed: int, n: int) -> list:
    """Synthetic batches in the trainer's layout (NHWC numpy): smooth
    depth in [-1, 1], noise RGB, an invalid block in the first sample and
    5% invalid pixels in the second."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = TRAIN_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        depth = np.stack([np.sin(xx / rng.uniform(40, 120) + rng.uniform(0, 6))
                          * np.cos(yy / rng.uniform(40, 120))
                          for _ in range(TRAIN_BATCH)])[..., None]
        valid = np.ones((TRAIN_BATCH, h, w, 1), bool)
        valid[0, 100:220, 200:360] = False
        valid[1] = rng.uniform(size=(h, w, 1)) > 0.05
        out.append({
            "rgb_norm": rng.uniform(-1, 1, (TRAIN_BATCH, h, w, 3)).astype(np.float32),
            "depth_raw_norm": depth.astype(np.float32),
            "valid_mask_raw": valid,
        })
    return out


def train_phase() -> dict:
    """The depth fine-tuning path at full SD2 width. Returns the flash
    launch counts of its main-path run."""
    import gc
    import os
    import tempfile

    import numpy as np
    import torch

    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.config import Config
    from marigold_tpu_torch.ops import attention as attn
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.train.train_step import make_loss_and_grad
    from marigold_tpu_torch.train.trainer import MarigoldDepthTrainer

    gc.collect()
    torch.cuda.empty_cache()
    seed = 0
    failures = []
    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "sd2")
    t0 = time.perf_counter()
    write_checkpoint(root, seed, sd2=True)
    print(f"SD2 checkpoint (4-channel UNet) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pipe = MarigoldDepthPipeline.from_pretrained(
        root, dtype=torch.bfloat16, device="cuda", variant="fp16")
    cfg = Config(
        lr=3.0e-5,
        lr_scheduler=Config(name="IterExponential", kwargs=Config(
            total_iter=25000, final_ratio=0.01, warmup_steps=0)),
        loss=Config(name="mse_loss", kwargs=Config(reduction="mean")),
        trainer=Config(name="MarigoldDepthTrainer", init_seed=2024,
                       save_period=0, backup_period=0, validation_period=0,
                       visualization_period=0, remat="none"),
        multi_res_noise=Config(strength=0.9, annealed=True,
                               downscale_strategy="original"),
        optimizer=Config(name="Adam"),
        gt_depth_type="depth_raw_norm",
        gt_mask_type="valid_mask_raw",
        max_epoch=10000, max_iter=TRAIN_ITERS,
        validation=Config(denoising_steps=1, ensemble_size=1, processing_res=0,
                          match_input_res=False, resample_method="bilinear",
                          main_val_metric="abs_relative_difference",
                          main_val_metric_goal="minimize", init_seed=2024),
        eval=Config(alignment="least_square", align_max_res=None,
                    eval_metrics=["abs_relative_difference", "delta1_acc"]),
    )
    batches = _train_batches(seed, TRAIN_ITERS * TRAIN_ACCUM)
    out_dir = os.path.join(tmp.name, "run")
    t0 = time.perf_counter()
    trainer = MarigoldDepthTrainer(
        cfg, pipe, batches, os.path.join(out_dir, "ckpt"),
        os.path.join(out_dir, "eval"), os.path.join(out_dir, "vis"),
        accumulation_steps=TRAIN_ACCUM)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.state.params.values())
    print(f"trainer: surgery to {trainer.core.unet_cfg.in_channels} input "
          f"channels, {n_params / 1e6:.1f} M fp32 master parameters, Adam state, "
          f"built in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    before = {n: p.detach().clone() for n, p in trainer.state.params.items()}

    micro_steps = TRAIN_ITERS * TRAIN_ACCUM
    want = expected_train_launches(trainer.core, TRAIN_HW, micro_steps)
    torch.cuda.reset_peak_memory_stats()
    fa.launches.clear()  # the training path's run starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fa.launches)  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"trainer.train(): {TRAIN_ITERS} iterations x {TRAIN_ACCUM} micro-steps "
          f"of [{TRAIN_BATCH}, 3, {TRAIN_HW[0]}, {TRAIN_HW[1]}] in {wall:.1f} s "
          f"(first steps and the iter_{TRAIN_ITERS:06d} backup save included); "
          f"peak device memory {peak:.2f} GiB", flush=True)
    print(f"training-path flash launches: {counts}; expected from the shapes "
          f"{want}", flush=True)
    if counts != want:
        failures.append(f"flash launches {counts} != {want}")
    for e in trainer.metrics_log:
        print(f"  iter {e['iter']}: loss {e['loss']:.6f} grad_norm "
              f"{e['grad_norm']:.6f} lr {e['lr']:.3e}", flush=True)
        if not (np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])):
            failures.append(f"non-finite loss/grad_norm at iter {e['iter']}")
    if trainer.effective_iter != TRAIN_ITERS or trainer.state.count != TRAIN_ITERS:
        failures.append(f"effective_iter {trainer.effective_iter}, updates "
                        f"{trainer.state.count}, want {TRAIN_ITERS}")
    unchanged = [n for n, p in trainer.state.params.items()
                 if torch.equal(p.detach(), before[n])]
    print(f"parameters changed by the updates: {len(before) - len(unchanged)} of "
          f"{len(before)} tensors", flush=True)
    if unchanged:
        failures.append(f"parameters unchanged after {TRAIN_ITERS} updates: "
                        f"{unchanged[:8]}")
    del before

    # one micro-step's loss and gradients, kernels against plain attention,
    # on the same draws; and the fault: gradients reach to_q/to_k/to_v
    core = trainer.core
    loss_and_grad = make_loss_and_grad(core.unet, core.vae, core.schedule,
                                       **trainer._step_kwargs())
    batch = trainer._assemble_batch(batches[0])
    gen = torch.Generator(device="cuda").manual_seed(1)
    ds = core.vae_cfg.downscale_factor
    lat = (TRAIN_BATCH, core.vae_cfg.latent_channels, TRAIN_HW[0] // ds,
           TRAIN_HW[1] // ds)
    t_draw = torch.randint(0, core.schedule.num_train_timesteps, (TRAIN_BATCH,),
                           generator=gen, device="cuda")
    noise = torch.randn(lat, generator=gen, device="cuda")
    loss_k, grads_k = loss_and_grad(trainer.state.params, trainer.text_embed,
                                    batch, timesteps=t_draw, noise=noise)
    saved = attn.FLASH_MIN_SEQ
    attn.FLASH_MIN_SEQ = 1 << 30
    try:
        loss_p, grads_p = loss_and_grad(trainer.state.params, trainer.text_embed,
                                        batch, timesteps=t_draw, noise=noise)
    finally:
        attn.FLASH_MIN_SEQ = saved
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    num = sum(((grads_k[n] - grads_p[n]) ** 2).sum() for n in grads_p)
    den = sum((grads_p[n] ** 2).sum() for n in grads_p)
    rel_grad = float(num.sqrt() / den.sqrt())
    print(f"one micro-step, kernels vs plain attention: loss {float(loss_k):.6f} "
          f"vs {float(loss_p):.6f} (rel {rel_loss:.2e}, tol {TRAIN_LOSS_TOL}); "
          f"gradient rel L2 {rel_grad:.2e} (tol {TRAIN_GRAD_TOL})", flush=True)
    if not rel_loss <= TRAIN_LOSS_TOL:
        failures.append(f"micro-step loss rel diff {rel_loss}")
    if not rel_grad <= TRAIN_GRAD_TOL:
        failures.append(f"micro-step gradient rel L2 {rel_grad}")
    worst = 0.0
    n_proj = 0
    for n in grads_k:
        if ".attn1.to_" not in n or not n.endswith("weight") or "to_out" in n:
            continue
        level = (int(n.split(".")[1]) if n.startswith("down_blocks")
                 else len(core.unet_cfg.block_out_channels) - 1 - int(n.split(".")[1])
                 if n.startswith("up_blocks") else None)
        if level not in (0, 1):
            continue
        n_proj += 1
        gk, gp = grads_k[n], grads_p[n]
        rel = float((gk - gp).norm() / gp.norm())
        worst = max(worst, rel)
        if not gk.abs().max().item() > 0:
            failures.append(f"zero gradient at {n}: the graph is cut")
        if not rel <= TRAIN_PROJ_TOL:
            failures.append(f"{n}: gradient rel L2 {rel}")
    print(f"level-0/1 self-attention to_q/to_k/to_v: {n_proj} weights, every "
          f"gradient non-zero, worst rel L2 against plain {worst:.2e} "
          f"(tol {TRAIN_PROJ_TOL})", flush=True)
    if n_proj != 3 * sum(counts.get(f"lse_d{d}", 0) for d in fa.TRAIN_HEAD_DIMS) \
            // micro_steps:
        failures.append(f"{n_proj} level-0/1 projections checked")
    del grads_k, grads_p, loss_and_grad
    gc.collect()
    torch.cuda.empty_cache()

    # times: micro-steps and optimizer applies, host clock around a synchronize
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    micro_ms = [timed(lambda i=i: trainer.train_step(
        trainer.state, trainer.text_embed, trainer._assemble_batch(batches[i % 4]),
        trainer._step_generator())) for i in range(4)]
    apply_ms = timed(lambda: trainer.apply_step(trainer.state))
    trainer.train_step(trainer.state, trainer.text_embed,
                       trainer._assemble_batch(batches[0]), trainer._step_generator())
    apply_ms2 = timed(lambda: trainer.apply_step(trainer.state))
    warm = sorted(micro_ms[1:])
    print(f"ms per micro-step [{TRAIN_BATCH}, 3, {TRAIN_HW[0]}, {TRAIN_HW[1]}] "
          f"(upload, VAE encodes, UNet forward and backward, accumulate): "
          f"{', '.join(f'{m:.1f}' for m in micro_ms)}; median of the last 3 "
          f"{warm[len(warm) // 2]:.1f}; ms per optimizer apply (Adam, "
          f"{n_params / 1e6:.1f} M fp32): {apply_ms:.1f}, {apply_ms2:.1f}",
          flush=True)
    profile_request(
        lambda: trainer.train_step(trainer.state, trainer.text_embed,
                                   trainer._assemble_batch(batches[1]),
                                   trainer._step_generator()),
        TRAIN_CLASSES, f"one micro-step [{TRAIN_BATCH}, 3, {TRAIN_HW[0]}, "
        f"{TRAIN_HW[1]}]")
    trainer.apply_step(trainer.state)

    # save, then load into the same trainer: every tensor bit for bit
    st = trainer.state
    snap = {f"{g}.{n}": t.detach().cpu()
            for g in ("params", "mu", "nu") for n, t in getattr(st, g).items()}
    counters = (st.step, st.count, st.mini_step)
    seeds = list(trainer.global_seed_sequence)
    t0 = time.perf_counter()
    trainer.save_checkpoint("latest", save_train_state=True)
    save_s = time.perf_counter() - t0
    del st
    trainer.state = None
    gc.collect()
    t0 = time.perf_counter()
    trainer.load_checkpoint(os.path.join(out_dir, "ckpt", "latest"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    st = trainer.state
    differ = [k for k, t in snap.items()
              if not torch.equal(t, getattr(st, k.split(".", 1)[0])[
                  k.split(".", 1)[1]].detach().cpu())]
    if differ or (st.step, st.count, st.mini_step) != counters or \
            trainer.global_seed_sequence != seeds:
        failures.append(f"checkpoint round trip differs: {differ[:8]}")
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(os.path.join(out_dir, "ckpt", "latest"))
               for f in fs)
    print(f"save_checkpoint('latest') {save_s:.1f} s, load_checkpoint "
          f"{load_s:.1f} s, {size / 2**30:.2f} GiB on disk: {len(snap)} tensors "
          f"(params, Adam mu and nu) bit-identical: {not differ}", flush=True)
    del trainer, pipe, snap, st
    gc.collect()
    torch.cuda.empty_cache()
    tmp.cleanup()
    if failures:
        _fail(f"training phase: {failures}")
    return counts


def train_kernel_rows(results: dict, counts: dict) -> list:
    """Rows 4-6 of the kernel table: the training kernels, timed at the
    level-0 training shape; each backward kernel's plain time is that of
    the whole plain backward (dQ, dK and dV together)."""
    rows = []
    for name, replaces, key, whats in (
            ("flash_lse_d64", "marigold_tpu/ops/flash_attention.py:638",
             "lse_d64", ("out",)),
            ("flash_bwd_dq_d64", "marigold_tpu/ops/flash_attention.py:800",
             "bwd_dq_d64", ("dq",)),
            ("flash_bwd_dkv_d64", "marigold_tpu/ops/flash_attention.py:832",
             "bwd_dkv_d64", ("dk", "dv"))):
        timed = results[("train_l0", whats[0])]
        source = ("flash_attention.cu" if key.startswith("lse")
                  else "flash_attention_bwd.cu")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"marigold_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": counts.get(key, 0),
            "max_abs_err": max(r["max_abs_err"] for (case, what), r in results.items()
                               if what in whats and case != "autograd_fn"),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        })
    return rows


SERVE_CLASSES = [("flash", r"flash_fwd_kernel"),
                 ("cudnn NCHW<->NHWC copies", r"nchwToNhwc|nhwcToNchw"),
                 ("conv", r"fprop|dgrad|conv|winograd"),
                 ("gemm", r"gemm|cutlass|cublas|matmul"),
                 ("norm/elementwise/other", r".")]


def profile_request(fn, classes=SERVE_CLASSES,
                    what: str = "one 768x768 request") -> None:
    """Device time by kernel class and the device's busy share over one
    call of fn, from torch.profiler (single stream: kernels do not
    overlap)."""
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
    by_class: dict = {}
    total = 0.0
    for e in events:
        us = e.self_device_time_total
        total += us
        cls = next(c for c, pat in classes if re.search(pat, e.key, re.I))
        by_class[cls] = by_class.get(cls, 0.0) + us
    print(f"profile of {what}: wall {wall:.1f} ms, device busy "
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
