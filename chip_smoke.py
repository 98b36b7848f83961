"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none of which catches its own failure:
  1. the card: its name and power limit (nvidia-smi);
  2. build every kernel library from marigold_tpu_torch/csrc, one nvcc per
     source, all started together (ptxas registers, spills and warnings
     printed, and the HGMMA count of each kernel's SASS in the flash and
     conv libraries where the toolkit has cuobjdump; a 3xTF32 kernel with
     spills or without HGMMA fails);
  3. each kernel against its plain PyTorch version at the main path's shapes
     (flash forward in both softmax modes, also at the E=10 rows' level-0
     shape, the folded flash entry, the nine-tap and Winograd 3x3 convs, the
     training flash kernels, and the fp32 kernels: the flash forward at
     both head widths in both softmax modes, the folded entry, the
     training forward with the logsumexp, dQ and dK/dV, the nine-tap and
     Winograd convs at all nine conv shapes, against their plain fp32
     versions with TF32 off, the padded statistics the fp32 dQ kernel
     writes against bwd_stats, and the 3xTF32 kernels' operand splits bit
     for bit), with
     errors and CUDA-event times of the
     kernel, the plain version, one PyTorch library call of the same
     function and, beside the shifted kernel, its row shift, beside the
     conv kernels their weight rearrangement and blocks launched, beside the
     backward pair SDPA's whole backward, row_delta and two calls held to
     the same bits, and the bound from bytes and operations;
  4. a full-SD2-width checkpoint with random weights from a seed, written in
     diffusers layout and loaded through MarigoldDepthPipeline.from_pretrained;
  5. serving at E=1: single-image requests and one batch, checked for shape,
     range, determinism and the exact number of flash-kernel launches, the
     768 px map against the same request on plain attention, and a
     torch.profiler breakdown per softmax mode;
  6. the E=10 protocol (4 steps, 768 px): __call__ and batch_call of 3
     images, exact launch counts, the ensemble solve's time, iterations and
     host syncs, a reference-exact (host scipy) request, two requests
     (first and warm) under each opt-in conv kernel (MARIGOLD_TPU_CONV=pallas,
     winograd) with exact conv launch counts against the default map, and a
     profile;
  7. the other modalities at full SD2 width, each UNet random from its own
     seed beside the depth checkpoint's VAE and text encoder: normals (4
     steps, 768 px: E=1, E=10 against plain attention by angle, a 3-image
     E=10 batch, uint16 readback, a profile), IID appearance (2 targets: E=1
     at 768 px, a 16-image E=1 batch at 640 px, a profile; conv_in/conv_out
     on cuDNN under every conv mode), IID lighting (3 targets, E=1 768 px),
     LCM depth (the depth UNet with an LCMScheduler config: 1 step E=10, 4
     steps E=1 with fresh noise); maps checked for shape, range and
     determinism, flash launches exact per head width;
  8. the command-line entry points on those checkpoints: validate_ckpt as
     a subprocess (and on a unet/ header with one wrong shape), run (depth
     E=10 with the Spectral PNGs, normals E=1), serve --once (six 768^2
     images, NI=3, E=10, two batches in flight), the HTTP API (concurrent
     requests, /healthz, the drain) and benchmark nyu on two fabricated
     480x640 samples with --parity (online launches only, the ensemble's
     parity pins) and without it (shifted launches only), flash launches
     exact per step;
  9. the folded flash entry at its two shapes;
  10. training at full SD2 width (the depth fine-tuning recipe), then the
     same trainer on the checkpoint loaded in fp32 (TF32 off): one
     iteration of 2 micro-steps under each remat mode (none, full,
     save_heavy) through the fp32 training kernels, fp32 launches exact,
     ms per micro-step and peak memory, a profile of one micro-step, and
     one micro-step's loss and every gradient against every attention on
     the plain path;
  11. the training entry point, cli/train.py, on the four shipped recipes
     (depth, normals, IID appearance, IID lighting) at full SD2 width, each
     through an overlay config (split lists, max_iter, periods; for normals
     and IID the effective batch) on datasets fabricated in their own
     layouts: depth 2 iterations of 16 micro-steps with the recipe's
     2-worker loader, validation and visualization, then --resume_run for
     a third; the others 2 iterations with validation; flash launches exact
     from the batch and validation shapes; the run-dir files and the saved
     UNets' channels; the loader's rate, a profiled window of micro-steps,
     one micro-step under each remat mode (none, full, save_heavy) at the
     recipe's micro-batch and at 4x it, where full must peak at least
     1 GiB and save_heavy some memory below none, and one Adafactor update
     against Adam's;
  12. `--full_precision`: run and serve --once for one 768 px depth map at
     E=1 in fp32 (the fp32 flash kernels, TF32 off), the same request in
     process against every attention on the plain path, under the online
     pin and under each opt-in conv mode (the fp32 conv kernels: a first
     and a warm request each, timed beside the default's warm one, and a
     profile of the warm request in each conv mode), and the
     folded entry in fp32, fp32 launches exact (the nine-tap's split of x
     counted apart);
  13. checkpoint loads: the full SD2 load by fastload and by the
     per-tensor path (MARIGOLD_TPU_FASTLOAD=0), bit for bit, the cold start
     of a fresh process to its first E=1 768 px map with each, and one warm
     request split into phases by PhaseTimer (run after phase 6);
  14. the native tar reader: the depth loader with 2 forked workers over a
     fabricated 480x640 tar, native against tarfile, batches identical.
Prints the card's name and power limit, a JSON line of kernels, then, last,
{"ok": true, "device": {...}}. Exits non-zero without a result when no CUDA
device is present.

    python3 chip_smoke.py --f32-kernels

runs phases 1 and 2 and the fp32 kernels of phase 3, then stops: the short
first call after a change to an fp32 kernel (run it under `timeout -s
KILL`, since a wrong mbarrier parity hangs).
"""

from __future__ import annotations

import collections
import json
import os
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

    from marigold_tpu_torch.ops import conv as conv_ops
    from marigold_tpu_torch.ops import cuda_build
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.ops import winograd as wino_ops

    builds = (fa._library, fa._bwd_library, conv_ops._library,
              wino_ops._library, fa._f32_library, fa._f32_bwd_library,
              fa._split_library, conv_ops.f32_library,
              wino_ops.f32_library)  # every library of the paths driven here
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda f: f(), builds))
    wall = time.perf_counter() - t0
    for name in ("flash_attention", "flash_attention_bwd", "conv3x3",
                 "winograd", "flash_attention_f32", "flash_attention_bwd_f32",
                 "tf32_split", "conv3x3_f32", "winograd_f32"):
        info = cuda_build.BUILD_INFO[name]
        print(f"build: {name} nvcc {info['seconds']:.2f} s", flush=True)
        with open(info["log"]) as f:
            for line in f:
                if any(w in line for w in ("registers", "spill", "Compiling",
                                           "C75", "arning")):
                    print("  ptxas:", line.strip(), flush=True)
    print(f"build: {len(builds)} libraries in {wall:.2f} s", flush=True)
    hgmma = {}
    for name in ("flash_attention", "flash_attention_bwd", "conv3x3",
                 "winograd", "flash_attention_f32", "flash_attention_bwd_f32",
                 "conv3x3_f32", "winograd_f32"):  # the ones with wgmma kernels
        hgmma.update(print_hgmma(os.path.join(os.path.dirname(
            cuda_build.BUILD_INFO[name]["log"]), f"lib{name}.so")))
    check_tf32_build(hgmma)


# The 3xTF32 wgmma kernels: (library, kernel name in the mangled symbol).
TF32_KERNELS = [("flash_attention_f32", "flash_fwd_d64_f32_kernel"),
                ("flash_attention_f32", "flash_fwd_d512_f32_kernel"),
                ("flash_attention_bwd_f32", "flash_bwd_dq_f32_kernel"),
                ("flash_attention_bwd_f32", "flash_bwd_dkv_f32_kernel"),
                ("conv3x3_f32", "conv3x3_f32_kernel"),
                ("winograd_f32", "winograd_f32_gemm_kernel")]


def check_tf32_build(hgmma: dict) -> None:
    """Each instantiation of the 3xTF32 kernels has HGMMA in its SASS (where
    cuobjdump ran) and no spills in ptxas's report."""
    import re

    from marigold_tpu_torch.ops import cuda_build

    for lib, kernel in TF32_KERNELS:
        spills, fn = {}, None
        with open(cuda_build.BUILD_INFO[lib]["log"]) as f:
            for line in f:
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    fn = m.group(1)
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m and fn and kernel in fn:
                    spills[fn] = int(m.group(1)) + int(m.group(2))
                    fn = None
        counts = {k: n for k, n in hgmma.items() if kernel in k}
        print(f"build: {kernel}: HGMMA {sorted(counts.values())}, spill bytes "
              f"{sorted(spills.values())}", flush=True)
        if not spills or any(spills.values()):
            _fail(f"{kernel}: ptxas reports spills or no entry: {spills}")
        if hgmma and (not counts or not all(counts.values())):
            _fail(f"{kernel}: no HGMMA in its SASS: {counts}")


def print_hgmma(lib: str) -> dict:
    """HGMMA (wgmma) instructions per kernel in a library's SASS, from the
    toolkit's cuobjdump where it has one; {} without it."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.isfile(tool):
        print(f"build: no cuobjdump at {tool}: HGMMA not counted", flush=True)
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    for fn, n in counts.items():
        print(f"  sass: {n:3d} HGMMA in {fn}", flush=True)
    return counts


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


# The card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W): the
# bound of a kernel is the larger of its operations over the bf16 tensor
# rate and its bytes (each input read once, each output written once) over
# the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound(flops: float, nbytes: float) -> tuple:
    """(bound_ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bhnd(x, heads):
    """[B, N, C] -> contiguous [B, H, N, C/H], the layout the library call
    takes (copied outside its timing)."""
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).transpose(1, 2).contiguous()


def sdpa_ms(q, k, v, heads, backward=False, iters=10):
    """CUDA-event time of F.scaled_dot_product_attention on the same inputs
    (forward; or, backward=True, its backward for all of dQ, dK, dV)."""
    import torch
    import torch.nn.functional as F

    q4, k4, v4 = (_bhnd(t, heads) for t in (q, k, v))
    if not backward:
        with torch.no_grad():
            return _time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                            iters)
    q4, k4, v4 = (t.requires_grad_() for t in (q4, k4, v4))
    out = F.scaled_dot_product_attention(q4, k4, v4)
    g = torch.randn_like(out)
    return _time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), g,
                                                retain_graph=True), iters)


def attention_bound(b, heads, nq, nk, d, flops_per_pair, q_io, kv_io,
                    extra=0):
    """Bound of an attention kernel: flops_per_pair * B*H*nq*nk*d operations;
    q_io [B, nq, C] and kv_io [B, nk, C] bf16 tensors read or written, plus
    `extra` bytes (fp32 row statistics)."""
    nbytes = 2 * b * heads * d * (q_io * nq + kv_io * nk) + extra
    return bound(flops_per_pair * b * heads * nq * nk * d, nbytes)


# (name, B, N, C, heads): the main path's attention shapes at 768 px, the
# ragged 576x768 latent, the clamp case of
# tests/test_flash_attention.py::test_flash_dt_shifted_spiky_k_graceful, the
# E=10 rows of one request at level 0, and the VAE mid attention of the E=10
# decoder chunk, the ragged image and the training encode; then the IID
# NI=16 batch at 640 px: its level-0 rows and a decoder chunk of 8 rows
# (decode_chunking counts each row's two decoded targets). The plain version
# runs one batch row at a time ([1, H, N, N] fp32 logits).
KERNEL_CASES = [
    ("unet_l0", 1, 9216, 320, 5),
    ("unet_l1", 1, 2304, 640, 10),
    ("unet_l0_ragged", 1, 6912, 320, 5),
    ("vae_mid", 1, 9216, 512, 1),
    ("spiky_k", 1, 512, 64, 1),
    ("unet_l0_b10", 10, 9216, 320, 5),
    ("vae_mid_b10", 10, 9216, 512, 1),
    ("vae_mid_ragged", 1, 6912, 512, 1),
    ("train_vae", 2, 4800, 512, 1),
    ("iid_unet_l0_b16", 16, 6400, 320, 5),
    ("iid_vae_mid_b8", 8, 6400, 512, 1),
]

# Kernel rows of the JSON line: TPU pallas_call sites replaced, the source,
# and the case whose times stand for the kernel (its main-path shape).
SM90_SOURCE = "marigold_tpu_torch/csrc/flash_fwd_sm90.cu"
KERNEL_ROWS = [
    ("flash_shifted_d64", "marigold_tpu/ops/flash_attention.py:396",
     ("shifted", 64), "unet_l0", SM90_SOURCE),
    ("flash_shifted_d512", "marigold_tpu/ops/flash_attention.py:429",
     ("shifted", 512), "vae_mid",
     "marigold_tpu_torch/csrc/flash_fwd_d512_sm90.cu"),
    ("flash_online", "marigold_tpu/ops/flash_attention.py:460",
     ("online", None), "unet_l0", SM90_SOURCE),
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
            def plain():
                return torch.cat([fa.flash_attention_plain(
                    q[i:i + 1], k[i:i + 1], v[i:i + 1], heads, mode)
                    for i in range(b)])

            ref = plain()
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
            plain_ms = _time_ms(plain, iters=5 if n >= 4096 else 20)
            # the shifted wrapper's small product outside the kernel
            shift_ms = (_time_ms(lambda: fa.row_shift(q, k, heads), 20)
                        if mode == "shifted" else None)
            d = c // heads
            flops = 4.0 * b * heads * n * n * d
            lib_ms = sdpa_ms(q, k, v, heads)
            # the shifted mode also reads its [B*H, N] fp32 shift
            b_ms, b_by = attention_bound(b, heads, n, n, d, 4, 2, 2, extra=(
                4 * b * heads * n if mode == "shifted" else 0))
            print(
                f"kernel {name:15s} {mode:7s} [{b},{n},{c}] h={heads} d={d}: "
                f"max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} "
                f"max|ref| {ref_max:.3e} tol {tol:.3e} | kernel {ms:.3f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.3f} ms "
                f"sdpa {lib_ms:.3f} ms bound {b_ms:.3f} ms ({b_by})"
                + (f"; of the kernel time, row_shift {shift_ms:.3f} ms"
                   if shift_ms is not None else ""),
                flush=True,
            )
            if not finite or not max_err <= tol:
                _fail(f"kernel {name}/{mode}: max_abs_err {max_err} > {tol} "
                      f"or non-finite output")
            results[(name, mode, d)] = dict(
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                shift_ms=shift_ms)
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

    def record(name, what, got, ref, tol_rel, tol_abs, ms, plain_ms,
               library_ms=None, bounds=(None, None)):
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = tol_rel * ref_max + tol_abs
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol
        print(f"kernel {name:13s} {what:4s}: max_abs_err {err:.3e} max|ref| "
              f"{ref_max:.3e} tol {tol:.3e} {'ok' if ok else 'FAILED'}"
              + (f" | kernel {ms:.3f} ms plain {plain_ms:.3f} ms sdpa "
                 f"{library_ms:.3f} ms bound {bounds[0]:.3f} ms ({bounds[1]})"
                 if ms is not None else ""), flush=True)
        if not ok:
            failures.append(f"{name}/{what}: {err} > {tol}")
        results[(name, what)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bounds[0], bound_by=bounds[1])

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
        d = c // heads
        stats = 4 * b * heads * nq  # one fp32 row statistic
        record(name, "out", out, out_p, TOL_REL, GRAD_TOL_ABS, ms, plain_ms,
               sdpa_ms(q, k, v, heads),
               attention_bound(b, heads, nq, nk, d, 4, 2, 2, extra=stats))
        record(name, "lse", lse, lse_p, LSE_TOL_REL, LSE_TOL_ABS, None, None)
        # the kernels use no atomics: a second call gives the same bits
        again = fa.flash_attention_bwd(q, k, v, out, lse, g, heads)
        same = all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
        print(f"kernel {name:13s} bwd : two calls bit-identical: {same}",
              flush=True)
        if not same:
            failures.append(f"{name}/bwd: two calls differ")
        del again
        lse_pad, delta_pad = fa.bwd_stats(out, lse, g, heads)
        bwd_plain_ms = _time_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, g, heads), iters)
        dq_ms = _time_ms(
            lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse_pad, delta_pad,
                                              heads), 20)
        dkv_ms = _time_ms(
            lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse_pad, delta_pad,
                                               heads), 20)
        delta_ms = _time_ms(lambda: fa.row_delta(out, g, heads), 20)
        stats_ms = _time_ms(lambda: fa.bwd_stats(out, lse, g, heads), 20)
        bwd_ms = _time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, g, heads), 20)
        # the library's backward computes dQ, dK and dV in one call; the
        # dQ kernel recomputes S and dP (6 N^2 d per head), the dK/dV kernel
        # S, dP, dV and dK (8 N^2 d); both read q, k, v, dO, lse and delta
        bwd_lib_ms = sdpa_ms(q, k, v, heads, backward=True)
        record(name, "dq", dq, dq_p, TOL_REL, GRAD_TOL_ABS, dq_ms, bwd_plain_ms,
               bwd_lib_ms,
               attention_bound(b, heads, nq, nk, d, 6, 3, 2, extra=2 * stats))
        record(name, "dk", dk, dk_p, TOL_REL, GRAD_TOL_ABS, dkv_ms, bwd_plain_ms,
               bwd_lib_ms,
               attention_bound(b, heads, nq, nk, d, 8, 2, 4, extra=2 * stats))
        record(name, "dv", dv, dv_p, TOL_REL, GRAD_TOL_ABS, dkv_ms, bwd_plain_ms,
               bwd_lib_ms,
               attention_bound(b, heads, nq, nk, d, 8, 2, 4, extra=2 * stats))
        print(f"  [{b},{nq}x{nk},{c}] h={heads}: lse fwd "
              f"{4.0 * b * heads * nq * nk * d / ms / 1e9:.1f} TFLOP/s; whole "
              f"backward (delta + dQ + dK/dV) {bwd_ms:.3f} ms "
              f"({10.0 * b * heads * nq * nk * d / bwd_ms / 1e9:.1f} TFLOP/s) "
              f"against plain {bwd_plain_ms:.3f} ms and sdpa {bwd_lib_ms:.3f} "
              f"ms; of it row_delta {delta_ms:.3f} ms, the padded lse and "
              f"delta (bwd_stats) {stats_ms:.3f} ms; dQ "
              f"{6.0 * b * heads * nq * nk * d / dq_ms / 1e9:.1f} TFLOP/s, "
              f"dK/dV {8.0 * b * heads * nq * nk * d / dkv_ms / 1e9:.1f} "
              "TFLOP/s", flush=True)
        del q, k, v, g, out, lse, out_p, lse_p, dq, dk, dv, dq_p, dk_p, dv_p
        del lse_pad, delta_pad
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


# The fp32 kernels (`--full_precision`): the flash forward of both head
# widths in both softmax modes, the folded entry, and the two conv kernels,
# against their plain fp32 versions at the main path's shapes. Both sum fp32
# products in different orders (every fp32 kernel as 3xTF32, ~2^-21 per
# product), so they agree to a few fp32 ulps of the largest
# output: max|err| <= F32_TOL_REL * max|ref| + F32_TOL_ABS. TF32 or bf16
# inputs (~3 decimal digits) would miss this by an order of magnitude.
F32_TOL_REL = 1e-4
F32_TOL_ABS = 1e-6
# (name, B, N, C, heads); "odd" and "odd_d512" mask ragged query and key
# tiles; "vae_enc_train" is the fp32 micro-step's VAE encode
F32_FLASH_CASES = [
    ("unet_l0", 1, 9216, 320, 5),
    ("vae_mid", 1, 9216, 512, 1),
    ("vae_enc_train", 2, 4800, 512, 1),
    ("odd", 2, 1100, 128, 2),
    ("odd_d512", 2, 1100, 512, 1),
]
F32_FOLDED_CASE = ("folded_b10", 50, 9216, 64)
# The card's published peaks (H100 SXM data sheet, dense, 700 W): fp32
# outside the tensor cores, and tf32 in them. An fp32-accurate product on
# the tensor cores takes three tf32 passes (3xTF32), so the least time of
# fp32 work is 3 ops / PEAK_TF32_FLOPS; an FFMA kernel's is ops /
# PEAK_FP32_FLOPS, kept beside it.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
F32_D64_SOURCE = "marigold_tpu_torch/csrc/flash_fwd_d64_f32_sm90.cu"
F32_D512_SOURCE = "marigold_tpu_torch/csrc/flash_fwd_d512_f32_sm90.cu"
F32_DQ_SOURCE = "marigold_tpu_torch/csrc/flash_bwd_dq_f32_sm90.cu"
F32_DKV_SOURCE = "marigold_tpu_torch/csrc/flash_bwd_dkv_f32_sm90.cu"
SPLIT_SOURCE = "marigold_tpu_torch/csrc/tf32_split.cu"
# The operand split is bit-exact: cvt.rna.tf32.f32 and an fp32 subtraction
# that is exact, against the same rounding done on the int32 bits.
SPLIT_TOL = 0.0
# The fp32 training kernels at the TRAIN_KERNEL_CASES shapes of these names
# (the first one's times stand for the rows), each against its plain
# version at the fp32 tolerance, two backward calls held to the same bits.
F32_TRAIN_CASES = ("train_l0", "train_l1", "ragged_nq_nk")
# (row name, TPU site, launch key, what it is checked on, source)
F32_TRAIN_ROWS = [
    ("flash_lse_d64_f32", "marigold_tpu/ops/flash_attention.py:638",
     "lse_d64", ("out", "lse"), F32_D64_SOURCE),
    ("flash_bwd_dq_d64_f32", "marigold_tpu/ops/flash_attention.py:800",
     "bwd_dq_d64", ("dq",), F32_DQ_SOURCE),
    ("flash_bwd_dkv_d64_f32", "marigold_tpu/ops/flash_attention.py:832",
     "bwd_dkv_d64", ("dk", "dv"), F32_DKV_SOURCE),
]
# (row name, TPU site, (mode, head dim), case whose times stand, source)
F32_ROWS = [
    ("flash_shifted_d64_f32", "marigold_tpu/ops/flash_attention.py:396",
     ("shifted", 64), "unet_l0", F32_D64_SOURCE),
    ("flash_shifted_d512_f32", "marigold_tpu/ops/flash_attention.py:429",
     ("shifted", 512), "vae_mid", F32_D512_SOURCE),
    ("flash_online_f32", "marigold_tpu/ops/flash_attention.py:460",
     ("online", 64), "unet_l0", F32_D64_SOURCE),
    ("flash_online_d512_f32", "marigold_tpu/ops/flash_attention.py:460",
     ("online", 512), "vae_mid", F32_D512_SOURCE),
]
F32_ROW_TIMES = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "bound_ffma_ms")


def bound_f32(flops: float, nbytes: float) -> tuple:
    """(bound_ms, "operations" or "bytes", bound_ffma_ms): the least time
    the card could take for fp32-accurate work, the larger of three tf32
    passes at the tensor rate and the bytes at the memory rate; and the
    same with the operations at the fp32 CUDA-core peak (the FFMA bound)."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_ffma = max(flops / PEAK_FP32_FLOPS * 1e3, t_bytes)
    return ((t_ops, "operations", t_ffma) if t_ops >= t_bytes
            else (t_bytes, "bytes", t_ffma))


def _f32_record(results, key, what, out, ref, ms, plain_ms, lib_ms, b,
                extra="", tol=None):
    """Holds `out` to `ref` at the fp32 tolerance (or `tol`) and records
    the row's numbers under `key`; lib_ms None where no library call
    computes the function."""
    import torch

    err = (out - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    if tol is None:
        tol = F32_TOL_REL * ref_max + F32_TOL_ABS
    lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
    print(f"fp32 kernel {what}: max_abs_err {err:.3e} max|ref| {ref_max:.3e} "
          f"tol {tol:.3e} | kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
          f"library {lib} bound {b[0]:.3f} ms ({b[1]}; FFMA bound "
          f"{b[2]:.3f} ms){extra}", flush=True)
    if not err <= tol or not bool(torch.isfinite(out).all()):
        _fail(f"fp32 kernel {what}: max_abs_err {err} > {tol} or non-finite")
    results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=b[0], bound_by=b[1],
                        bound_ffma_ms=b[2])


def check_f32_kernels() -> dict:
    """The fp32 kernels against their plain fp32 versions with TF32 off for
    both (the setting `--full_precision` runs with), CUDA-event times of
    the kernel, the plain version and the library call (SDPA in fp32;
    F.conv2d, cuDNN without TF32), the device ms of each launch inside a
    flash call (the split, the kernel, the shifted mode's row shift), and
    bounds against the fp32 peak."""
    import torch

    from marigold_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, b, n, c, heads in F32_FLASH_CASES:
        q, k, v = (torch.randn((b, n, c), generator=gen, device="cuda")
                   for _ in range(3))
        d = c // heads
        for mode in fa.SOFTMAX_MODES:
            def plain():
                return torch.cat([fa.flash_attention_plain(
                    q[i:i + 1], k[i:i + 1], v[i:i + 1], heads, mode)
                    for i in range(b)])

            out = fa.flash_attention(q, k, v, heads, mode)
            ref = plain()
            torch.cuda.synchronize()
            ms = _time_ms(lambda: fa.flash_attention(q, k, v, heads, mode), 10)
            plain_ms = _time_ms(plain, 3)
            lib_ms = sdpa_ms(q, k, v, heads)
            bb = bound_f32(4.0 * b * heads * n * n * d,
                           4 * 4 * b * n * c + (4 * b * heads * n
                                                if mode == "shifted" else 0))
            split = launch_split(lambda: fa.flash_attention(q, k, v, heads,
                                                            mode))
            _f32_record(results, (name, mode, d),
                        f"{name:9s} {mode:7s} [{b},{n},{c}] h={heads}", out,
                        ref, ms, plain_ms, lib_ms, bb,
                        f"; {4.0 * b * heads * n * n * d / ms / 1e9:.1f} "
                        f"TFLOP/s; device ms per launch: {split}")
        del q, k, v
    name, bh, n, d = F32_FOLDED_CASE
    q, k, v = (torch.randn((bh, n, d), generator=gen, device="cuda")
               for _ in range(3))

    def folded_plain():
        return torch.cat([
            fa.flash_attention_plain(q[i:i + PLAIN_CHUNK], k[i:i + PLAIN_CHUNK],
                                     v[i:i + PLAIN_CHUNK], 1, "online")
            for i in range(0, bh, PLAIN_CHUNK)])

    out = fa.flash_attention_folded(q, k, v)
    ref = folded_plain()
    torch.cuda.synchronize()
    _f32_record(results, (name, "folded", d), f"{name} [{bh},{n},{d}]", out,
                ref, _time_ms(lambda: fa.flash_attention_folded(q, k, v), 3),
                _time_ms(folded_plain, 2), sdpa_ms(q, k, v, 1),
                bound_f32(4.0 * bh * n * n * d, 4 * 4 * bh * n * d),
                "; device ms per launch: " + launch_split(
                    lambda: fa.flash_attention_folded(q, k, v), 2))
    del q, k, v, out, ref
    torch.cuda.empty_cache()
    check_split(results, gen)
    check_f32_train_kernels(results, gen)
    check_f32_convs(results, gen)
    return results


def check_f32_convs(results: dict, gen) -> None:
    """The fp32 nine-tap and Winograd kernels against their plain versions
    at all nine CONV_CASES, TF32 off: CUDA-event times of the kernel on
    its prepared weight ("ms", what a cached Conv2d runs; the nine-tap's
    includes its split of x), of the whole call with the weight's
    preparation ("call_ms", what the autograd path runs), of the plain
    version and of cuDNN's fp32 F.conv2d; the bound, the blocks launched
    (against 132 SMs) and the device ms of each launch inside "ms". The
    nine-tap's split of x is held to its plain version bit for bit."""
    import torch
    import torch.nn.functional as F

    from marigold_tpu_torch.ops import conv as conv_ops
    from marigold_tpu_torch.ops import winograd as wino_ops

    for name, b, c, k, hw in CONV_CASES:
        x = torch.randn((b, c, hw, hw), generator=gen, device="cuda")
        w = (torch.randn((k, c, 3, 3), generator=gen, device="cuda")
             / (3.0 * c ** 0.5))
        bias = torch.randn((k,), generator=gen, device="cuda")
        lib_ms = _time_ms(lambda: F.conv2d(x, w, bias, padding=1), 10)
        nbytes = 4 * (x.numel() + w.numel() + k + b * k * hw * hw)
        same = torch.equal(conv_ops.split_x_tf32(x),
                           conv_ops.split_x_tf32_plain(x))
        print(f"fp32 conv3x3 split of x {name}: bit-identical to plain: "
              f"{same}", flush=True)
        if not same:
            _fail(f"fp32 conv3x3 split of x {name} differs from plain")
        for kname, mod, fn, plain, flops_per in (
                ("conv3x3", conv_ops, conv_ops.conv3x3, conv_ops.conv3x3_plain,
                 18),
                ("winograd", wino_ops, wino_ops.winograd3x3,
                 wino_ops.winograd3x3_plain, 8)):
            prepared = mod.prepare_weight(w)
            out = fn(x, w, bias, prepared=prepared)
            ref = plain(x, w, bias)
            torch.cuda.synchronize()
            ms = _time_ms(lambda: fn(x, w, bias, prepared=prepared), 10)
            call_ms = _time_ms(lambda: fn(x, w, bias), 5)
            split = launch_split(lambda: fn(x, w, bias, prepared=prepared))
            n_blocks = mod.blocks_f32(b, c, hw, hw, k)
            _f32_record(results, (kname, name),
                        f"{kname:8s} {name:15s} [{b},{c},{hw},{hw}]->{k}", out,
                        ref, ms, _time_ms(lambda: plain(x, w, bias), 2),
                        lib_ms, bound_f32(flops_per * b * hw * hw * c * k,
                                          nbytes),
                        f"; {18.0 * b * hw * hw * c * k / ms / 1e9:.1f} "
                        f"direct-conv TFLOP/s; call with the weight's "
                        f"preparation {call_ms:.3f} ms; blocks {n_blocks} (132 "
                        f"SMs); device ms per launch: {split}")
            results[(kname, name)].update(call_ms=call_ms, blocks=n_blocks)
            del out, ref, prepared
        del x, w
        torch.cuda.empty_cache()


# The operand split's shapes: the d=512 forward's (q, k, v^T) at the VAE
# mid shape, the row of the JSON line, and the fp32 backward's seven jobs
# (q, dO, k, v, q^T, dO^T, k^T: split_bwd_f32) at the first training shape.
SPLIT_CASES = [("vae_mid", 1, 9216, 9216, 512, 2, 1),
               ("train_l0", 2, 4800, 4800, 320, 4, 3)]


def check_split(results: dict, gen) -> None:
    """The operand split (csrc/tf32_split.cu) against its plain version,
    bit for bit, and its time beside the bytes' bound."""
    import torch

    from marigold_tpu_torch.ops import flash_attention as fa

    for name, b, nq, nk, c, n_rows, n_cols in SPLIT_CASES:
        q, g = (torch.randn((b, nq, c), generator=gen, device="cuda")
                for _ in range(2))
        k, v = (torch.randn((b, nk, c), generator=gen, device="cuda")
                for _ in range(2))
        rows, cols = ([q, k], [v]) if n_rows == 2 else ([q, g, k, v],
                                                        [q, g, k])

        def plain():
            return ([fa.split_tf32_plain(x) for x in rows]
                    + [fa.split_tf32_plain(fa.transpose_tf32_plain(x))
                       for x in cols])

        got, ref = fa.split_tf32(rows, cols), plain()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for pg, pr in zip(got, ref)
                   for x, y in zip(pg, pr))
        print(f"tf32 split {name}: {len(rows)} tensors and {len(cols)} "
              f"transposed, bit-identical to plain: {same}", flush=True)
        out = torch.cat([t.flatten() for pair in got for t in pair])
        expect = torch.cat([t.flatten() for pair in ref for t in pair])
        del got, ref
        nbytes = 12 * sum(x.numel() for x in rows + cols)
        _f32_record(results, ("tf32_split", name),
                    f"tf32 split {name} [{b},{nq}/{nk},{c}]", out, expect,
                    _time_ms(lambda: fa.split_tf32(rows, cols), 10),
                    _time_ms(plain, 3), None, bound_f32(0.0, nbytes),
                    f"; {nbytes / 1e9:.3f} GB moved", tol=SPLIT_TOL)
        del q, g, k, v, rows, cols, out, expect
        torch.cuda.empty_cache()


def check_f32_train_kernels(results: dict, gen) -> None:
    """The fp32 training kernels (lse forward, dQ, dK/dV) against their
    plain versions, TF32 off, into `results` under (case, "train", what);
    the padded lse and delta rows the dQ kernel writes against bwd_stats;
    the times of the kernel (the forward's and dQ's with their split, dK/dV
    on dQ's pairs), the plain version and SDPA in fp32, forward and whole
    backward; the bounds against the fp32 peak."""
    import torch

    from marigold_tpu_torch.ops import flash_attention as fa

    for name, b, nq, nk, c, heads in TRAIN_KERNEL_CASES:
        if name not in F32_TRAIN_CASES:
            continue
        q, g = (torch.randn((b, nq, c), generator=gen, device="cuda")
                for _ in range(2))
        k, v = (torch.randn((b, nk, c), generator=gen, device="cuda")
                for _ in range(2))
        d = c // heads
        out, lse = fa.flash_attention_lse(q, k, v, heads)
        before = dict(fa.launches_f32)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, g, heads)
        got = {key: n - before.get(key, 0) for key, n in fa.launches_f32.items()
               if n != before.get(key, 0)}
        want = {"bwd_dq_d64": 1, "tf32_split": 1, "bwd_dkv_d64": 1}
        if got != want:  # one split, read by both 3xTF32 kernels
            _fail(f"fp32 kernel {name} bwd: launches {got} != {want}")
        out_p, lse_p = fa.flash_attention_lse_plain(q, k, v, heads)
        refs = fa.flash_attention_bwd_plain(q, k, v, g, heads)
        # the kernels use no atomics: a second call gives the same bits
        again = fa.flash_attention_bwd(q, k, v, out, lse, g, heads)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        print(f"fp32 kernel {name} bwd: two calls bit-identical: {same}",
              flush=True)
        if not same:
            _fail(f"fp32 kernel {name}: two backward calls differ")
        del again
        # the padded statistics the dQ kernel writes, against bwd_stats
        parts = fa.split_bwd_f32(q, k, v, g)
        _, lse_pad, delta_pad = fa.flash_attention_bwd_dq_f32(
            q, k, v, out, lse, g, heads, parts)
        lse_ref, delta_ref = fa.bwd_stats(out, lse, g, heads)
        torch.cuda.synchronize()
        d_err = (delta_pad - delta_ref).abs().max().item()
        d_tol = F32_TOL_REL * delta_ref.abs().max().item() + F32_TOL_ABS
        print(f"fp32 kernel {name} dQ's padded rows: lse bit-identical to "
              f"bwd_stats: {torch.equal(lse_pad, lse_ref)}; delta max_abs_err "
              f"{d_err:.3e} tol {d_tol:.3e}", flush=True)
        if not torch.equal(lse_pad, lse_ref) or not d_err <= d_tol:
            _fail(f"fp32 kernel {name}: dQ's padded lse/delta rows differ "
                  "from bwd_stats")
        del lse_ref, delta_ref
        fwd = (_time_ms(lambda: fa.flash_attention_lse(q, k, v, heads), 10),
               _time_ms(lambda: fa.flash_attention_lse_plain(q, k, v, heads), 3),
               sdpa_ms(q, k, v, heads))
        dq_ms = _time_ms(lambda: fa.flash_attention_bwd_dq_f32(
            q, k, v, out, lse, g, heads), 10)
        dq_kernel_ms = _time_ms(lambda: fa.flash_attention_bwd_dq_f32(
            q, k, v, out, lse, g, heads, parts), 10)
        dkv_ms = _time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, g, lse_pad, delta_pad, heads, parts), 10)
        per_launch = {
            "out": launch_split(lambda: fa.flash_attention_lse(q, k, v, heads)),
            "dq": launch_split(lambda: fa.flash_attention_bwd_dq_f32(
                q, k, v, out, lse, g, heads))}
        bwd_ms = _time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, g, heads), 10)
        bwd_plain_ms = _time_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, g, heads), 3)
        bwd_lib_ms = sdpa_ms(q, k, v, heads, backward=True)
        # as the bf16 rows count them: the forward 4, dQ 6 (S, dP, dQ) and
        # dK/dV 8 (S, dP, dV, dK) N^2 d per head; fp32 [B, N, C] tensors
        # read or written (dQ reads O for delta), and the fp32 row
        # statistics (dQ reads lse and writes the padded lse and delta)
        pairs = b * heads * nq * nk * d
        stats = 4 * b * heads * nq

        def io(n_q, n_kv):
            return 4 * b * c * (n_q * nq + n_kv * nk)

        what = f"{name:12s} [{b},{nq}x{nk},{c}] h={heads}"
        for key, got, ref, ms, plain_ms, lib_ms, bb in (
                ("out", out, out_p, *fwd, bound_f32(4.0 * pairs, io(2, 2) + stats)),
                ("lse", lse, lse_p, *fwd, bound_f32(4.0 * pairs, io(2, 2) + stats)),
                ("dq", grads[0], refs[0], dq_ms, bwd_plain_ms, bwd_lib_ms,
                 bound_f32(6.0 * pairs, io(4, 2) + 3 * stats)),
                ("dk", grads[1], refs[1], dkv_ms, bwd_plain_ms, bwd_lib_ms,
                 bound_f32(8.0 * pairs, io(2, 4) + 2 * stats)),
                ("dv", grads[2], refs[2], dkv_ms, bwd_plain_ms, bwd_lib_ms,
                 bound_f32(8.0 * pairs, io(2, 4) + 2 * stats))):
            flops = {"out": 4, "lse": 4, "dq": 6}.get(key, 8) * pairs
            split = (f"; device ms per launch: {per_launch[key]}"
                     if key in per_launch else "")
            _f32_record(results, (name, "train", key), f"{what} {key:3s}", got,
                        ref, ms, plain_ms, lib_ms, bb,
                        f"; {flops / ms / 1e9:.1f} TFLOP/s{split}")
        print(f"  fp32 {what}: whole backward (split + dQ with delta + "
              f"dK/dV) {bwd_ms:.3f} ms ({14.0 * pairs / bwd_ms / 1e9:.1f} "
              f"TFLOP/s) against plain {bwd_plain_ms:.3f} ms and sdpa "
              f"{bwd_lib_ms:.3f} ms; the dQ kernel alone on the split "
              f"{dq_kernel_ms:.3f} ms (with the split {dq_ms:.3f}), dK/dV "
              f"{dkv_ms:.3f} ms", flush=True)
        del q, k, v, g, out, lse, grads, out_p, lse_p, refs, lse_pad, delta_pad
        del parts
        torch.cuda.empty_cache()


def f32_kernel_rows(results: dict, counts: dict) -> list:
    """The fp32 rows of the JSON line; `counts` are the fp32 counters'
    launches on the paths driven ("shifted_d64", ..., "lse_d64",
    "bwd_dq_d64", "bwd_dkv_d64", "conv3x3", "conv3x3_split", "winograd").
    A backward row's
    plain and library times are those of the whole backward."""
    rows = []
    for name, replaces, (mode, d), case, source in F32_ROWS:
        mine = {key: r for key, r in results.items()
                if len(key) == 3 and key[1] == mode and key[2] == d}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts.get(f"{mode}_d{d}", 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine.values()),
            **{k: mine[(case, mode, d)][k] for k in F32_ROW_TIMES},
        })
    name = F32_FOLDED_CASE[0]
    folded = results[(name, "folded", F32_FOLDED_CASE[3])]
    rows.append({"name": "flash_folded_f32", "route": "cuda",
                 "source": F32_D64_SOURCE,
                 "replaces": "marigold_tpu/ops/flash_attention.py:522",
                 "launches": sum(n for key, n in counts.items()
                                 if key.startswith("folded")),
                 **{k: folded[k] for k in ("max_abs_err",) + F32_ROW_TIMES}})
    for name, replaces, key, whats, source in F32_TRAIN_ROWS:
        timed = results[(F32_TRAIN_CASES[0], "train", whats[0])]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts.get(key, 0),
            "max_abs_err": max(r["max_abs_err"] for k, r in results.items()
                               if k[1] == "train" and k[2] in whats),
            **{k: timed[k] for k in F32_ROW_TIMES}})
    split = results[("tf32_split", SPLIT_CASES[0][0])]
    rows.append({"name": "tf32_split_f32", "route": "cuda",
                 "source": SPLIT_SOURCE,
                 "replaces": "marigold_tpu/ops/flash_attention.py:429",
                 "launches": counts.get("tf32_split", 0),
                 "max_abs_err": max(r["max_abs_err"] for k, r in results.items()
                                    if k[0] == "tf32_split"),
                 **{k: split[k] for k in F32_ROW_TIMES}})
    for kname, replaces, source in (
            ("conv3x3", "marigold_tpu/ops/conv.py:176",
             "marigold_tpu_torch/csrc/conv3x3_f32_sm90.cu"),
            ("winograd", "marigold_tpu/ops/winograd.py:251",
             "marigold_tpu_torch/csrc/winograd_f32_sm90.cu")):
        mine = [r for key, r in results.items() if key[0] == kname]
        r = results[(kname, CONV_ROW_CASE)]
        rows.append({"name": f"{kname}_f32", "route": "cuda",
                     "source": source, "replaces": replaces,
                     "launches": counts.get(kname, 0),
                     "max_abs_err": max(m["max_abs_err"] for m in mine),
                     **{k: r[k] for k in F32_ROW_TIMES + ("call_ms",)}})
        if kname == "conv3x3":  # its split of x, timed inside its ms
            rows[-1]["split_launches"] = counts.get("conv3x3_split", 0)
    return rows


def kernel_rows(results: dict, counts: dict) -> list:
    rows = []
    for name, replaces, (mode, d), case, source in KERNEL_ROWS:
        mine = {key: r for key, r in results.items()
                if key[1] == mode and (d is None or key[2] == d)}
        timed = next(r for key, r in mine.items() if key[0] == case)
        launches = sum(n for key, n in counts.items()
                       if key.startswith(mode) and
                       (d is None or key == f"{mode}_d{d}"))
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine.values()),
            **{k: timed[k] for k in ROW_TIMES},
            **({"shift_ms": timed["shift_ms"]} if mode == "shifted" else {}),
        })
    return rows


ROW_TIMES = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main(argv: list) -> None:
    import gc
    import tempfile

    import torch

    if argv not in ([], ["--f32-kernels"]):
        _fail(f"usage: python3 chip_smoke.py [--f32-kernels], got {argv}")
    t0 = time.perf_counter()

    def done(what: str) -> None:  # every phase shares the run's time limit
        print(f"chip_smoke.py at {time.perf_counter() - t0:.1f} s: {what} "
              "done", flush=True)

    smi = check_card()
    build_kernels()
    if argv:
        check_f32_kernels()
        done("the fp32 kernel checks")
        print(smi, flush=True)
        return
    results = check_kernels()
    folded_results = check_folded()
    conv_results = check_conv_kernels()
    train_results = check_train_kernels()
    f32_results = check_f32_kernels()
    done("the kernel checks")
    with tempfile.TemporaryDirectory() as root:
        depth_dir = os.path.join(root, "depth")
        pipe = load_serving_pipe(depth_dir)
        serve_counts = collections.Counter(serve(pipe))
        serve_counts.update(serve_ensembles(pipe))
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        done("serving")
        load_phase(depth_dir)
        done("the load phase")
        serve_counts.update(serve_modalities(root, depth_dir))
        done("the modalities")
        serve_counts.update(cli_phase(root, depth_dir))
        done("the CLI phase")
        f32_counts = full_precision_phase(root, depth_dir)
        tario_phase(root)
    folded_counts = folded_path()
    done("--full_precision, tar and folded phases")
    with tempfile.TemporaryDirectory() as base_ckpt:
        # one SD2 base checkpoint (4-channel UNet) for the training phases
        sd2 = os.path.join(base_ckpt, "stable-diffusion-2")
        write_checkpoint(sd2, 0, sd2=True)
        train_counts = collections.Counter(train_phase(sd2))
        done("the SD2 checkpoint and the training phase")
        f32_counts = collections.Counter(f32_counts)
        f32_counts.update(f32_train_phase(sd2))
        done("the fp32 fine-tuning phase")
        cli_train_counts = train_cli_phase(base_ckpt)
    train_counts.update(cli_train_counts)
    serve_counts.update(cli_train_counts)  # the serving kernels it ran
    rows = (kernel_rows(results, serve_counts)
            + train_kernel_rows(train_results, train_counts)
            + [folded_kernel_row(folded_results, folded_counts)]
            + conv_kernel_rows(conv_results, serve_counts)
            + f32_kernel_rows(f32_results, f32_counts))
    missing = [r["name"] for r in rows if r["launches"] == 0]
    # 9 bf16 rows; fp32: F32_ROWS, the folded entry, the training rows,
    # the split and the two convs
    if missing or len(rows) != 9 + len(F32_ROWS) + 4 + len(F32_TRAIN_ROWS):
        _fail(f"kernels never launched by the main path: {missing}")
    print(f"chip_smoke.py ran in {time.perf_counter() - t0:.1f} s", flush=True)
    print(smi, flush=True)
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


def check_map(depth, hw, what):
    import numpy as np

    if depth.shape != hw or not np.isfinite(depth).all() or \
            depth.min() < 0.0 or depth.max() > 1.0:
        _fail(f"{what}: shape {depth.shape} (want {hw}), range "
              f"[{np.nanmin(depth)}, {np.nanmax(depth)}]")


def request_chunks(pipe, hw: tuple, n_images: int, ensemble_size: int,
                   res: int = 768) -> tuple:
    """(processed size, denoise chunks, decode calls) of one request at
    processing resolution res: the port's chunking from the device's memory.
    __call__ (n_images=None) denoises and decodes per chunk; batch_call
    decodes by decode_chunking (which counts an IID row's decoded targets)."""
    from marigold_tpu_torch.pipelines import image_util
    from marigold_tpu_torch.pipelines.batchsize import find_batch_size

    core = pipe.core
    ph, pw = image_util.resize_max_res_shape(*hw, res) if max(hw) != res else hw
    ds = core.vae_cfg.downscale_factor
    total = (n_images or 1) * ensemble_size
    bs = min(find_batch_size(total, max(-(-ph // ds), -(-pw // ds)) * ds,
                             device=core.device), total)
    chunks = -(-total // bs)
    if n_images is None:
        return (ph, pw), chunks, chunks
    _, dec = core.decode_chunking(total, (ph, pw), pipe.mode, pipe.n_targets)
    return (ph, pw), chunks, -(-total // dec)


def expected_flash(pipe, hw: tuple, steps: int, n_images=None,
                   ensemble_size: int = 1, res: int = 768) -> dict:
    """{head width: launches} of the attentions with >= 1024 query and key
    tokens that one request at input size hw runs: UNet self-attentions per
    forward per denoise chunk (64 wide), plus the VAE mid attention (one
    512-wide head) in the encode call and, per decode call, once per
    decoded target group."""
    from marigold_tpu_torch.ops.attention import FLASH_MIN_SEQ

    (ph, pw), chunks, decodes = request_chunks(pipe, hw, n_images,
                                               ensemble_size, res)
    core = pipe.core
    ds = core.vae_cfg.downscale_factor
    h, w = -(-ph // ds), -(-pw // ds)
    out = collections.Counter()
    for n, d in flash_self_attentions(core.unet_cfg, h, w):
        out[d] += n * steps * chunks
    if h * w >= FLASH_MIN_SEQ:
        out[core.vae_cfg.block_out_channels[-1]] += 1 + decodes * pipe.n_targets
    return {d: n for d, n in out.items() if n}


def expected_flash_launches(pipe, hw: tuple, steps: int,
                            n_images=None, ensemble_size: int = 1) -> int:
    """All flash launches of one request (see expected_flash)."""
    return sum(expected_flash(pipe, hw, steps, n_images,
                              ensemble_size).values())


def flash_by_width(before: dict) -> dict:
    """{head width: serving flash launches} since the counts `before`."""
    import re

    from marigold_tpu_torch.ops import flash_attention as fa

    out = collections.Counter()
    for key, n in fa.launches.items():
        m = re.fullmatch(r"(shifted|online)_d(\d+)", key)
        if m and n > before.get(key, 0):
            out[int(m.group(2))] += n - before.get(key, 0)
    return dict(out)


def gated_convs(pipe, hw: tuple, mode: str) -> dict:
    """3x3 convs that conv mode `mode` sends to a kernel, per UNet forward,
    VAE encode and VAE decode at input size hw: counted from the shapes of
    the port's modules run on the meta device (under the default mode)."""
    import dataclasses

    import torch

    from marigold_tpu_torch.models import layers
    from marigold_tpu_torch.models.unet import UNet2DConditionModel
    from marigold_tpu_torch.models.vae import AutoencoderKL

    core = pipe.core
    ds = core.vae_cfg.downscale_factor
    h, w = -(-hw[0] // ds), -(-hw[1] // ds)
    with torch.device("meta"):
        unet = UNet2DConditionModel(core.unet_cfg)
        vae = AutoencoderKL(dataclasses.replace(core.vae_cfg))

    def calls(model, *args):
        seen = []

        def hook(mod, inp, out):
            seen.append((inp[0].shape, mod.weight.shape, mod.stride,
                         mod.padding))

        handles = [m.register_forward_hook(hook) for m in model.modules()
                   if isinstance(m, layers.Conv2d)]
        with torch.no_grad():
            model(*args)
        for hd in handles:
            hd.remove()
        return seen

    lat_ch = core.vae_cfg.latent_channels
    ctx = torch.empty((1, 2, core.unet_cfg.cross_attention_dim), device="meta")
    shapes = {
        "unet": calls(unet, torch.empty((1, 2 * lat_ch, h, w), device="meta"),
                      1, ctx),
        "encode": calls(vae.encoder, torch.empty((1, 3, h * ds, w * ds),
                                                 device="meta")),
        "decode": calls(vae.decoder, torch.empty((1, lat_ch, h, w),
                                                 device="meta")),
    }
    saved, layers._CONV_IMPL = layers._CONV_IMPL, mode
    try:
        return {part: sum(layers.conv_impl_for(*c, torch.bfloat16) is not None
                          for c in cs) for part, cs in shapes.items()}
    finally:
        layers._CONV_IMPL = saved


def load_serving_pipe(root: str):
    """Phase 4: the full-width depth checkpoint, written under root and
    loaded."""
    import torch

    from marigold_tpu_torch import MarigoldDepthPipeline

    t0 = time.perf_counter()
    write_checkpoint(root, 0)
    print(f"checkpoint written in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pipe = MarigoldDepthPipeline.from_pretrained(
        root, dtype=torch.bfloat16, device="cuda", variant="fp16")
    torch.cuda.synchronize()
    print(f"from_pretrained(device='cuda', bf16) in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    return pipe


def _timed(fn):
    """(fn(), host ms) around work that ends in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def serve(pipe) -> dict:
    """Phase 5, E=1. Returns the flash launch counts of its run."""
    import numpy as np
    import torch

    from marigold_tpu_torch.ops import attention as attn
    from marigold_tpu_torch.ops import flash_attention as fa

    seed = 0
    steps = 4
    rng = np.random.default_rng(seed)
    shapes = [(768, 768), (480, 640), (375, 1242)]
    images = {hw: rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in shapes}
    batch = [rng.integers(0, 256, (768, 768, 3), dtype=np.uint8) for _ in range(3)]

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
                out, ms = _timed(lambda: pipe(
                    images[hw], denoising_steps=steps, ensemble_size=1,
                    seed=seed, color_map=None))
                got = sum(fa.launches.values()) - before
                total_expected += want
                check_map(out.depth_np, hw, f"__call__ {hw} {mode}")
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
        outs, ms = _timed(lambda: pipe.batch_call(
            batch, denoising_steps=steps, ensemble_size=1, seed=seed,
            processing_res=768, compact_readback=True))
        got = sum(fa.launches.values()) - before
        total_expected += want
        if got != want:
            _fail(f"batch flash launches {got} != {want}")
        for i, o in enumerate(outs):
            check_map(o.depth_np, (768, 768), f"batch_call image {i}")
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


# The folded flash entry (TPU kernel 7, no package caller): [B*5, 9216, 64],
# the level-0 self-attention of one image (B=1, scripts/profile_attention.py)
# and of the E=10 rows (B=10).
FOLDED_CASES = [("folded_b1", 5, 9216, 64), ("folded_b10", 50, 9216, 64)]
FOLDED_ROW_CASE = "folded_b10"
PLAIN_CHUNK = 5  # folded rows per plain call: [5, N, N] fp32 logits


def check_folded() -> dict:
    """Kernel 7 against its plain version (the plain online forward with one
    head, run in chunks of PLAIN_CHUNK rows so its [BH, N, N] logits fit)."""
    import torch

    from marigold_tpu_torch.ops import flash_attention as fa

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, bh, n, d in FOLDED_CASES:
        q, k, v = (torch.randn((bh, n, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))

        def plain():
            return torch.cat([
                fa.flash_attention_plain(q[i:i + PLAIN_CHUNK], k[i:i + PLAIN_CHUNK],
                                         v[i:i + PLAIN_CHUNK], 1, "online")
                for i in range(0, bh, PLAIN_CHUNK)])

        out = fa.flash_attention_folded(q, k, v)
        ref = plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL_REL * ref.float().abs().max().item() + TOL_ABS
        ms = _time_ms(lambda: fa.flash_attention_folded(q, k, v), 10)
        plain_ms = _time_ms(plain, 3)
        lib_ms = sdpa_ms(q, k, v, 1)
        b_ms, b_by = attention_bound(bh, 1, n, n, d, 4, 2, 2)
        print(f"kernel {name:15s} online  [{bh},{n},{d}]: max_abs_err {err:.3e} "
              f"tol {tol:.3e} | kernel {ms:.3f} ms "
              f"({4.0 * bh * n * n * d / ms / 1e9:.1f} TFLOP/s) plain "
              f"{plain_ms:.3f} ms sdpa {lib_ms:.3f} ms bound {b_ms:.3f} ms "
              f"({b_by})", flush=True)
        if not err <= tol or not bool(torch.isfinite(out.float()).all()):
            _fail(f"folded flash {name}: max_abs_err {err} > {tol}")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return results


def folded_path() -> dict:
    """The folded entry's own path, as a caller of the public function runs
    it: one call at each shape, counts cleared before and read after."""
    import torch

    from marigold_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    fa.launches.clear()
    for name, bh, n, d in FOLDED_CASES:
        q, k, v = (torch.randn((bh, n, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out = fa.flash_attention_folded(q, k, v)
        torch.cuda.synchronize()
        if out.shape != q.shape or not bool(torch.isfinite(out.float()).all()):
            _fail(f"folded flash path {name}: bad output")
    counts = dict(fa.launches)
    if counts != {"folded_d64": len(FOLDED_CASES)}:
        _fail(f"folded path launches {counts}")
    print(f"folded flash path: launches {counts}", flush=True)
    return counts


# The conv kernels at the main path's shapes (name, B, C, K, H=W): the UNet
# levels at the E=10 batch and the VAE encoder and decoder levels at 768 px
# (batch 1, the encode's batch). CONV_ROW_CASE stands for the kernels in the
# JSON line.
CONV_CASES = [
    ("unet_640", 10, 640, 640, 48),
    ("unet_1280", 10, 1280, 1280, 24),
    ("unet_2560_1280", 10, 2560, 1280, 12),
    ("unet_1920_1280", 10, 1920, 1280, 24),
    ("unet_1920_640", 10, 1920, 640, 48),
    ("vae_512_96", 1, 512, 512, 96),
    ("vae_512_192", 1, 512, 512, 192),
    ("vae_256_384", 1, 256, 256, 384),
    ("vae_128_768", 1, 128, 128, 768),
]
CONV_ROW_CASE = "unet_1280"


def launch_split(fn, iters: int = 5) -> str:
    """Mean device ms per call of each kernel that fn() launches, from
    torch.profiler over `iters` calls (after one warm-up call)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    def short(key):
        m = re.search(r"(\w+_kernel)(<\w+>)?", key)
        return m.group(0) if m else key[:40]

    return ", ".join(f"{short(e.key)} {e.self_device_time_total / 1e3 / iters:.3f}"
                     for e in sorted(events, key=lambda e: -e.self_device_time_total))


def check_conv_kernels() -> dict:
    """Kernels 8 and 9 against their plain versions at CONV_CASES: errors,
    CUDA-event times of the kernel on its rearranged weight (what the
    serving path's cached Conv2d runs: "ms"), of the whole call with the
    weight rearrangement ("call_ms") and of the rearrangement alone
    ("rearrange_ms"), the device time of each launch inside "ms" (the
    nine-tap's NHWC copy of x and conv, Winograd's input transform and
    GEMM; PyTorch's permute-copy to NHWC beside them for scale), the plain
    version and F.conv2d (cuDNN, bf16), the blocks launched (against 132
    SMs), and bounds. Tolerance: both sum exact bf16 products
    (Winograd: identically rounded U and V) in fp32 in another order and
    round the output to bf16, TOL_REL * max|ref| + TOL_ABS."""
    import torch
    import torch.nn.functional as F

    from marigold_tpu_torch.ops import conv as conv_ops
    from marigold_tpu_torch.ops import winograd as wino_ops

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    kernels = (("conv3x3", conv_ops, conv_ops.conv3x3, conv_ops.conv3x3_plain,
                conv_ops.taps, 18),
               ("winograd", wino_ops, wino_ops.winograd3x3,
                wino_ops.winograd3x3_plain, wino_ops.filter_transform, 8))
    for name, b, c, k, hw in CONV_CASES:
        x = torch.randn((b, c, hw, hw), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, c, 3, 3), generator=gen, device="cuda")
             / (3.0 * c ** 0.5)).to(torch.bfloat16)
        bias = torch.randn((k,), generator=gen, device="cuda").to(torch.bfloat16)
        lib_ms = _time_ms(lambda: F.conv2d(x, w, bias, padding=1), 10)
        nhwc_ms = _time_ms(lambda: x.permute(0, 2, 3, 1).contiguous(), 10)
        nbytes = 2 * (x.numel() + w.numel() + k + b * k * hw * hw)
        for kname, mod, fn, plain, prepare, flops_per_px_ck in kernels:
            prepared = prepare(w)
            out = fn(x, w, bias, prepared=prepared)
            ref = plain(x, w, bias)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL_REL * ref.float().abs().max().item() + TOL_ABS
            ms = _time_ms(lambda: fn(x, w, bias, prepared=prepared), 10)
            call_ms = _time_ms(lambda: fn(x, w, bias), 10)
            prep_ms = _time_ms(lambda: prepare(w), 10)
            plain_ms = _time_ms(lambda: plain(x, w, bias), 3)
            flops = flops_per_px_ck * b * hw * hw * c * k
            b_ms, b_by = bound(flops, nbytes)
            direct_ms, _ = bound(18 * b * hw * hw * c * k, nbytes)
            n_blocks = mod.blocks(b, c, hw, hw, k)
            split = launch_split(lambda: fn(x, w, bias, prepared=prepared))
            print(f"kernel {kname:8s} {name:15s} [{b},{c},{hw},{hw}]->{k}: "
                  f"max_abs_err {err:.3e} tol {tol:.3e} | kernel {ms:.3f} ms "
                  f"({18.0 * b * hw * hw * c * k / ms / 1e9:.1f} direct-conv "
                  f"TFLOP/s"
                  + (f"; NHWC copy of x by PyTorch's permute {nhwc_ms:.3f} ms"
                     if kname == "conv3x3" else "")
                  + f") call with the weight rearrangement {call_ms:.3f} ms "
                  f"(rearrangement {prep_ms:.3f} ms = "
                  f"{100.0 * prep_ms / call_ms:.1f}% of the call) plain "
                  f"{plain_ms:.3f} ms cudnn {lib_ms:.3f} ms bound {b_ms:.3f} "
                  f"ms ({b_by}; direct conv {direct_ms:.3f}) blocks "
                  f"{n_blocks} (132 SMs); device ms per launch: {split}",
                  flush=True)
            if not err <= tol or not bool(torch.isfinite(out.float()).all()):
                _fail(f"{kname} {name}: max_abs_err {err} > {tol}")
            results[(kname, name)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, direct_bound_ms=direct_ms,
                call_ms=call_ms, rearrange_ms=prep_ms, blocks=n_blocks)
            del out, ref, prepared
        del x
        torch.cuda.empty_cache()
    return results


# The E=10 protocol (bench.py's): 4 trailing DDIM steps at 768 px. The
# reference-exact request runs its host solve (scipy, finite differences
# over the members) at a reduced size, E=3 at 384 px.
ENSEMBLE_SIZE = 10
REF_ENSEMBLE = (3, 384)
# An E=10 request under a conv kernel against the default (cuDNN) request
# on the same seed, held on the 10 decoded members in [0, 1] that the conv
# path produces: both are bf16 networks whose conv outputs round
# differently (Winograd also rounds its transformed input to bf16), carried
# through 4 steps and the decoder, like the attention-kernel swap that
# DEPTH_TOL bounds (measured on the E=1 map: max 2.4e-2, mean 1.5e-3, in
# PERF.md); a wrong kernel
# gives maps unrelated to the default ones (mean |diff| ~0.2). (max, mean)
# of |diff|. The ensembled
# map is reported, not held: with random weights the members are
# uncorrelated and their alignment has no well-defined optimum, so the
# solve amplifies any difference (tests/test_torch_pipeline.py's note).
CONV_MEMBER_TOL = {"pallas": (1e-1, 1e-2), "winograd": (1e-1, 1e-2)}


def serve_ensembles(pipe) -> dict:
    """Phase 6. Returns the launch counts of its runs: flash (default conv
    requests) and each conv kernel under its mode."""
    import numpy as np
    import torch

    from marigold_tpu_torch.models import layers
    from marigold_tpu_torch.ops import conv as conv_ops
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.ops import winograd as wino_ops
    from marigold_tpu_torch.pipelines import base
    from marigold_tpu_torch.pipelines import ensemble as ens

    seed, steps, E = 0, 4, ENSEMBLE_SIZE
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, (768, 768, 3), dtype=np.uint8)
    batch = [rng.integers(0, 256, (768, 768, 3), dtype=np.uint8) for _ in range(3)]
    solve_ms, members = [], []
    ensemble_depth = base.ensemble_depth

    def timed_solve(depth, **kw):
        members[:] = [depth.detach().clone()]
        out, ms = _timed(lambda: ensemble_depth(depth, **kw))
        solve_ms.append(ms)
        return out

    base.ensemble_depth = timed_solve

    def check_unc(out, what):
        u = out.uncertainty
        if u is None or u.shape != out.depth_np.shape or \
                not np.isfinite(u).all() or u.min() < 0.0:
            _fail(f"{what}: uncertainty {None if u is None else u.shape}")

    def request(**kw):
        return pipe(image, denoising_steps=steps, ensemble_size=E, seed=seed,
                    color_map=None, **kw)

    # default conv: __call__, cold then warm
    fa.launches.clear()
    ens.solve_stats.clear()
    want_call = expected_flash_launches(pipe, (768, 768), steps,
                                        ensemble_size=E)
    maps, times = [], []
    for _ in range(3):
        before = sum(fa.launches.values())
        out, ms = _timed(request)
        got = sum(fa.launches.values()) - before
        check_map(out.depth_np, (768, 768), f"E={E} __call__")
        check_unc(out, f"E={E} __call__")
        if got != want_call:
            _fail(f"E={E} flash launches {got} != {want_call}")
        maps.append(out)
        times.append(ms)
    if any(not np.array_equal(maps[0].depth_np, m.depth_np) or
           not np.array_equal(maps[0].uncertainty, m.uncertainty)
           for m in maps[1:]):
        _fail(f"E={E}: same seed gave different maps")
    stats = dict(ens.solve_stats)
    (_, _), chunks, _ = request_chunks(pipe, (768, 768), None, E)
    print(f"E={E} __call__ 768x768, {steps} steps, {chunks} denoise chunk(s): "
          f"first {times[0]:.1f} ms, then {times[1]:.1f}, {times[2]:.1f} ms/map; "
          f"flash launches {want_call} per request, as expected; depth in "
          f"[{maps[0].depth_np.min():.3f}, {maps[0].depth_np.max():.3f}], "
          f"uncertainty mean {maps[0].uncertainty.mean():.4f} max "
          f"{maps[0].uncertainty.max():.4f}; identical maps from one seed",
          flush=True)
    print(f"ensemble solve (gauge-anchored, on the card): "
          f"{', '.join(f'{t:.1f}' for t in solve_ms)} ms per request; per "
          f"solve {stats.get('iterations', 0) / stats['solves']:.1f} BFGS "
          f"iterations, {stats.get('evaluations', 0) / stats['solves']:.1f} "
          f"cost evaluations, {stats.get('syncs', 0) / stats['solves']:.1f} "
          f"host syncs", flush=True)
    default_map, default_members = maps[0].depth_np, members[0]
    solve_ms.clear()

    # batch_call of 3 images at E=10 (the bench.py protocol)
    want_batch = expected_flash_launches(pipe, (768, 768), steps,
                                         n_images=len(batch), ensemble_size=E)
    runs = []
    for _ in range(2):
        before = sum(fa.launches.values())
        outs, ms = _timed(lambda: pipe.batch_call(
            batch, denoising_steps=steps, ensemble_size=E, seed=seed,
            processing_res=768, compact_readback=True))
        got = sum(fa.launches.values()) - before
        if got != want_batch:
            _fail(f"E={E} batch flash launches {got} != {want_batch}")
        for i, o in enumerate(outs):
            check_map(o.depth_np, (768, 768), f"E={E} batch_call image {i}")
            check_unc(o, f"E={E} batch_call image {i}")
        runs.append((np.stack([o.depth_np for o in outs]), ms))
    if not np.array_equal(runs[0][0], runs[1][0]):
        _fail(f"E={E}: same seed gave different batch maps")
    (_, _), chunks, decodes = request_chunks(pipe, (768, 768), len(batch), E)
    print(f"E={E} batch_call 3x768x768 (uint16 readback), {chunks} denoise "
          f"chunk(s), {decodes} decode calls: first {runs[0][1]:.1f} ms, then "
          f"{runs[1][1]:.1f} ms = {runs[1][1] / len(batch):.1f} ms/map; solves "
          f"{', '.join(f'{t:.1f}' for t in solve_ms[-len(batch):])} ms; flash "
          f"launches {want_batch} per batch, as expected", flush=True)
    flash_counts = dict(fa.launches)
    print(f"E={E} flash launches by variant: {flash_counts}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)

    # the reference-exact mode: host scipy solve at a reduced size
    e_ref, res = REF_ENSEMBLE
    small = image[:res, :res]
    solve_ms.clear()
    out, ms = _timed(lambda: pipe(small, denoising_steps=steps,
                                  ensemble_size=e_ref, seed=seed,
                                  processing_res=res, color_map=None,
                                  ensemble_kwargs={"gauge_anchor": False}))
    check_map(out.depth_np, (res, res), "reference-exact request")
    check_unc(out, "reference-exact request")
    print(f"reference-exact (gauge_anchor=False) E={e_ref} {res}x{res}: "
          f"{ms:.1f} ms, of which the host scipy solve {solve_ms[0]:.1f} ms",
          flush=True)

    # two E=10 requests under each opt-in conv kernel: the first fills the
    # Conv2d weight caches, the second is warm
    conv_counts = {}
    (_, _), chunks, decodes = request_chunks(pipe, (768, 768), None, E)
    for mode, counter, key in (("pallas", conv_ops.launches, "conv3x3"),
                               ("winograd", wino_ops.launches, "winograd")):
        n = gated_convs(pipe, (768, 768), mode)
        want = n["encode"] + n["unet"] * steps * chunks + n["decode"] * decodes
        layers._CONV_IMPL = mode
        mode_ms, mode_solve, total = [], [], 0
        try:
            for _ in range(2):
                counter.clear()
                out, ms = _timed(request)
                got = dict(counter)
                total += got.get(key, 0)
                mode_ms.append(ms)
                mode_solve.append(solve_ms[-1])
                check_map(out.depth_np, (768, 768), f"E={E} under {mode}")
                check_unc(out, f"E={E} under {mode}")
                if got != {key: want}:
                    _fail(f"{mode}: conv launches {got} != {want} ({n} per "
                          "call)")
        finally:
            layers._CONV_IMPL = "xla"
        diff = (members[0] - default_members).abs()
        d_max, d_mean = diff.max().item(), diff.mean().item()
        d_map = np.abs(out.depth_np - default_map)
        tol_max, tol_mean = CONV_MEMBER_TOL[mode]
        print(f"E={E} __call__ under MARIGOLD_TPU_CONV={mode}: first "
              f"{mode_ms[0]:.1f} ms/map, warm {mode_ms[1]:.1f} ms/map (default "
              f"cuDNN request warm {times[1]:.1f}, {times[2]:.1f} ms/map), "
              f"solves {mode_solve[0]:.1f}, {mode_solve[1]:.1f} ms; "
              f"{key} launches {want} per request = {n['encode']} encode + "
              f"{n['unet']} x "
              f"{steps} steps x {chunks} + {n['decode']} x {decodes} decode, as "
              f"expected; the {E} decoded members against the default conv's: "
              f"max {d_max:.3e} mean {d_mean:.3e} (tol {tol_max}, {tol_mean}); "
              f"ensembled map: max {d_map.max():.3e} mean {d_map.mean():.3e}",
              flush=True)
        if not (d_max <= tol_max and d_mean <= tol_mean):
            _fail(f"{mode}: members differ from the default conv's by max "
                  f"{d_max} mean {d_mean}")
        conv_counts[key] = total
        layers._CONV_IMPL = mode
        try:
            profile_request(request, what=f"one E={E} 768x768 request under "
                            f"MARIGOLD_TPU_CONV={mode}")
        finally:
            layers._CONV_IMPL = "xla"
    base.ensemble_depth = ensemble_depth

    print(f"one E={E} 768x768 request:", flush=True)
    profile_request(request)
    return {**flash_counts, **conv_counts}


# The other modalities and the legacy LCM depth model at full SD2 width (the
# JAX package's serving points): normals 4 steps at 768 px (E=1, E=10, a
# 3-image E=10 batch); IID appearance 4 steps E=1 at 768 px and a 16-image
# batch at 640 px; IID lighting (3 targets) E=1 at 768 px; LCM depth 1 step
# E=10 and 4 steps E=1 at 768 px. Each UNet is random from its own seed and
# shares the depth checkpoint's VAE and text encoder.
MODALITY_STEPS = 4
MODALITY_HW = (768, 768)
IID_TARGETS = {
    "appearance": {
        "target_names": ["albedo", "material"],
        "albedo": {"prediction_space": "srgb", "up_to_scale": False},
        "material": {"prediction_space": "stack",
                     "sub_target_names": ["roughness", "metallicity", None]}},
    "lighting": {
        "target_names": ["albedo", "shading", "residual"],
        "albedo": {"prediction_space": "srgb", "up_to_scale": False},
        "shading": {"prediction_space": "linear", "up_to_scale": True},
        "residual": {"prediction_space": "linear", "up_to_scale": True}},
}
IID_BATCH = (16, 640)  # NI, px: the JAX package's IID serving point
# diffusers LCMScheduler's defaults
LCM_SCHEDULER = {"_class_name": "LCMScheduler", "num_train_timesteps": 1000,
                 "beta_start": 0.00085, "beta_end": 0.012,
                 "beta_schedule": "scaled_linear", "prediction_type": "epsilon",
                 "timestep_spacing": "leading", "steps_offset": 1,
                 "rescale_betas_zero_snr": False, "set_alpha_to_one": True,
                 "original_inference_steps": 50}
UNIT_TOL = 1e-3  # | |n| - 1 | of a normals map
# The E=10 normals request with the kernels against the same request on
# plain attention (members from the same noise; bf16 rounding carried
# through 4 steps and the decoder, as DEPTH_TOL bounds for depth): the
# median angle between the two members' mean directions and between the
# two "closest" maps, and the share of pixels of the closest maps more than
# 10 degrees apart (its argmax flips at near-ties). Measured on the H100 at
# seed 0: 0.82 and 0.87 degrees, 4.2%; held at about 2.4 times those.
NORMALS_MEAN_DEG = 2.0
NORMALS_CLOSEST_DEG = 2.0
NORMALS_FLIP_SHARE = 0.1


def write_modality_checkpoint(root: str, depth_dir: str, seed: int,
                              in_ch: int, out_ch: int, index: dict) -> None:
    """A checkpoint dir with its own random full-width UNet (in_ch -> out_ch,
    fp16 variant) that links the depth checkpoint's VAE, text encoder and
    scheduler."""
    import torch

    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

    os.makedirs(root)
    for sub in ("vae", "text_encoder", "scheduler"):
        os.symlink(os.path.join(depth_dir, sub), os.path.join(root, sub))
    cfg = UNetConfig(in_channels=in_ch, out_channels=out_ch)
    with torch.device("meta"):
        model = UNet2DConditionModel(cfg)
    sd = W.random_state_dict(model, torch.Generator(device="cuda").manual_seed(seed),
                             dtype=torch.float16)
    W.save_component(cfg.to_dict(), sd, os.path.join(root, "unet"),
                     "diffusion_pytorch_model.fp16.safetensors")
    W.write_config(dict(index, default_denoising_steps=4,
                        default_processing_resolution=768), root,
                   "model_index.json")


def load_modality(cls, root: str):
    import torch

    t0 = time.perf_counter()
    pipe = cls.from_pretrained(root, dtype=torch.bfloat16, device="cuda",
                               variant="fp16")
    torch.cuda.synchronize()
    print(f"{cls.__name__}.from_pretrained({os.path.basename(root)}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return pipe


def free(pipe) -> None:
    import gc

    import torch

    pipe.core = None
    gc.collect()
    torch.cuda.empty_cache()


def gated_requests(what: str, fn, runs: int, want: dict, check, arrays) -> tuple:
    """fn() `runs` times: each checked by check(out), its flash launches by
    head width held to `want` exactly, its maps (arrays(out)) identical
    across runs. Prints first and median warm ms per call; returns
    (outputs, times)."""
    import numpy as np

    from marigold_tpu_torch.ops import flash_attention as fa

    outs, times = [], []
    for _ in range(runs):
        before = dict(fa.launches)
        out, ms = _timed(fn)
        got = flash_by_width(before)
        if got != want:
            _fail(f"{what}: flash launches by head width {got} != {want}")
        check(out)
        outs.append(out)
        times.append(ms)
    ref = arrays(outs[0])
    if any(not all(np.array_equal(a, b) for a, b in zip(ref, arrays(o)))
           for o in outs[1:]):
        _fail(f"{what}: same seed gave different maps")
    warm = sorted(times[1:]) or times
    print(f"{what}: first {times[0]:.1f} ms, then median "
          f"{warm[len(warm) // 2]:.1f} ms (runs "
          f"{', '.join(f'{t:.1f}' for t in times[1:])}); flash launches "
          f"{want} by head width per call, as expected; identical maps from "
          f"one seed", flush=True)
    return outs, times


def check_normals(out, hw, what: str, ensemble: bool) -> None:
    import numpy as np

    n, u = out.normals_np, out.uncertainty
    if n.shape != hw + (3,) or not np.isfinite(n).all():
        _fail(f"{what}: normals {n.shape} (want {hw + (3,)}) or non-finite")
    dev = np.abs(np.linalg.norm(n, axis=-1) - 1.0).max()
    if dev > UNIT_TOL:
        _fail(f"{what}: normals off the unit sphere by {dev}")
    if ensemble != (u is not None):
        _fail(f"{what}: uncertainty {None if u is None else u.shape}")
    if u is not None and (u.shape != hw or not np.isfinite(u).all()
                          or u.min() < 0.0 or u.max() > 1.0):
        _fail(f"{what}: uncertainty {u.shape}, [{u.min()}, {u.max()}]")


def check_iid(out, hw, what: str, names: list) -> None:
    import numpy as np

    if [e.name for e in out] != names or not out.is_complete:
        _fail(f"{what}: entries {[e.name for e in out]} (want {names})")
    for e in out:
        a = e.array
        if a.shape != (3,) + hw or not np.isfinite(a).all() or \
                a.min() < 0.0 or a.max() > 1.0 or e.uncertainty is not None:
            _fail(f"{what} {e.name}: {a.shape}, [{np.nanmin(a)}, "
                  f"{np.nanmax(a)}]")


def check_conv_in_gate(pipe, what: str) -> None:
    """The IID UNet's conv_in (12 or 16 input channels) and conv_out (8 or
    12 output channels) under every conv mode: the gate sends each to
    F.conv2d (cuDNN), no conv kernel launches, and the output is F.conv2d's
    to the bit."""
    import torch
    import torch.nn.functional as F

    from marigold_tpu_torch.models import layers
    from marigold_tpu_torch.ops import conv as conv_ops
    from marigold_tpu_torch.ops import winograd as wino_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    unet = pipe.core.unet
    for name in ("conv_in", "conv_out"):
        conv = getattr(unet, name)
        x = torch.randn((2, conv.in_channels, 96, 96), generator=gen,
                        device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            ref = F.conv2d(x, conv.weight, conv.bias, padding=conv.padding)
            for mode in layers.CONV_IMPLS:
                layers._CONV_IMPL = mode
                try:
                    before = sum(conv_ops.launches.values()) + \
                        sum(wino_ops.launches.values())
                    impl = layers.conv_impl_for(x.shape, conv.weight.shape,
                                                conv.stride, conv.padding,
                                                x.dtype)
                    out = conv(x)
                    torch.cuda.synchronize()
                    after = sum(conv_ops.launches.values()) + \
                        sum(wino_ops.launches.values())
                finally:
                    layers._CONV_IMPL = "xla"
                if impl is not None or after != before or \
                        not torch.equal(out, ref):
                    _fail(f"{what} {name} under {mode}: gate {impl}, "
                          f"{after - before} kernel launches")
        print(f"{what} {name} {conv.in_channels}->{conv.out_channels}: "
              f"cuDNN (F.conv2d, bit-identical) under every conv mode "
              f"{layers.CONV_IMPLS}, no conv kernel launch", flush=True)


def serve_modalities(root: str, depth_dir: str) -> dict:
    """Phase 7: normals, IID appearance and lighting, LCM depth, one
    pipeline at a time. Returns the flash launch counts of its runs."""
    from marigold_tpu_torch.ops import flash_attention as fa

    fa.launches.clear()  # these paths' run starts here
    serve_normals(root, depth_dir)
    serve_iid(root, depth_dir)
    serve_lcm(root, depth_dir)
    counts = dict(fa.launches)  # and ends here
    print(f"normals, IID and LCM flash launches by variant: {counts}",
          flush=True)
    return counts


def serve_normals(root: str, depth_dir: str) -> None:
    import numpy as np

    from marigold_tpu_torch import MarigoldNormalsPipeline
    from marigold_tpu_torch.ops import attention as attn
    from marigold_tpu_torch.pipelines import base

    path = os.path.join(root, "normals")
    write_modality_checkpoint(path, depth_dir, 1, 8, 4, {
        "_class_name": "MarigoldNormalsPipeline"})
    pipe = load_modality(MarigoldNormalsPipeline, path)
    seed, steps, E, hw = 0, MODALITY_STEPS, ENSEMBLE_SIZE, MODALITY_HW
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    batch = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for _ in range(3)]

    def arrays(out):
        outs = out if isinstance(out, list) else [out]
        return [a for o in outs for a in (o.normals_np, o.uncertainty)
                if a is not None]

    def request(e, **kw):
        return lambda: pipe(image, denoising_steps=steps, ensemble_size=e,
                            seed=seed, processing_res=hw[0], **kw)

    gated_requests(f"normals E=1 __call__ {hw[0]}x{hw[1]}", request(1), 3,
                   expected_flash(pipe, hw, steps),
                   lambda o: check_normals(o, hw, "normals E=1", False), arrays)
    members = []
    ensemble_normals = base.ensemble_normals

    def record(normals, **kw):
        members[:] = [normals.detach().clone()]
        return ensemble_normals(normals, **kw)

    base.ensemble_normals = record
    try:
        outs, _ = gated_requests(
            f"normals E={E} __call__ {hw[0]}x{hw[1]}", request(E), 2,
            expected_flash(pipe, hw, steps, ensemble_size=E),
            lambda o: check_normals(o, hw, f"normals E={E}", True), arrays)
        kernel_members = members[0]
        saved = attn.FLASH_MIN_SEQ
        attn.FLASH_MIN_SEQ = 1 << 30
        try:
            plain = request(E)()
        finally:
            attn.FLASH_MIN_SEQ = saved
        plain_members = members[0]
    finally:
        base.ensemble_normals = ensemble_normals
    check_normals(plain, hw, f"normals E={E} on plain attention", True)

    def degrees(a, b, axis):
        cos = (a * b).sum(axis) / (np.linalg.norm(a, axis=axis)
                                   * np.linalg.norm(b, axis=axis))
        return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))

    mean_k = kernel_members.float().mean(0).cpu().numpy()
    mean_p = plain_members.float().mean(0).cpu().numpy()
    mean_deg = degrees(mean_k, mean_p, 0)
    closest_deg = degrees(outs[0].normals_np, plain.normals_np, -1)
    flips = float((closest_deg > 10.0).mean())
    unc_diff = np.abs(outs[0].uncertainty - plain.uncertainty)
    print(f"normals E={E}, kernels vs plain attention: members' mean "
          f"direction median {np.median(mean_deg):.3f} deg, mean "
          f"{mean_deg.mean():.3f}, max {mean_deg.max():.3f}; closest map "
          f"median {np.median(closest_deg):.3f} deg, mean "
          f"{closest_deg.mean():.3f}, {100 * flips:.2f}% of pixels > 10 deg "
          f"(near-tie argmax flips); uncertainty max {unc_diff.max():.3e} "
          f"mean {unc_diff.mean():.3e}; uncertainty mean "
          f"{outs[0].uncertainty.mean():.4f}", flush=True)
    if not (np.median(mean_deg) <= NORMALS_MEAN_DEG
            and np.median(closest_deg) <= NORMALS_CLOSEST_DEG
            and flips <= NORMALS_FLIP_SHARE):
        _fail("normals with the kernels differ from plain attention beyond "
              f"({NORMALS_MEAN_DEG}, {NORMALS_CLOSEST_DEG} deg, "
              f"{NORMALS_FLIP_SHARE})")

    def batch_call(**kw):
        return lambda: pipe.batch_call(batch, denoising_steps=steps,
                                       ensemble_size=E, seed=seed,
                                       processing_res=hw[0], **kw)

    (_, _), chunks, decodes = request_chunks(pipe, hw, len(batch), E)
    want = expected_flash(pipe, hw, steps, n_images=len(batch), ensemble_size=E)

    def check_batch(outs):
        for i, o in enumerate(outs):
            check_normals(o, hw, f"normals E={E} batch_call image {i}", True)

    full, times = gated_requests(
        f"normals E={E} batch_call 3x{hw[0]}x{hw[1]} ({chunks} denoise chunk(s), "
        f"{decodes} decode calls)", batch_call(), 2, want, check_batch, arrays)
    compact, ctimes = gated_requests(
        f"normals E={E} batch_call 3x{hw[0]}x{hw[1]} uint16 readback", batch_call(
            compact_readback=True), 1, want, check_batch, arrays)
    diff = max(np.abs(c.normals_np - f.normals_np).max()
               for c, f in zip(compact[0], full[0]))
    lo = min(c.normals_np.min() for c in compact[0])
    # half a uint16 step of (x+1)/2, back in [-1, 1], plus fp32 rounding
    print(f"normals uint16 readback against float: max {diff:.3e} (tol "
          f"{1 / 65535 + 1e-6:.3e}), min component {lo:.4f}; "
          f"{times[-1] / 3:.1f} ms/map float, {ctimes[0] / 3:.1f} ms/map uint16",
          flush=True)
    if diff > 1 / 65535 + 1e-6 or lo > -0.5:
        _fail("normals uint16 readback differs from the float readback")
    profile_request(request(E), what=f"one normals E={E} {hw[0]}x{hw[1]} request")
    free(pipe)


def serve_iid(root: str, depth_dir: str) -> None:
    import numpy as np

    from marigold_tpu_torch import MarigoldIIDPipeline

    seed, steps, hw = 0, MODALITY_STEPS, MODALITY_HW
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    for variant, seed_w in (("appearance", 2), ("lighting", 3)):
        props = IID_TARGETS[variant]
        n = len(props["target_names"])
        path = os.path.join(root, f"iid_{variant}")
        write_modality_checkpoint(path, depth_dir, seed_w, 4 * (n + 1), 4 * n, {
            "_class_name": "MarigoldIIDPipeline", "target_properties": props})
        pipe = load_modality(MarigoldIIDPipeline, path)
        if pipe.n_targets != n:
            _fail(f"IID {variant}: {pipe.n_targets} targets, want {n}")
        check_conv_in_gate(pipe, f"IID {variant}")

        def arrays(out):
            outs = out if isinstance(out, list) else [out]
            return [e.array for o in outs for e in o]

        names = props["target_names"]
        outs, _ = gated_requests(
            f"IID {variant} ({n} targets) E=1 __call__ {hw[0]}x{hw[1]}",
            lambda: pipe(image, denoising_steps=steps, seed=seed,
                         processing_res=hw[0]),
            3 if variant == "appearance" else 2,
            expected_flash(pipe, hw, steps),
            lambda o: check_iid(o, hw, f"IID {variant}", names), arrays)
        print(f"IID {variant} maps: " + ", ".join(
            f"{e.name} mean {e.array.mean():.4f}" for e in outs[0]), flush=True)
        if variant == "appearance":
            ni, res = IID_BATCH
            bhw = (res, res)
            batch = [rng.integers(0, 256, bhw + (3,), dtype=np.uint8)
                     for _ in range(ni)]
            (_, _), chunks, decodes = request_chunks(pipe, bhw, ni, 1, res)
            _, dec = pipe.core.decode_chunking(ni, bhw, pipe.mode, pipe.n_targets)

            def run_batch():
                return pipe.batch_call(batch, denoising_steps=steps, seed=seed,
                                       processing_res=res)

            def check_batch(outs):
                for i, o in enumerate(outs):
                    check_iid(o, bhw, f"IID batch image {i}", names)

            _, times = gated_requests(
                f"IID appearance E=1 batch_call {ni}x{res}x{res} ({chunks} "
                f"denoise chunk(s), {decodes} decode calls of {dec} rows x "
                f"{n} targets)", run_batch, 2,
                expected_flash(pipe, bhw, steps, n_images=ni, res=res),
                check_batch, arrays)
            print(f"IID appearance NI={ni} @{res}px E=1: "
                  f"{times[-1] / ni:.1f} ms/map (warm)", flush=True)
            profile_request(run_batch, what=f"one IID appearance "
                            f"{ni}x{res}x{res} E=1 batch")
        free(pipe)


def serve_lcm(root: str, depth_dir: str) -> None:
    import numpy as np

    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.models import weights as W

    path = os.path.join(root, "lcm")
    os.makedirs(path)
    for sub in ("unet", "vae", "text_encoder", "model_index.json"):
        os.symlink(os.path.join(depth_dir, sub), os.path.join(path, sub))
    W.write_config(LCM_SCHEDULER, os.path.join(path, "scheduler"),
                   "scheduler_config.json")
    pipe = load_modality(MarigoldDepthPipeline, path)
    if pipe.core.lcm is None:
        _fail("the LCMScheduler checkpoint did not load as LCM")
    hw, E = MODALITY_HW, ENSEMBLE_SIZE
    image = np.random.default_rng(4).integers(0, 256, hw + (3,), dtype=np.uint8)
    draws = []
    step_noise = pipe.core.step_noise

    def counted(shape, gen):
        draws.append(shape)
        return step_noise(shape, gen)

    pipe.core.step_noise = counted

    def arrays(out):
        return [a for a in (out.depth_np, out.uncertainty) if a is not None]

    for steps, e in ((1, E), (4, 1)):
        def check(out, e=e):
            check_map(out.depth_np, hw, f"LCM {steps}-step E={e}")
            if (e > 1) != (out.uncertainty is not None):
                _fail(f"LCM E={e}: uncertainty")
        draws.clear()
        runs = 2
        gated_requests(f"LCM depth {steps}-step E={e} __call__ {hw[0]}x{hw[1]}",
                       lambda: pipe(image, denoising_steps=steps,
                                    ensemble_size=e, seed=0, color_map=None,
                                    processing_res=hw[0]),
                       runs, expected_flash(pipe, hw, steps, ensemble_size=e),
                       check, arrays)
        (_, _), chunks, _ = request_chunks(pipe, hw, None, e)
        if len(draws) != runs * chunks * (steps - 1):
            _fail(f"LCM {steps}-step: {len(draws)} fresh draws, want "
                  f"{runs * chunks * (steps - 1)}")
        print(f"LCM {steps}-step E={e}: {len(draws) // runs} fresh noise "
              f"draws per request ({chunks} chunk(s) x {steps - 1})", flush=True)
    free(pipe)


# Phase 8: the command-line entry points on the full-width checkpoints

CLI_STEPS = 4  # the checkpoints' default_denoising_steps
CLI_RES = 768  # and default_processing_resolution
CLI_HW = (768, 768)
RUN_SHAPES = [CLI_HW, CLI_HW, (480, 640)]
SERVE_IMAGES = 6  # CLI_HW, in batches of NI=3 at E=10, two in flight, then one
HTTP_BATCH_WAIT = 0.25
NYU_SPLIT = "data_split/nyu_depth/labeled/filename_list_test.txt"
NYU_DIR = "nyuv2/nyu_labeled_extracted.tar"  # a directory stands in for it
NYU_HW = (480, 640)


def pipe_spec(ckpt: str, mode: str, n_targets: int = 1):
    """What expected_flash reads of a pipeline (configs, device, mode),
    from a checkpoint's configs, for a pipeline that a CLI builds itself."""
    import types

    import torch

    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.unet import UNetConfig
    from marigold_tpu_torch.models.vae import VAEConfig
    from marigold_tpu_torch.pipelines.base import DiffusionCore

    core = types.SimpleNamespace(
        unet_cfg=UNetConfig.from_dict(W.read_config(os.path.join(ckpt, "unet"))),
        vae_cfg=VAEConfig.from_dict(W.read_config(os.path.join(ckpt, "vae"))),
        device=torch.device("cuda"),
        decode_chunking=DiffusionCore.decode_chunking)
    return types.SimpleNamespace(core=core, mode=mode, n_targets=n_targets)


class _LoadTimer:
    """Times every from_pretrained inside the block (the CLIs load their
    own pipelines), so that a CLI's wall time can be split into the load
    and the rest."""

    def __enter__(self):
        import torch

        from marigold_tpu_torch.pipelines import base

        self.seconds = 0.0
        self._orig = base.BasePipeline.__dict__["from_pretrained"]
        load = self._orig.__func__

        def timed(cls, *args, **kwargs):
            t = time.perf_counter()
            pipe = load(cls, *args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t
            return pipe

        base.BasePipeline.from_pretrained = classmethod(timed)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from marigold_tpu_torch.pipelines import base

        self.wall = time.perf_counter() - self.t0
        base.BasePipeline.from_pretrained = self._orig

    def ms_per(self, n: int) -> float:
        """ms per item of the wall time without the loads."""
        return (self.wall - self.seconds) * 1e3 / n


def _release() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _write_images(folder: str, shapes: list, seed: int) -> list:
    import numpy as np
    from PIL import Image

    os.makedirs(folder)
    rng = np.random.default_rng(seed)
    names = []
    for i, hw in enumerate(shapes):
        names.append(f"img{i}")
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(
            os.path.join(folder, f"img{i}.png"))
    return names


def _flash_gate(what: str, before: dict, want: dict, variant: str = None):
    """The flash launches since `before`, by head width, held to `want`;
    with `variant`, every one of them of that softmax mode."""
    from marigold_tpu_torch.ops import flash_attention as fa

    got = flash_by_width(before)
    if got != want:
        _fail(f"{what}: flash launches by head width {got} != {want}")
    if variant is not None:
        other = {k: n - before.get(k, 0) for k, n in fa.launches.items()
                 if n != before.get(k, 0) and not k.startswith(variant)}
        if other:
            _fail(f"{what}: launches other than {variant}: {other}")
    return got


def cli_validate(root: str, depth_dir: str) -> None:
    """validate_ckpt as a subprocess: the depth, normals and IID checkpoints
    pass; a unet/ whose header names one wrong shape fails with the
    diagnosis. The broken file holds its header only, which the validator
    must accept, since it reads no tensor byte. The two processes run
    together; the same validation in this process is timed beside them."""
    import shutil
    import struct

    from marigold_tpu_torch.models import manifest

    ckpts = [depth_dir] + [os.path.join(root, n) for n in (
        "normals", "iid_appearance", "iid_lighting")]
    broken = os.path.join(root, "broken")
    os.makedirs(os.path.join(broken, "unet"))
    for sub in ("vae", "text_encoder", "scheduler", "model_index.json"):
        os.symlink(os.path.join(depth_dir, sub), os.path.join(broken, sub))
    shutil.copy(os.path.join(depth_dir, "unet", "config.json"),
                os.path.join(broken, "unet"))
    fname = "diffusion_pytorch_model.fp16.safetensors"
    with open(os.path.join(depth_dir, "unet", fname), "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header["conv_out.bias"]["shape"] = [5]
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(os.path.join(broken, "unet", fname), "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)

    cmd = [sys.executable, "-m", "marigold_tpu_torch.cli.validate_ckpt",
           "--variant", "fp16"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + args, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for args in (ckpts, [broken])]
    (good, good_err), (bad, bad_err) = [p.communicate() for p in procs]
    wall = time.perf_counter() - t0
    if procs[0].returncode != 0 or good.count("RESULT: OK") != len(ckpts):
        _fail(f"validate_ckpt on the serving checkpoints: rc "
              f"{procs[0].returncode}\n{good}{good_err}")
    diag = "shape mismatch conv_out.bias: expected [4] got [5]"
    if procs[1].returncode == 0 or diag not in bad:
        _fail(f"validate_ckpt on a wrong shape: rc {procs[1].returncode}\n"
              f"{bad}{bad_err}")
    t1 = time.perf_counter()
    reports = [manifest.validate_checkpoint(d, "fp16") for d in ckpts]
    inproc = time.perf_counter() - t1
    if not all(r["ok"] for r in reports):
        _fail("validate_checkpoint in this process disagrees")
    print(f"validate_ckpt (two subprocesses together): {len(ckpts)} full-width "
          f"checkpoints OK; the header-only unet/ with one wrong shape exits "
          f"{procs[1].returncode} with '{diag}'; {wall * 1e3:.1f} ms wall for "
          f"both, process start and imports included; the same {len(ckpts)} "
          f"validations in this process {inproc * 1e3:.1f} ms", flush=True)


def cli_run(root: str, depth_dir: str) -> None:
    """run --modality depth at its defaults (bf16, Spectral through the
    port's own table) on two 768^2 images and one 480x640, E=10, 4 steps;
    then run --modality normals once at E=1."""
    import numpy as np
    from PIL import Image

    from marigold_tpu_torch.cli import run as run_cli
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.pipelines import image_util

    src, out = os.path.join(root, "run_in"), os.path.join(root, "run_out")
    names = _write_images(src, RUN_SHAPES, 5)
    spec = pipe_spec(depth_dir, "depth")
    want = collections.Counter()
    for hw in RUN_SHAPES:
        # run pads each image to the 64-px grid (shape_bucketing)
        ph, pw = image_util.resize_max_res_shape(*hw, CLI_RES)
        padded = (-(-ph // 64) * 64, -(-pw // 64) * 64)
        want.update(expected_flash(spec, padded, CLI_STEPS,
                                   ensemble_size=ENSEMBLE_SIZE,
                                   res=max(padded)))
    before = dict(fa.launches)
    with _LoadTimer() as timer:
        rc = run_cli.main(["--modality", "depth", "--checkpoint", depth_dir,
                           "--input_rgb_dir", src, "--output_dir", out,
                           "--ensemble_size", str(ENSEMBLE_SIZE), "--seed",
                           "0"])
    if rc != 0:
        _fail(f"run --modality depth exited {rc}")
    _flash_gate("run depth", before, dict(want))
    for name, hw in zip(names, RUN_SHAPES):
        depth = np.load(os.path.join(out, "depth_npy", f"{name}_pred.npy"))
        check_map(depth, hw, f"run {name}")
        bw = np.asarray(Image.open(os.path.join(out, f"{name}_depth_bw.png")))
        colored = Image.open(os.path.join(out, f"{name}_depth_colored.png"))
        if bw.dtype != np.uint16 or bw.shape != hw or colored.mode != "RGB" \
                or colored.size != hw[::-1]:
            _fail(f"run {name}: bw {bw.dtype} {bw.shape}, colored "
                  f"{colored.mode} {colored.size}")
    _release()
    print(f"run --modality depth (E={ENSEMBLE_SIZE}, {CLI_STEPS} steps, bf16, "
          f"Spectral): {len(names)} images in {timer.wall:.2f} s, of which "
          f"the load {timer.seconds:.2f} s: {timer.ms_per(len(names)):.1f} "
          f"ms/map with the npy and PNG writes; flash launches {dict(want)} "
          f"as expected; npy, 16-bit and RGB PNGs checked", flush=True)

    nsrc, nout = os.path.join(root, "run_n_in"), os.path.join(root, "run_n_out")
    _write_images(nsrc, RUN_SHAPES[:1], 6)
    normals = os.path.join(root, "normals")
    before = dict(fa.launches)
    with _LoadTimer() as timer:
        rc = run_cli.main(["--modality", "normals", "--checkpoint", normals,
                           "--input_rgb_dir", nsrc, "--output_dir", nout,
                           "--seed", "0"])
    if rc != 0:
        _fail(f"run --modality normals exited {rc}")
    _flash_gate("run normals", before, expected_flash(
        pipe_spec(normals, "normals"), RUN_SHAPES[0], CLI_STEPS, res=CLI_RES))
    n = np.load(os.path.join(nout, "normals_npy", "img0_pred.npy"))
    png = np.asarray(Image.open(os.path.join(nout, "img0_normals.png")))
    dev = np.abs(np.linalg.norm(n, axis=-1) - 1.0).max()
    if n.shape != RUN_SHAPES[0] + (3,) or dev > UNIT_TOL or \
            png.shape != RUN_SHAPES[0] + (3,) or png.dtype != np.uint8:
        _fail(f"run normals: {n.shape}, off the unit sphere by {dev}, png "
              f"{png.shape} {png.dtype}")
    _release()
    print(f"run --modality normals (E=1): 1 image, "
          f"{timer.ms_per(1):.1f} ms without the {timer.seconds:.2f} s load",
          flush=True)


def cli_serve_once(root: str, depth_dir: str) -> None:
    """serve --once: six 768^2 images, NI=3, E=10, with two batches in
    flight (the default) and then with one, timed in the same way."""
    import numpy as np
    import torch

    from marigold_tpu_torch.cli import serve as serve_cli
    from marigold_tpu_torch.ops import flash_attention as fa

    watch = os.path.join(root, "serve_in")
    names = _write_images(watch, [CLI_HW] * SERVE_IMAGES, 7)
    ni = 3
    per_batch = expected_flash(pipe_spec(depth_dir, "depth"), CLI_HW,
                               CLI_STEPS, n_images=ni,
                               ensemble_size=ENSEMBLE_SIZE, res=CLI_RES)
    want = {d: n * (SERVE_IMAGES // ni) for d, n in per_batch.items()}
    for in_flight in (2, 1):
        out = os.path.join(root, f"serve_out{in_flight}")
        before = dict(fa.launches)
        torch.cuda.reset_peak_memory_stats()
        with _LoadTimer() as timer:
            rc = serve_cli.main(["--checkpoint", depth_dir, "--watch_dir",
                                 watch, "--output_dir", out, "--once",
                                 "--batch_images", str(ni), "--ensemble_size",
                                 str(ENSEMBLE_SIZE), "--max_in_flight",
                                 str(in_flight), "--poll_interval", "0.05",
                                 "--seed", "0"])
        if rc != 0:
            _fail(f"serve --once --max_in_flight {in_flight} exited {rc}")
        _flash_gate(f"serve --once --max_in_flight {in_flight}", before, want)
        written = sorted(os.listdir(os.path.join(out, "depth_npy")))
        if written != [f"{n}_pred.npy" for n in names]:
            _fail(f"serve --once wrote {written}")
        for name in names:
            check_map(np.load(os.path.join(out, "depth_npy",
                                           f"{name}_pred.npy")),
                      CLI_HW, f"serve {name}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        _release()
        print(f"serve --once --max_in_flight {in_flight}: {SERVE_IMAGES} maps "
              f"in {SERVE_IMAGES // ni} batches of NI={ni} E={ENSEMBLE_SIZE} "
              f"in {timer.wall:.2f} s, of which the load {timer.seconds:.2f} "
              f"s: {timer.ms_per(SERVE_IMAGES):.1f} ms/map with the npy and "
              f"PNG writes; flash launches {want} as expected; peak device "
              f"memory {peak:.2f} GiB", flush=True)


def cli_http(root: str, depth_dir: str) -> None:
    """serve(args, stop_event) in a thread on a free loopback port: three
    concurrent npy requests (one batch), then one png request, /healthz, the
    stop event and the drain."""
    import io
    import socket
    import threading
    import urllib.request

    import numpy as np
    from PIL import Image

    from marigold_tpu_torch.cli import serve as serve_cli
    from marigold_tpu_torch.ops import flash_attention as fa

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    watch = os.path.join(root, "http_watch")
    os.makedirs(watch)
    args = serve_cli.build_parser().parse_args([
        "--checkpoint", depth_dir, "--watch_dir", watch, "--output_dir",
        os.path.join(root, "http_out"), "--batch_images", "3",
        "--ensemble_size", "1", "--batch_wait", str(HTTP_BATCH_WAIT),
        "--poll_interval", "0.1", "--http_port", str(port), "--seed", "0"])
    stop = threading.Event()
    rc = []
    server = threading.Thread(target=lambda: rc.append(serve_cli.serve(args, stop)))
    base = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(8)
    bodies = []
    for _ in range(4):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, CLI_HW + (3,), dtype=np.uint8)
                        ).save(buf, format="PNG")
        bodies.append(buf.getvalue())

    def post(body, fmt):
        req = urllib.request.Request(f"{base}/v1/predict?format={fmt}",
                                     data=body, method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read(), (time.perf_counter() - t) * 1e3

    def health():
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            return json.loads(r.read())

    before = dict(fa.launches)
    server.start()
    try:
        for _ in range(600):
            try:
                health()
                break
            except OSError:
                time.sleep(0.1)
        else:
            _fail("the HTTP server never came up")
        results = {}

        def one(i):
            results[i] = post(bodies[i], "npy")

        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        if sorted(results) != [0, 1, 2]:
            _fail(f"HTTP: answers for {sorted(results)} of 3 requests")
        for i, (body, _) in results.items():
            check_map(np.load(io.BytesIO(body)), CLI_HW, f"HTTP npy {i}")
        body, png_ms = post(bodies[3], "png")
        png = np.asarray(Image.open(io.BytesIO(body)))
        if png.shape != CLI_HW or png.dtype != np.uint16:
            _fail(f"HTTP png: {png.shape} {png.dtype}")
        for _ in range(100):  # the loop settles its stats after the reply
            h = health()
            if h["served"] == 4:
                break
            time.sleep(0.05)
        if h["served"] != 4 or h["pending"] != 0 or h["batches"] != 2:
            _fail(f"HTTP /healthz: {h}")
    finally:
        stop.set()
        server.join(timeout=300)
    if server.is_alive() or rc != [0]:
        _fail(f"HTTP server: alive {server.is_alive()}, rc {rc}")
    spec = pipe_spec(depth_dir, "depth")
    want = collections.Counter(expected_flash(spec, CLI_HW, CLI_STEPS,
                                              n_images=3, res=CLI_RES))
    want.update(expected_flash(spec, CLI_HW, CLI_STEPS, n_images=1,
                               res=CLI_RES))
    _flash_gate("HTTP", before, dict(want))
    _release()
    npy_ms = sorted(ms for _, ms in results.values())
    print(f"HTTP API (E=1, {CLI_STEPS} steps, {CLI_HW[0]}x{CLI_HW[1]}, batch_wait "
          f"{HTTP_BATCH_WAIT} s): three concurrent npy requests in one batch, "
          f"round trips {', '.join(f'{ms:.1f}' for ms in npy_ms)} ms; one png "
          f"request alone {png_ms:.1f} ms (with the batch wait); /healthz {h}; "
          f"drained, rc 0", flush=True)


def write_nyu(base: str, n: int) -> int:
    """The first n lines of the NYU test split as fabricated samples: random
    480x640 RGB and a smooth depth in mm (uint16), the same for the raw and
    the filled depth. Returns n."""
    import numpy as np
    from PIL import Image

    with open(NYU_SPLIT) as f:
        lines = [ln.split() for ln in f.readlines()[:n]]
    root = os.path.join(base, NYU_DIR)
    rng = np.random.default_rng(9)
    h, w = NYU_HW
    g = np.sin(np.linspace(0, 3, h)[:, None] + np.linspace(0, 2, w)[None, :])
    mm = ((2.0 + 1.5 * (g + 1) / 2) * 1000).astype(np.uint16)
    for rgb_rel, depth_rel, filled_rel in lines:
        for rel in (rgb_rel, depth_rel, filled_rel):
            os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, rgb_rel))
        for rel in (depth_rel, filled_rel):
            Image.fromarray(mm).save(os.path.join(root, rel))
    return len(lines)


def cli_benchmark(root: str, depth_dir: str) -> None:
    """benchmark --benchmark nyu at the protocol's own pins (E=10, 1 step,
    native resolution): --limit 1 with --parity (online launches only, the
    ensemble at reg_max_res 1024 and gauge_anchor 0; one sample shows the
    pins, and its ensemble is the reference's host BFGS), then --limit 2
    without it (shifted launches only)."""
    import numpy as np

    from marigold_tpu_torch.cli import benchmark as bench_cli
    from marigold_tpu_torch.ops import attention as attn
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.pipelines import base

    nyu = os.path.join(root, "nyu")
    write_nyu(nyu, 2)
    steps = bench_cli.DEFAULTS["depth"]["denoise_steps"]
    e = bench_cli.DEFAULTS["depth"]["ensemble_size"]
    one = expected_flash(pipe_spec(depth_dir, "depth"), NYU_HW, steps,
                         ensemble_size=e, res=max(NYU_HW))
    real = base.ensemble_depth
    seen = []

    def spy(depth, **kw):
        seen.append((kw.get("reg_max_res"), kw.get("gauge_anchor")))
        return real(depth, **kw)

    env = os.environ.get("MARIGOLD_TPU_FLASH_SOFTMAX")
    base.ensemble_depth = spy
    try:
        for parity in (True, False):
            out = os.path.join(root, f"bench_{'parity' if parity else 'serving'}")
            n = 1 if parity else 2
            want = {d: c * n for d, c in one.items()}
            seen.clear()
            before = dict(fa.launches)
            with _LoadTimer() as timer:
                rc = bench_cli.main(["--modality", "depth", "--benchmark",
                                     "nyu", "--checkpoint", depth_dir,
                                     "--base_data_dir", nyu, "--output_dir",
                                     out, "--limit", str(n)]
                                    + (["--parity"] if parity else []))
            if rc != 0:
                _fail(f"benchmark nyu (parity={parity}) exited {rc}")
            variant = "online" if parity else "shifted"
            _flash_gate(f"benchmark nyu {variant}", before, want, variant)
            pins = (1024, False) if parity else (96, True)
            if seen != [pins] * n:
                _fail(f"benchmark nyu (parity={parity}): ensemble calls {seen}, "
                      f"want {[pins] * n}")
            csv = os.path.join(out, "depth", "nyu", "eval_metric",
                               "per_sample_metrics.csv")
            with open(csv) as f:
                rows = f.read().strip().splitlines()
            values = [float(v) for row in rows[1:] for v in row.split(",")[1:]]
            if len(rows) != n + 1 or not np.isfinite(values).all():
                _fail(f"benchmark nyu (parity={parity}): CSV {rows}")
            print(f"benchmark nyu (parity={parity}): {n} samples {NYU_HW[0]}x"
                  f"{NYU_HW[1]} E={e} {steps} step, {variant} flash launches "
                  f"{want} only, ensemble (reg_max_res, gauge_anchor) {pins}, "
                  f"CSV {rows[0].split(',')[1:3]} = {rows[1].split(',')[1:3]}; "
                  f"{timer.ms_per(n):.1f} ms/sample with the eval, without "
                  f"the {timer.seconds:.2f} s load", flush=True)
            _release()
            if parity:
                attn.set_flash_softmax("shifted")
                if env is None:
                    os.environ.pop("MARIGOLD_TPU_FLASH_SOFTMAX")
                else:
                    os.environ["MARIGOLD_TPU_FLASH_SOFTMAX"] = env
    finally:
        base.ensemble_depth = real


def cli_phase(root: str, depth_dir: str) -> dict:
    """Phase 8: validate_ckpt, run, serve --once, the HTTP API and the
    benchmark harness on the full-width checkpoints written by phases 4 and
    7. Returns the flash launch counts of its run."""
    from marigold_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa.launches.clear()  # these paths' run starts here
    cli_validate(root, depth_dir)
    cli_run(root, depth_dir)
    cli_serve_once(root, depth_dir)
    cli_http(root, depth_dir)
    cli_benchmark(root, depth_dir)
    counts = dict(fa.launches)  # and ends here
    print(f"CLI phase flash launches by variant: {counts}; phase ran in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# Phase 12, `--full_precision`: the depth slice in fp32 storage through the
# entry points a user calls, run and serve --once, at 768 px E=1 4 steps on
# the full-width checkpoint (every attention of >= 1024 tokens on the fp32
# flash kernel, TF32 off for cuBLAS and cuDNN), then the same request in
# process against every attention on the plain path, under the online pin,
# and under each opt-in conv mode (the fp32 conv kernels).
F32_HW = (768, 768)
F32_STEPS = 4
# The fp32 map with the kernels against every attention on the plain path
# (fp32 logits and softmax, fp32 P @ V): both sum fp32 in other orders, and
# 4 steps of the random-weight UNet and the decoder carry the differences.
# Measured once on the card (NVIDIA H100 80GB HBM3, 700.00 W): max 5.19e-06
# shifted, 6.77e-06 online, 6.97e-06 and 4.98e-06 for the fp32 conv kernels
# against cuDNN's convs; held to 1e-4, ~14x the largest.
F32_DEPTH_TOL = 1e-4


def f32_launches() -> dict:
    """Every fp32 kernel launch so far: the flash variants by their names,
    "conv3x3" and "winograd"."""
    from marigold_tpu_torch.ops import conv as conv_ops
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.ops import winograd as wino_ops

    out = collections.Counter(fa.launches_f32)
    out.update(conv_ops.launches_f32)
    out.update(wino_ops.launches_f32)
    return dict(out)


def _f32_gate(what: str, before: dict, want: dict) -> dict:
    """The fp32 launches since `before`, held to `want`; no bf16 kernel
    launched meanwhile is checked by the caller's bf16 counters."""
    now = f32_launches()
    got = {k: n - before.get(k, 0) for k, n in now.items()
           if n != before.get(k, 0)}
    if got != want:
        _fail(f"{what}: fp32 launches {got} != {want}")
    return got


def _f32_flash_want(ckpt: str, mode: str = "shifted") -> dict:
    """fp32 flash launches of one E=1 request at F32_HW, by variant, and
    the operand split's: one before each forward, of either head width."""
    want = {f"{mode}_d{d}": n for d, n in expected_flash(
        pipe_spec(ckpt, "depth"), F32_HW, F32_STEPS, res=max(F32_HW)).items()}
    want["tf32_split"] = sum(want.values())
    return want


def full_precision_phase(root: str, depth_dir: str) -> dict:
    """Phase 12. Returns the fp32 launches of its run (the fp32 rows'
    `launches`)."""
    import numpy as np
    import torch

    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.cli import run as run_cli
    from marigold_tpu_torch.cli import serve as serve_cli
    from marigold_tpu_torch.models import layers
    from marigold_tpu_torch.ops import attention as attn
    from marigold_tpu_torch.ops import conv as conv_ops
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.ops import winograd as wino_ops

    t_phase = time.perf_counter()
    for counter in (fa.launches_f32, conv_ops.launches_f32,
                    wino_ops.launches_f32):
        counter.clear()  # the fp32 paths' run starts here
    bf16_before = sum(fa.launches.values())
    want = _f32_flash_want(depth_dir)

    src = os.path.join(root, "f32_in")
    names = _write_images(src, [F32_HW], 21)
    for what, fn in (
            ("run --full_precision", lambda out: run_cli.main([
                "--modality", "depth", "--checkpoint", depth_dir,
                "--input_rgb_dir", src, "--output_dir", out,
                "--ensemble_size", "1", "--denoise_steps", str(F32_STEPS),
                "--processing_res", str(max(F32_HW)), "--seed", "0",
                "--full_precision"])),
            ("serve --once --full_precision", lambda out: serve_cli.main([
                "--checkpoint", depth_dir, "--watch_dir", src, "--output_dir",
                out, "--once", "--batch_images", "1", "--ensemble_size", "1",
                "--denoise_steps", str(F32_STEPS), "--processing_res",
                str(max(F32_HW)), "--max_in_flight", "1", "--poll_interval",
                "0.05", "--seed", "0", "--full_precision"]))):
        out = os.path.join(root, what.split()[0] + "_f32_out")
        before = f32_launches()
        with _LoadTimer() as timer:
            rc = fn(out)
        if rc != 0:
            _fail(f"{what} exited {rc}")
        _f32_gate(what, before, want)
        depth = np.load(os.path.join(out, "depth_npy", f"{names[0]}_pred.npy"))
        check_map(depth, F32_HW, what)
        _release()
        print(f"{what}: 1 map at {F32_HW[0]}x{F32_HW[1]} E=1 {F32_STEPS} "
              f"steps in {timer.wall:.2f} s, of which the load "
              f"{timer.seconds:.2f} s: {timer.ms_per(1):.1f} ms/map with the "
              f"writes; fp32 flash launches {want} as expected; TF32 "
              f"matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
              f"{torch.backends.cudnn.allow_tf32}; depth mean "
              f"{depth.mean():.4f} std {depth.std():.4f}", flush=True)

    # in process: the same request with the kernels, on the plain path,
    # under the online pin and under each conv mode
    pipe = MarigoldDepthPipeline.from_pretrained(
        depth_dir, dtype=torch.float32, device="cuda", variant="fp16")
    img = np.random.default_rng(22).integers(0, 256, F32_HW + (3,),
                                             dtype=np.uint8)

    def request():
        return pipe(img, denoising_steps=F32_STEPS, ensemble_size=1, seed=0,
                    color_map=None).depth_np

    maps, times = {}, {}
    for mode in ("shifted", "online"):
        attn.set_flash_softmax(mode)
        runs = []
        for _ in range(2):
            before = f32_launches()
            depth, ms = _timed(request)
            _f32_gate(f"fp32 request {mode}", before, _f32_flash_want(
                depth_dir, mode))
            check_map(depth, F32_HW, f"fp32 request {mode}")
            runs.append((depth, ms))
        if not np.array_equal(runs[0][0], runs[1][0]):
            _fail(f"fp32 request {mode}: same seed gave different maps")
        maps[mode], times[mode] = runs[0][0], [ms for _, ms in runs]
    attn.set_flash_softmax("shifted")
    saved, attn.FLASH_MIN_SEQ = attn.FLASH_MIN_SEQ, 1 << 30
    try:
        plain, plain_ms = _timed(request)
    finally:
        attn.FLASH_MIN_SEQ = saved
    diffs = {m: np.abs(maps[m] - plain) for m in maps}
    print(f"fp32 768 px depth E=1: kernels (first, warm ms) shifted "
          f"{times['shifted'][0]:.1f}, {times['shifted'][1]:.1f}; online "
          f"{times['online'][0]:.1f}, {times['online'][1]:.1f}; every attention "
          f"plain {plain_ms:.1f} ms; kernels vs plain: "
          + "; ".join(f"{m} max {d.max():.3e} mean {d.mean():.3e}"
                      for m, d in diffs.items())
          + f" (tolerance {F32_DEPTH_TOL})", flush=True)
    if max(d.max() for d in diffs.values()) > F32_DEPTH_TOL:
        _fail(f"fp32 depth with kernels differs from plain by more than "
              f"{F32_DEPTH_TOL}")

    profile_request(request, what="one fp32 768x768 E=1 request on cuDNN's "
                    "convs")
    for mode, key in (("pallas", "conv3x3"), ("winograd", "winograd")):
        gated = gated_convs(pipe, F32_HW, mode)
        n_convs = gated["unet"] * F32_STEPS + gated["encode"] + gated["decode"]
        conv_want = {key: n_convs, **_f32_flash_want(depth_dir)}
        if key == "conv3x3":  # the nine-tap's split of x, a launch of its own
            conv_want["conv3x3_split"] = n_convs
        saved_impl, layers._CONV_IMPL = layers._CONV_IMPL, mode
        runs = []
        try:
            for _ in range(2):  # the first prepares the weights, then warm
                before = f32_launches()
                runs.append(_timed(request))
                _f32_gate(f"fp32 request, conv mode {mode}", before, conv_want)
            profile_request(request, what="one fp32 768x768 E=1 request "
                            f"under MARIGOLD_TPU_CONV={mode}")
        finally:
            layers._CONV_IMPL = saved_impl
        (depth, first_ms), (again, warm_ms) = runs
        check_map(depth, F32_HW, f"fp32 request, conv mode {mode}")
        if not np.array_equal(depth, again):
            _fail(f"fp32 request, conv mode {mode}: same seed gave different "
                  "maps")
        d = np.abs(depth - maps["shifted"])
        print(f"fp32 768 px depth E=1 under MARIGOLD_TPU_CONV={mode}: "
              f"first {first_ms:.1f} ms (the weights prepared), warm "
              f"{warm_ms:.1f} ms against the default (cuDNN's convs) warm "
              f"{times['shifted'][1]:.1f} ms; fp32 launches per request "
              f"{key} {n_convs}"
              + (f", conv3x3_split {n_convs}" if key == "conv3x3" else "")
              + f" as expected; against cuDNN's convs max {d.max():.3e} mean "
              f"{d.mean():.3e}", flush=True)
        if d.max() > F32_DEPTH_TOL:
            _fail(f"fp32 conv mode {mode} differs from cuDNN's by {d.max()}")
    del pipe
    _release()

    # the folded entry's fp32 path, as a caller of the public function runs it
    name, bh, n, d = F32_FOLDED_CASE
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v = (torch.randn((bh, n, d), generator=gen, device="cuda")
               for _ in range(3))
    before = f32_launches()
    out = fa.flash_attention_folded(q, k, v)
    torch.cuda.synchronize()
    _f32_gate("fp32 folded path", before, {f"folded_d{d}": 1, "tf32_split": 1})
    if not bool(torch.isfinite(out).all()):
        _fail("fp32 folded path: non-finite output")
    del q, k, v, out
    counts = f32_launches()  # and ends here
    if sum(fa.launches.values()) != bf16_before:
        _fail("fp32 phase launched bf16 flash kernels")
    print(f"fp32 phase launches by variant: {counts}; phase ran in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


# Phase 13, checkpoint loads: the full SD2 load (UNet, VAE and CLIP from
# the depth checkpoint's fp16 files, in bf16 on the card) by fastload and
# by the per-tensor path (MARIGOLD_TPU_FASTLOAD=0), every parameter held
# bit for bit between the two; the cold start of a fresh process to its
# first E=1 768 px map, with each path; and one warm E=1 768 px request
# split into its phases by utils/profiling.py's PhaseTimer.
COLD_START = """
import sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from marigold_tpu_torch import MarigoldDepthPipeline
img = np.random.default_rng(0).integers(0, 256, (768, 768, 3), dtype=np.uint8)
t1 = time.perf_counter()
pipe = MarigoldDepthPipeline.from_pretrained(sys.argv[1], dtype=torch.bfloat16,
                                             variant="fp16")
torch.cuda.synchronize()
t2 = time.perf_counter()
depth = pipe(img, denoising_steps=4, ensemble_size=1, seed=0,
             color_map=None).depth_np
t3 = time.perf_counter()
assert depth.shape == (768, 768) and np.isfinite(depth).all()
print(f"COLD {t1 - t0:.3f} {t2 - t1:.3f} {t3 - t2:.3f} {t3 - t0:.3f}")
"""


def load_phase(depth_dir: str) -> None:
    import numpy as np
    import torch

    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.utils.profiling import PhaseTimer

    parts = (("unet", W.load_unet), ("vae", W.load_vae),
             ("text_encoder", W.load_text_encoder))
    loads, times = {}, {}
    for label, flag in (("fastload", "1"), ("per-tensor", "0"),
                        ("fastload again", "1")):
        os.environ["MARIGOLD_TPU_FASTLOAD"] = flag
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mods = {sub: load(os.path.join(depth_dir, sub), torch.bfloat16,
                          "cuda", "fp16") for sub, load in parts}
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        if label != "fastload again":
            loads[label] = mods
        del mods
    os.environ.pop("MARIGOLD_TPU_FASTLOAD")
    n_params, mismatched = 0, []
    for sub, _ in parts:
        fast = loads["fastload"][sub].state_dict()
        slow = loads["per-tensor"][sub].state_dict()
        if fast.keys() != slow.keys():
            _fail(f"load {sub}: the two paths give other parameter names")
        for name, t in fast.items():
            n_params += t.numel()
            u = slow[name]
            if t.dtype != u.dtype or t.shape != u.shape or t.device != u.device \
                    or not torch.equal(t.view(torch.int16), u.view(torch.int16)):
                mismatched.append(f"{sub}.{name}")
    if mismatched:
        _fail(f"fastload and the per-tensor load differ: {mismatched[:8]}")
    del loads
    _release()
    print(f"checkpoint load, UNet + VAE + CLIP ({n_params / 1e6:.1f} M "
          f"parameters, fp16 files -> bf16 on the card, files in the page "
          f"cache): fastload {times['fastload']:.2f} s and "
          f"{times['fastload again']:.2f} s, per-tensor "
          f"{times['per-tensor']:.2f} s; every parameter bit-identical",
          flush=True)

    for flag in ("1", "0"):
        env = dict(os.environ, MARIGOLD_TPU_FASTLOAD=flag)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", COLD_START, depth_dir],
                              capture_output=True, text=True, env=env,
                              timeout=300, cwd=os.path.dirname(
                                  os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("COLD")]
        if proc.returncode != 0 or not line:
            _fail(f"cold start (MARIGOLD_TPU_FASTLOAD={flag}): rc "
                  f"{proc.returncode}\n{proc.stderr[-3000:]}")
        imp, load, first, total = map(float, line[0].split()[1:])
        print(f"cold start, MARIGOLD_TPU_FASTLOAD={flag}: a fresh process to "
              f"its first E=1 768 px map in {total:.2f} s (imports "
              f"{imp:.2f}, from_pretrained {load:.2f}, first request "
              f"{first:.2f}; {wall:.2f} s of process wall, interpreter start "
              f"included; the kernel libraries already built)", flush=True)

    pipe = MarigoldDepthPipeline.from_pretrained(
        depth_dir, dtype=torch.bfloat16, device="cuda", variant="fp16")
    img = np.random.default_rng(24).integers(0, 256, (768, 768, 3),
                                             dtype=np.uint8)
    pipe(img, denoising_steps=4, seed=0, color_map=None)  # warm
    timer = pipe.phase_timer = PhaseTimer()
    t0 = time.perf_counter()
    depth = pipe(img, denoising_steps=4, seed=0, color_map=None).depth_np
    wall = (time.perf_counter() - t0) * 1e3
    check_map(depth, (768, 768), "PhaseTimer request")
    want = {"host pre": 2, "encode": 1, "denoise": 1, "decode": 1,
            "ensemble": 1, "host post": 1}
    if dict(timer.counts) != want:
        _fail(f"PhaseTimer phases {dict(timer.counts)} != {want}")
    print(f"one warm E=1 768 px request (bf16, 4 steps) by PhaseTimer, "
          f"{wall:.1f} ms of wall with a synchronize at each edge:\n"
          f"{timer.report()}", flush=True)
    del pipe
    _release()


# Phase 14, the native tar reader: the depth recipe's loader (micro-batch
# 2, 2 forked workers, flip augmentation, the depth normalizer) over a
# fabricated NYU-layout tar of 480x640 samples, read by the native reader
# and by tarfile in turns (two runs each): samples/s of each run and the
# batches held equal.
TARIO_SAMPLES = 32
TARIO_HW = (480, 640)


def tario_phase(root: str) -> None:
    import tarfile

    import numpy as np

    from marigold_tpu_torch import data as tdata
    from marigold_tpu_torch.data import tario
    from marigold_tpu_torch.utils import depth_transform as tdt

    if tario.load_lib() is None:
        _fail("the native tar reader did not build on this machine")
    rng = np.random.default_rng(25)
    stage, lines = os.path.join(root, "tario_stage"), []
    os.makedirs(os.path.join(stage, "train"))
    for i in range(TARIO_SAMPLES):
        _png(os.path.join(stage, "train", f"rgb_{i}.png"),
             _noise_rgb(rng, *TARIO_HW))
        for kind in ("depth", "filled"):
            mm = (_smooth(rng, *TARIO_HW, 0.5, 9.0) * 1000).astype(np.uint16)
            _png(os.path.join(stage, "train", f"{kind}_{i}.png"), mm)
        lines.append(f"train/rgb_{i}.png train/depth_{i}.png train/filled_{i}.png")
    with tarfile.open(os.path.join(root, "nyu.tar"), "w") as tar:
        tar.add(os.path.join(stage, "train"), arcname="train")
    split = os.path.join(root, "tario_split.txt")
    with open(split, "w") as f:
        f.write("\n".join(lines))

    def batches(native: bool):
        saved = tario._lib, tario._build_failed
        if not native:
            tario._lib, tario._build_failed = None, True
        try:
            ds = tdata.get_dataset(
                {"name": "nyu_depth", "disp_name": "nyu", "dir": "nyu.tar",
                 "filenames": split, "eigen_valid_mask": False},
                base_data_dir=root, mode=tdata.DatasetMode.TRAIN,
                augmentation_args={"lr_flip_p": 0.5},
                depth_transform=tdt.get_depth_normalizer(
                    {"type": "scale_shift_depth", "clip": True,
                     "norm_min": -1.0, "norm_max": 1.0,
                     "min_max_quantile": 0.02}))
            ds[0]  # the parent opens the archive before the workers fork
            if ds.tar_obj.native is not native:
                _fail(f"tar reader native={ds.tar_obj.native}, want {native}")
            loader = tdata.DataLoader(ds, batch_size=2, shuffle=True, seed=3,
                                      num_workers=2)
            t0 = time.perf_counter()
            out = list(loader)
            return out, time.perf_counter() - t0
        finally:
            tario._lib, tario._build_failed = saved

    rates = {True: [], False: []}
    runs = {}
    for native in (True, False, False, True):  # in turns
        runs[native], s = batches(native)
        rates[native].append(TARIO_SAMPLES / s)
    if len(runs[True]) != len(runs[False]) or any(
            a.keys() != b.keys() or any(
                not np.array_equal(a[k], b[k], equal_nan=True)
                if isinstance(a[k], np.ndarray) else a[k] != b[k] for k in a)
            for a, b in zip(runs[True], runs[False])):
        _fail("the loader's batches differ between the native reader and "
              "tarfile")
    print(f"tar loader ({TARIO_SAMPLES} samples of {TARIO_HW[0]}x"
          f"{TARIO_HW[1]}, micro-batch 2, 2 forked workers, pool start "
          f"included; native, tarfile, tarfile, native): native reader "
          f"{', '.join(f'{r:.1f}' for r in rates[True])} samples/s, tarfile "
          f"{', '.join(f'{r:.1f}' for r in rates[False])} samples/s; batches "
          f"identical; the native library {tario.library_path()}", flush=True)


def conv_kernel_rows(results: dict, counts: dict) -> list:
    rows = []
    for kname, source, replaces in (
            ("conv3x3", "conv3x3.cu", "marigold_tpu/ops/conv.py:176"),
            ("winograd", "winograd.cu", "marigold_tpu/ops/winograd.py:251")):
        mine = {case: r for (k, case), r in results.items() if k == kname}
        timed = mine[CONV_ROW_CASE]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"marigold_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": counts.get(kname, 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine.values()),
            **{k: timed[k] for k in ROW_TIMES + ("call_ms", "rearrange_ms")},
        })
    return rows


def folded_kernel_row(results: dict, counts: dict) -> dict:
    return {
        "name": "flash_folded_d64", "route": "cuda", "source": SM90_SOURCE,
        "replaces": "marigold_tpu/ops/flash_attention.py:522",
        "launches": counts.get("folded_d64", 0),
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        **{k: results[FOLDED_ROW_CASE][k] for k in ROW_TIMES},
    }


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
                 ("flash forward", r"flash_fwd"),
                 ("tf32 operand split", r"tf32_split"),
                 ("cudnn NCHW<->NHWC copies", r"nchwToNhwc|nhwcToNchw"),
                 ("conv (fprop, dgrad, wgrad)",
                  r"fprop|dgrad|wgrad|conv|winograd|nchw_to_nhwc"),
                 ("gemm", r"gemm|cutlass|cublas|matmul"),
                 ("norm/elementwise/optimizer/other", r".")]


def expected_train_launches(core, hw: tuple, micro_steps: int,
                            remat: str = "none", f32: bool = False) -> dict:
    """Flash launches of `micro_steps` micro-steps at input size hw, from
    the shapes: each UNet self-attention with >= FLASH_MIN_SEQ tokens runs
    the lse forward, the dQ and the dK/dV kernel once (64-wide heads),
    and remat "full" runs its lse forward again when the backward
    recomputes its block ("save_heavy" keeps the forward's outputs); the
    two VAE encodes (rgb, target) under no_grad run the serving kernel of
    the mid attention (one head). The bf16 and the fp32 counters take the
    same keys; with `f32` the fp32 counter's "tf32_split" too, one before
    each forward (the VAE's and every lse launch) and one per backward."""
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
        for key, runs in (("lse", 2 if remat == "full" else 1),
                          ("bwd_dq", 1), ("bwd_dkv", 1)):
            want[f"{key}_d{d}"] = (want.get(f"{key}_d{d}", 0)
                                   + runs * n * micro_steps)
    if f32:
        want["tf32_split"] = sum(n for key, n in want.items()
                                 if key.startswith(("shifted", "lse",
                                                    "bwd_dq")))
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


def train_config(max_iter: int):
    """The depth recipe's training config (module comment above), remat
    "none", no periodic saves, validation or visualization."""
    from marigold_tpu_torch.config import Config

    return Config(
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
        max_epoch=10000, max_iter=max_iter,
        validation=Config(denoising_steps=1, ensemble_size=1, processing_res=0,
                          match_input_res=False, resample_method="bilinear",
                          main_val_metric="abs_relative_difference",
                          main_val_metric_goal="minimize", init_seed=2024),
        eval=Config(alignment="least_square", align_max_res=None,
                    eval_metrics=["abs_relative_difference", "delta1_acc"]),
    )


def train_phase(root: str) -> dict:
    """The depth fine-tuning path at full SD2 width, on the SD2 checkpoint
    at `root`. Returns the flash launch counts of its main-path run."""
    import gc
    import os
    import tempfile

    import numpy as np
    import torch

    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.ops import attention as attn
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.train.train_step import make_loss_and_grad
    from marigold_tpu_torch.train.trainer import MarigoldDepthTrainer

    gc.collect()
    torch.cuda.empty_cache()
    seed = 0
    failures = []
    tmp = tempfile.TemporaryDirectory()
    pipe = MarigoldDepthPipeline.from_pretrained(
        root, dtype=torch.bfloat16, device="cuda", variant="fp16")
    cfg = train_config(TRAIN_ITERS)
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
    level-0 training shape; each backward kernel's plain and library time
    is that of the whole backward (dQ, dK and dV together)."""
    rows = []
    for name, replaces, key, whats in (
            ("flash_lse_d64", "marigold_tpu/ops/flash_attention.py:638",
             "lse_d64", ("out",)),
            ("flash_bwd_dq_d64", "marigold_tpu/ops/flash_attention.py:800",
             "bwd_dq_d64", ("dq",)),
            ("flash_bwd_dkv_d64", "marigold_tpu/ops/flash_attention.py:832",
             "bwd_dkv_d64", ("dk", "dv"))):
        timed = results[("train_l0", whats[0])]
        source = ("flash_fwd_sm90.cu" if key.startswith("lse")
                  else "flash_bwd_sm90.cu")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"marigold_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": counts.get(key, 0),
            "max_abs_err": max(r["max_abs_err"] for (case, what), r in results.items()
                               if what in whats and case != "autograd_fn"),
            **{k: timed[k] for k in ROW_TIMES},
        })
    return rows


# The fp32 fine-tuning phase (after phase 10): MarigoldDepthTrainer on the
# SD2 checkpoint of the training phases loaded in fp32, so that the step
# runs with compute_dtype fp32 on the fp32 lse forward, dQ and dK/dV
# kernels (and the fp32 d=512 serving kernel in the VAE encodes), TF32 off
# for cuBLAS and cuDNN as `--full_precision` sets it. One effective
# iteration of F32_TRAIN_ACCUM micro-steps of [2, 3, 480, 640] under each
# remat mode, by trainer.train(), fp32 launches exact per mode.
F32_TRAIN_ACCUM = 2
# One micro-step with the kernels against the same draws with every
# attention on the plain path, both fp32 with TF32 off: they differ by fp32
# summation order only (the kernels' outputs lie within a few 1e-7 of the
# plain versions' largest, phase 3), carried through one UNet forward and
# backward. Loss: relative difference; each gradient tensor: relative L2
# distance, the tensor's norm floored at 1e-30.
F32_TRAIN_LOSS_TOL = 1e-5
F32_TRAIN_GRAD_TOL = 1e-3


def f32_train_phase(root: str) -> dict:
    """fp32 fine-tuning on the SD2 checkpoint at `root`. Returns the fp32
    launches of its trainer runs by variant."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.ops import attention as attn
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.train.train_step import make_loss_and_grad
    from marigold_tpu_torch.train.trainer import MarigoldDepthTrainer

    t_phase = time.perf_counter()
    _free()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    tmp = tempfile.TemporaryDirectory()
    try:
        pipe = MarigoldDepthPipeline.from_pretrained(
            root, dtype=torch.float32, device="cuda", variant="fp16")
        batches = _train_batches(3, F32_TRAIN_ACCUM)
        out_dir = os.path.join(tmp.name, "run")
        trainer = MarigoldDepthTrainer(
            train_config(len(REMAT_MODES)), pipe, batches,
            os.path.join(out_dir, "ckpt"), os.path.join(out_dir, "eval"),
            os.path.join(out_dir, "vis"), accumulation_steps=F32_TRAIN_ACCUM)
        torch.cuda.synchronize()
        print(f"fp32 trainer: compute dtype {trainer.core.dtype}, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
              "(the fp32 pipeline, masters and Adam state)", flush=True)
        bf16_before = sum(fa.launches.values())
        fa.launches_f32.clear()  # the fp32 fine-tuning path's run starts here
        for i, mode in enumerate(REMAT_MODES):
            trainer.cfg.trainer.remat = mode
            trainer._build_train_step()
            trainer.max_iter = i + 1  # one more effective iteration
            step, micro_ms = trainer.train_step, []

            def timed_step(*args, step=step, micro_ms=micro_ms):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                micro_ms.append((time.perf_counter() - t) * 1e3)
                return out

            trainer.train_step = timed_step
            want = expected_train_launches(trainer.core, TRAIN_HW,
                                           F32_TRAIN_ACCUM, mode, f32=True)
            before = dict(fa.launches_f32)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: n - before.get(k, 0) for k, n in fa.launches_f32.items()
                   if n != before.get(k, 0)}
            loss = trainer.metrics_log[-1]["loss"]
            print(f"fp32 remat {mode}: trainer.train() 1 iteration of "
                  f"{F32_TRAIN_ACCUM} micro-steps [{TRAIN_BATCH}, 3, "
                  f"{TRAIN_HW[0]}, {TRAIN_HW[1]}] in {wall:.1f} s (Adam "
                  f"apply and the fp32 backup save included); ms per "
                  f"micro-step {', '.join(f'{m:.1f}' for m in micro_ms)}; peak "
                  f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                  f" GiB; loss {loss:.6f}; fp32 flash launches {got}, expected "
                  f"{want}", flush=True)
            if got != want:
                failures.append(f"remat {mode}: fp32 launches {got} != {want}")
            if not np.isfinite(loss) or trainer.effective_iter != i + 1:
                failures.append(f"remat {mode}: loss {loss}, effective_iter "
                                f"{trainer.effective_iter}")
            shutil.rmtree(os.path.join(out_dir, "ckpt",
                                       trainer._get_backup_ckpt_name()))
        counts = dict(fa.launches_f32)  # ... and ends here
        if sum(fa.launches.values()) != bf16_before:
            failures.append("the fp32 trainer launched bf16 flash kernels")
        profile_request(
            lambda: trainer.train_step(trainer.state, trainer.text_embed,
                                       trainer._assemble_batch(batches[1]),
                                       trainer._step_generator()),
            TRAIN_CLASSES, f"one fp32 micro-step [{TRAIN_BATCH}, 3, "
            f"{TRAIN_HW[0]}, {TRAIN_HW[1]}] (remat save_heavy)")

        # one micro-step's loss and gradients, kernels against plain
        # attention, on the same draws
        core = trainer.core
        trainer.cfg.trainer.remat = "none"
        loss_and_grad = make_loss_and_grad(core.unet, core.vae, core.schedule,
                                           **trainer._step_kwargs())
        batch = trainer._assemble_batch(batches[0])
        gen = torch.Generator(device="cuda").manual_seed(4)
        ds = core.vae_cfg.downscale_factor
        t_draw = torch.randint(0, core.schedule.num_train_timesteps,
                               (TRAIN_BATCH,), generator=gen, device="cuda")
        noise = torch.randn((TRAIN_BATCH, core.vae_cfg.latent_channels,
                             TRAIN_HW[0] // ds, TRAIN_HW[1] // ds),
                            generator=gen, device="cuda")
        loss_k, grads_k = loss_and_grad(trainer.state.params, trainer.text_embed,
                                        batch, timesteps=t_draw, noise=noise)
        saved, attn.FLASH_MIN_SEQ = attn.FLASH_MIN_SEQ, 1 << 30
        try:
            loss_p, grads_p = loss_and_grad(trainer.state.params,
                                            trainer.text_embed, batch,
                                            timesteps=t_draw, noise=noise)
        finally:
            attn.FLASH_MIN_SEQ = saved
        rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        rel = {n: float((grads_k[n] - g).norm() / g.norm().clamp(min=1e-30))
               for n, g in grads_p.items()}
        worst = max(rel, key=rel.get)
        num = sum(((grads_k[n] - grads_p[n]) ** 2).sum() for n in grads_p)
        den = sum((grads_p[n] ** 2).sum() for n in grads_p)
        print(f"fp32 micro-step, kernels vs plain attention: loss "
              f"{float(loss_k):.8f} vs {float(loss_p):.8f} (rel {rel_loss:.2e}, "
              f"tol {F32_TRAIN_LOSS_TOL}); gradient rel L2 whole "
              f"{float(num.sqrt() / den.sqrt()):.2e}, per tensor worst "
              f"{rel[worst]:.2e} at {worst}, median "
              f"{sorted(rel.values())[len(rel) // 2]:.2e} (tol "
              f"{F32_TRAIN_GRAD_TOL}, {len(rel)} tensors)", flush=True)
        if not rel_loss <= F32_TRAIN_LOSS_TOL:
            failures.append(f"fp32 micro-step loss rel diff {rel_loss}")
        bad = [n for n, r in rel.items() if not r <= F32_TRAIN_GRAD_TOL]
        if bad:
            failures.append(f"fp32 gradients off plain: {bad[:8]}")
        del grads_k, grads_p, loss_and_grad, trainer, pipe
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        _free()
        tmp.cleanup()
    print(f"fp32 fine-tuning phase launches by variant: {counts}; phase ran in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if failures:
        _fail(f"fp32 fine-tuning phase: {failures}")
    return counts


# The training entry point, phase 11: `python -m marigold_tpu_torch.cli.train`
# (its setup and run, in this process so that the launch counters can be
# read) on the four shipped recipes, each through a small overlay config
# whose base_config is the recipe. The overlay replaces only the split-list
# paths (lists of the first lines of the shipped ones; where the shipped
# list is missing, lines of the same dataset's val/vis list), max_iter, the
# periods and, for normals and IID, effective_batch_size (to bound the
# phase's time); depth runs its recipe's loader as shipped (micro-batch 2,
# effective batch 32, 2 forked workers). The datasets are fabricated in
# each dataset's own layout, member names and native geometry.
CLI_TRAIN_RECIPES = [
    # (run, recipe, effective batch override, saved UNet in/out channels)
    ("depth", "config/train_marigold_depth.yaml", None, (8, 4)),
    ("normals", "config/train_marigold_normals.yaml", 4, (8, 4)),
    ("iid_appearance", "config/train_marigold_iid_appearance.yaml", 4, (12, 8)),
    ("iid_lighting", "config/train_marigold_iid_lighting.yaml", 4, (16, 12)),
]
CLI_TRAIN_ITERS = 2
CLI_TRAIN_SAMPLES = {"train": 8, "val": 4, "vis": 4}
# hypersim depth train: 12 samples, so that with vkitti's 8 an epoch is 10
# batches of 2 and the resume lands mid-epoch (32 micro-steps in 2 iterations)
CLI_TRAIN_HYPERSIM_DEPTH = 12
CLI_PROFILE_STEPS = 3
REMAT_MODES = ("none", "full", "save_heavy")
REMAT_BATCH_REPEATS = (1, 4)
REMAT_GATED_REPEATS = 4  # [8, 3, 480, 640]: activations outweigh the state
REMAT_FULL_MARGIN = 1.0  # GiB
# IID train split lists the repository does not ship: lines of the same
# dataset's vis / val list stand in (the shipped configs name these files)
CLI_TRAIN_STANDIN_SPLITS = {
    "data_split/interiorverse_iid/interiorverse_train_scenes_85.txt":
        ("data_split/interiorverse_iid/interiorverse_vis_scenes_85.txt", 4),
    "data_split/hypersim_iid/hypersim_train_filtered.txt":
        ("data_split/hypersim_iid/hypersim_val.txt", 4),
}


def _png(path: str, arr, **kw) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, compress_level=1, **kw)


def _noise_rgb(rng, h: int, w: int):
    import numpy as np

    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _uniform(rng, lo: float, hi: float, h: int, w: int):
    import numpy as np

    return rng.uniform(lo, hi, (h, w, 3)).astype(np.float32)


def _smooth(rng, h: int, w: int, lo: float, hi: float):
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    g = np.sin(xx / rng.uniform(60, 200) + rng.uniform(0, 6)) * np.cos(
        yy / rng.uniform(60, 200))
    return lo + (hi - lo) * (g + 1) / 2


def _unit_normals(rng, h: int, w: int):
    import numpy as np

    n = rng.standard_normal((h, w, 3)).astype(np.float32)
    n[..., 2] = np.abs(n[..., 2]) + 0.3
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def _npy(path: str, arr) -> None:
    import numpy as np

    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, arr)


def _sample_writers(rng):
    """Per dataset name: a writer of one split line's files under a root,
    in the dataset's layout and native geometry."""
    import json

    import numpy as np

    from marigold_tpu_torch.data.exr import write_exr

    def hypersim_depth(root, rgb, depth, *_):  # 768x1024, depth in mm
        _png(os.path.join(root, rgb), _noise_rgb(rng, 768, 1024))
        _png(os.path.join(root, depth),
             (_smooth(rng, 768, 1024, 0.5, 20.0) * 1000).astype(np.uint16))

    def vkitti_depth(root, rgb, depth):  # 375x1242 jpg, depth in cm
        _png(os.path.join(root, rgb), _noise_rgb(rng, 375, 1242), quality=90)
        _png(os.path.join(root, depth),
             (_smooth(rng, 375, 1242, 3.0, 79.0) * 100).astype(np.uint16))

    def nyu_depth(root, rgb, depth, filled):  # 480x640, mm
        _png(os.path.join(root, rgb), _noise_rgb(rng, 480, 640))
        mm = (_smooth(rng, 480, 640, 1.0, 9.0) * 1000).astype(np.uint16)
        _png(os.path.join(root, depth), mm)
        _png(os.path.join(root, filled), mm)

    def kitti_depth(root, rgb, depth, _focal):  # 375x1242, 1/256 m, sparse
        _png(os.path.join(root, rgb), _noise_rgb(rng, 375, 1242))
        d = (_smooth(rng, 375, 1242, 5.0, 70.0) * 256).astype(np.uint16)
        d[::3] = 0
        _png(os.path.join(root, depth), d)

    def normals(h, w):
        def write(root, rgb, normal):
            _png(os.path.join(root, rgb), _noise_rgb(rng, h, w))
            _npy(os.path.join(root, normal), _unit_normals(rng, h, w))
        return write

    def interiorverse_iid(root, im, albedo, material, mask):  # 480x640 EXR
        for rel in (im, albedo, material, mask):
            os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        write_exr(os.path.join(root, im), _uniform(rng, 0, 2, 480, 640))
        write_exr(os.path.join(root, albedo), _uniform(rng, 0, 1, 480, 640))
        write_exr(os.path.join(root, material), _uniform(rng, 0, 1, 480, 640))
        write_exr(os.path.join(root, mask), _uniform(rng, 1, 1, 480, 640))

    def hypersim_iid(root, rgb, albedo, shading, residual, stats):  # 768x1024
        _png(os.path.join(root, rgb), _noise_rgb(rng, 768, 1024))
        for rel, lo, hi in ((albedo, 0.05, 1.0), (shading, 0.0, 3.0),
                            (residual, 0.0, 0.5)):
            _npy(os.path.join(root, rel), _uniform(rng, lo, hi, 768, 1024))
        with open(os.path.join(root, stats), "w") as f:
            json.dump({}, f)

    return {
        "hypersim_depth": hypersim_depth, "vkitti_depth": vkitti_depth,
        "nyu_depth": nyu_depth, "kitti_depth": kitti_depth,
        "hypersim_normals": normals(768, 1024),
        "interiorverse_normals": normals(480, 640),
        "sintel_normals": normals(436, 1024),
        "interiorverse_iid": interiorverse_iid, "hypersim_iid": hypersim_iid,
    }


def build_train_data(base: str, lists: str, recipes: list, seed: int) -> dict:
    """Fabricates every dataset the recipes' train, val and vis splits name
    under `base` (tar archives where the config names a .tar) and writes
    their split lists under `lists`. -> {shipped list path: written path}."""
    import tarfile

    import numpy as np

    from marigold_tpu_torch.config import recursive_load_config

    written: dict = {}  # shipped list -> written list
    members: dict = {}  # dataset dir -> {line: dataset name}
    for _, recipe, _, _ in recipes:
        ds_cfg = recursive_load_config(recipe).dataset
        for split in ("train", "val", "vis"):
            entries = ds_cfg.get(split) or []
            if split == "train":
                entries = entries["dataset_list"]
            for e in entries:
                shipped = e["filenames"]
                n = CLI_TRAIN_SAMPLES[split]
                if e["name"] == "hypersim_depth" and split == "train":
                    n = CLI_TRAIN_HYPERSIM_DEPTH
                src, skip = CLI_TRAIN_STANDIN_SPLITS.get(shipped, (shipped, 0))
                with open(src) as f:
                    lines = [ln.split() for ln in f if ln.strip()][skip:skip + n]
                if e["name"] == "kitti_depth":
                    lines = [ln for ln in lines if ln[1] != "None"]
                out = os.path.join(lists, shipped.replace("/", "__"))
                with open(out, "w") as f:
                    f.write("\n".join(" ".join(ln) for ln in lines) + "\n")
                written[shipped] = out
                for ln in lines:
                    files = [t for t in ln if t != "(val)"]
                    members.setdefault(e["dir"], {})[tuple(files)] = e["name"]
    t0 = time.perf_counter()
    n_files = sum(len(files) for samples in members.values() for files in samples)
    # PNG, EXR and npy writes release the GIL: write the samples in threads,
    # each with its own generator (the draws differ from a serial write's)
    jobs = [(os.path.join(base, d + ".staging" if d.endswith(".tar") else d),
             files, name) for d, samples in members.items()
            for files, name in samples.items()]
    seeds = np.random.SeedSequence(seed).spawn(len(jobs))
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job, s: _sample_writers(np.random.default_rng(s))[
            job[2]](job[0], *job[1]), jobs, seeds))
    for d in members:
        is_tar = d.endswith(".tar")
        root = os.path.join(base, d + ".staging" if is_tar else d)
        if is_tar:
            with tarfile.open(os.path.join(base, d), "w") as tar:
                for dp, _, fs in os.walk(root):
                    for fn in fs:
                        full = os.path.join(dp, fn)
                        tar.add(full, arcname=os.path.relpath(full, root))
            import shutil

            shutil.rmtree(root)
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(base) for f in fs)
    print(f"train data: {n_files} files of {sum(map(len, members.values()))} "
          f"samples in {len(members)} dataset dirs ({size / 2**30:.2f} GiB) "
          f"fabricated in {time.perf_counter() - t0:.1f} s", flush=True)
    return written


def write_overlay(folder: str, run: str, recipe: str, lists: dict,
                  eff_bs) -> str:
    """An overlay config on top of the shipped recipe (printed replacement
    by replacement), named as the recipe so that the run dir is too."""
    import copy

    import yaml

    from marigold_tpu_torch.config import recursive_load_config

    shipped = recursive_load_config(recipe)
    dataset = copy.deepcopy(shipped.dataset.to_dict())
    for split in ("train", "val", "vis"):
        entries = dataset.get(split) or []
        if split == "train":
            entries = entries["dataset_list"]
        for e in entries:
            print(f"  {run} overlay: dataset.{split}[{e['disp_name']}].filenames "
                  f"{e['filenames']} -> {lists[e['filenames']]}", flush=True)
            e["filenames"] = lists[e["filenames"]]
    periods = {"save_period": CLI_TRAIN_ITERS, "backup_period": 0,
               "validation_period": CLI_TRAIN_ITERS,
               "visualization_period": CLI_TRAIN_ITERS}
    overlay = {"base_config": [os.path.abspath(recipe)], "dataset": dataset,
               "max_iter": CLI_TRAIN_ITERS, "trainer": periods}
    print(f"  {run} overlay: max_iter {shipped.max_iter} -> {CLI_TRAIN_ITERS}",
          flush=True)
    for k, v in periods.items():
        print(f"  {run} overlay: trainer.{k} {shipped.trainer[k]} -> {v}", flush=True)
    if eff_bs is not None:
        overlay["dataloader"] = {"effective_batch_size": eff_bs}
        print(f"  {run} overlay: dataloader.effective_batch_size "
              f"{shipped.dataloader.effective_batch_size} -> {eff_bs}", flush=True)
    path = os.path.join(folder, run, os.path.basename(recipe))
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        yaml.safe_dump(overlay, f)
    return path


def _sample_hw(ds, i: int = 0) -> tuple:
    s = ds[i]
    return tuple((s["rgb_norm"] if "rgb_norm" in s else s["rgb"]).shape[:2])


def train_stream_hw(trainer, seed: int, n: int, skip: int = 0) -> list:
    """The input size of each of the next n micro-batches the trainer's
    loader yields: a replica of its MixedBatchSampler (same datasets, seed
    and probabilities), epoch by epoch as the loader draws them, the first
    `skip` batches skipped (the loader's resume position)."""
    import bisect
    import random

    from marigold_tpu_torch.data import MixedBatchSampler

    s = trainer.train_loader.batch_sampler
    prob = trainer.cfg.dataset.train.get("prob_ls")
    rep = MixedBatchSampler(s.src_dataset_ls, s.batch_size, shuffle=s.shuffle,
                            prob=list(prob) if prob else None,
                            generator=random.Random(seed))
    cum = trainer.train_loader.dataset.cumulative_sizes
    hw = [_sample_hw(ds) for ds in s.src_dataset_ls]
    out = []
    while len(out) < n:
        for b in list(rep)[skip:]:
            out.append(hw[bisect.bisect_right(cum, b[0])])
        skip = 0
    return out[:n]


def expected_cli_train(trainer, hws: list, val_passes: int) -> dict:
    """Exact flash launches of a CLI run: per micro-step at its input size,
    the UNet self-attentions' lse forward, dQ and dK/dV kernels and the VAE
    encodes of the RGB and of each 3-channel target group under no_grad
    (the serving d=512 kernel); per validation/visualization pass, each
    sample's request (expected_flash) in the shifted mode."""
    core = trainer.core
    encodes = 1 + (len(trainer.model.target_names) if trainer.modality == "iid"
                   else 1)
    want = collections.Counter()
    for hw in hws:
        for key, n in expected_train_launches(core, hw, 1).items():
            # expected_train_launches counts the depth trainer's 2 encodes
            want[key] += n // 2 * encodes if key.startswith("shifted") else n
    v = trainer.cfg.validation
    loaders = list(trainer.val_loaders) + list(trainer.vis_loaders)
    for loader in loaders:
        for i in range(len(loader.dataset)):
            hw = _sample_hw(loader.dataset, i)
            res = int(v.processing_res) or max(hw)
            for d, n in expected_flash(trainer.model, hw, int(v.denoising_steps),
                                       res=res).items():
                want[f"shifted_d{d}"] += n * val_passes
    return {k: int(n) for k, n in want.items() if n}


def _instrument(trainer) -> dict:
    """Host-clock times of the trainer's micro-steps (each ended by a
    synchronize), its optimizer applies' end times and its validation
    passes."""
    import torch

    times = {"micro": [], "apply_end": [], "validate": []}
    step, apply, validate = trainer.train_step, trainer.apply_step, trainer.validate

    def micro(*a, **k):
        t = time.perf_counter()
        m = step(*a, **k)
        torch.cuda.synchronize()
        times["micro"].append((time.perf_counter() - t) * 1e3)
        return m

    def applied(*a, **k):
        out = apply(*a, **k)
        torch.cuda.synchronize()
        times["apply_end"].append(time.perf_counter())
        return out

    def validated():
        t = time.perf_counter()
        validate()
        times["validate"].append((time.perf_counter() - t) * 1e3)

    trainer.train_step, trainer.apply_step, trainer.validate = micro, applied, validated
    return times


def _cli_train_run(argv: list, failures: list, what: str, skip: int = 0):
    """setup + run of cli/train.py (its main), the flash counts set to 0
    just before and read just after. -> (trainer, counts, times, want)."""
    import logging

    import torch

    from marigold_tpu_torch.cli import train as cli_train
    from marigold_tpu_torch.ops import flash_attention as fa

    handlers = logging.getLogger().handlers[:]
    try:
        t0 = time.perf_counter()
        trainer, t_end = cli_train.setup(argv)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        times = _instrument(trainer)
        start_iter = trainer.effective_iter
        n_micro = (int(trainer.cfg.max_iter) - start_iter) * trainer.accumulation_steps
        hws = train_stream_hw(trainer, int(trainer.cfg.dataloader.seed), n_micro,
                              skip=trainer.n_batch_in_epoch)
        val_passes = sum(1 for it in range(start_iter + 1, int(trainer.cfg.max_iter) + 1)
                         if trainer.val_period and it % trainer.val_period == 0)
        want = expected_cli_train(trainer, hws, val_passes)
        fa.launches.clear()  # this run of the training CLI starts here
        t0 = time.perf_counter()
        rc = cli_train.run(trainer, t_end)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(fa.launches)  # ... and ends here
    finally:
        for h in logging.getLogger().handlers[len(handlers):]:
            h.close()
        logging.getLogger().handlers[:] = handlers
    print(f"{what}: setup {setup_s:.1f} s, run {wall:.1f} s, rc {rc}; "
          f"{n_micro} micro-steps of {sorted(collections.Counter(hws).items())}; "
          f"flash launches {counts}, expected from the shapes {want}", flush=True)
    if rc != 0:
        failures.append(f"{what}: rc {rc}")
    if counts != want:
        failures.append(f"{what}: flash launches {counts} != {want}")
    return trainer, counts, times, hws


def _check_run_dir(run_dir: str, iters: list, channels: tuple, failures: list,
                   what: str) -> None:
    import json

    need = ["config.yaml", "code_snapshot.tar",
            "checkpoint/latest/unet/config.json", "checkpoint/latest/trainer.json",
            "checkpoint/latest/opt_state.safetensors"]
    need += [f"checkpoint/iter_{i:06d}/unet/config.json" for i in iters]
    missing = [p for p in need if not os.path.exists(os.path.join(run_dir, p))]
    with open(os.path.join(run_dir, "checkpoint/latest/unet/config.json")) as f:
        ucfg = json.load(f)
    got = (ucfg["in_channels"], ucfg["out_channels"])
    print(f"{what}: run dir files present: {not missing}; saved UNet in/out "
          f"channels {got} (want {channels})", flush=True)
    if missing:
        failures.append(f"{what}: missing {missing}")
    if got != channels:
        failures.append(f"{what}: saved UNet channels {got} != {channels}")


def _check_metrics(trainer, failures: list, what: str) -> None:
    import math

    import numpy as np

    train = [e for e in trainer.metrics_log if "loss" in e]
    val = [e for e in trainer.metrics_log if "val" in e]
    for e in train:
        print(f"  {what} iter {e['iter']}: loss {e['loss']:.6f} grad_norm "
              f"{e['grad_norm']:.6f} lr {e['lr']:.6e} n_batch_in_epoch "
              f"{e['n_batch_in_epoch']}", flush=True)
        if not (np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])):
            failures.append(f"{what}: non-finite loss at iter {e['iter']}")
    for e in val:
        vals = {k: v for k, v in e.items() if k not in ("iter", "val")}
        print(f"  {what} validation at iter {e['iter']} on {e['val']}: "
              f"{ {k: round(float(v), 6) for k, v in vals.items()} }", flush=True)
        if not vals or not all(math.isfinite(float(v)) for v in vals.values()):
            failures.append(f"{what}: validation metrics {e}")
    want_val = (len(trainer.val_loaders) if trainer.val_period and any(
        e["iter"] % trainer.val_period == 0 for e in train) else 0)
    if len(val) != want_val:
        failures.append(f"{what}: {len(val)} validation results, want {want_val}")


def _free() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def cli_train_measures(trainer, failures: list, micro_ms: float) -> None:
    """After the depth runs, on the same trainer: the loader's samples/s
    with its 2 workers, a profiled window of micro-steps fed by the loader,
    one micro-step under each remat mode (peak memory, flash launches), and
    one Adafactor update against Adam's."""
    import torch

    from marigold_tpu_torch.data import DataLoader
    from marigold_tpu_torch.ops import flash_attention as fa
    from marigold_tpu_torch.train import train_step as ts

    loader = trainer.train_loader
    fresh = DataLoader(loader.dataset, batch_sampler=loader.batch_sampler,
                       num_workers=loader.num_workers, seed=1)
    n_batches, n_samples = 0, 0
    t0 = time.perf_counter()
    for batch in fresh:
        n_batches += 1
        n_samples += len(batch["rgb_norm"])
        if n_batches == len(loader):
            break
    load_s = time.perf_counter() - t0
    print(f"loader, {loader.num_workers} forked workers: {n_samples} samples in "
          f"{n_batches} batches, {load_s:.2f} s ({n_samples / load_s:.1f} samples/s, "
          f"pool start included), against the depth run's micro-steps: "
          f"{1e3 * loader.batch_sampler.batch_size / micro_ms:.1f} samples/s "
          f"({micro_ms:.1f} ms per micro-step of {loader.batch_sampler.batch_size})",
          flush=True)

    it = iter(fresh)

    def window():
        for _ in range(CLI_PROFILE_STEPS):
            trainer.train_step(trainer.state, trainer.text_embed,
                               trainer._assemble_batch(next(it)),
                               trainer._step_generator())

    profile_request(window, TRAIN_CLASSES,
                    f"{CLI_PROFILE_STEPS} CLI micro-steps fed by the loader")
    trainer.state.acc, trainer.state.mini_step = None, 0

    batch = trainer._assemble_batch(next(it))
    del it
    core = trainer.core
    kwargs = trainer._step_kwargs()
    static = torch.cuda.memory_allocated() / 2**30
    # the peak after the VAE encodes (the UNet forward and backward and the
    # gradients): the encodes' own transients are reset away
    encode = core.vae.encode_mean_scaled
    after_encode = {}

    def encode_then_reset(x):
        out = encode(x)
        torch.cuda.synchronize()
        after_encode["peak"] = max(after_encode.get("peak", 0.0),
                                   torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        return out

    core.vae.encode_mean_scaled = encode_then_reset
    # the recipe's micro-batch, and 4x it (the JAX recipes' fastest
    # single-chip micro-batch) where activations outweigh the gradients
    for reps in REMAT_BATCH_REPEATS:
        big = {k: torch.cat([v] * reps) for k, v in batch.items()}
        results = {}
        for mode in REMAT_MODES:
            loss_and_grad = ts.make_loss_and_grad(core.unet, core.vae, core.schedule,
                                                  **dict(kwargs, remat=mode))
            grads = None
            _free()
            after_encode.clear()
            torch.cuda.reset_peak_memory_stats()
            fa.launches.clear()
            t0 = time.perf_counter()
            loss, grads = loss_and_grad(
                trainer.state.params, trainer.text_embed, big,
                torch.Generator(device=trainer.device).manual_seed(7))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            unet_peak = torch.cuda.max_memory_allocated() / 2**30
            results[mode] = (float(loss), dict(fa.launches),
                             max(unet_peak, after_encode["peak"]), unet_peak, ms)
        for mode, (loss, counts, peak, unet_peak, ms) in results.items():
            print(f"remat {mode}: one micro-step [{', '.join(map(str, big['rgb_norm'].shape))}] "
                  f"{ms:.1f} ms, peak device memory {peak:.2f} GiB, after the VAE "
                  f"encodes {unet_peak:.2f} GiB ({static:.2f} GiB of parameters and "
                  f"Adam state before the step), loss {loss:.6f}, flash launches "
                  f"{counts}", flush=True)
        base, full, heavy = (results[m][1] for m in ("none", "full", "save_heavy"))
        if heavy.get("lse_d64") != base.get("lse_d64") or not base.get("lse_d64") \
                or full.get("lse_d64") != 2 * base.get("lse_d64", 0):
            failures.append(f"remat lse launches: none {base}, full {full}, "
                            f"save_heavy {heavy}")
        for key in ("bwd_dq_d64", "bwd_dkv_d64"):
            if not (base.get(key) == full.get(key) == heavy.get(key)):
                failures.append(f"remat {key}: {base}, {full}, {heavy}")
        for mode in ("full", "save_heavy"):
            rel = abs(results[mode][0] - results["none"][0]) / abs(results["none"][0])
            if not rel <= 1e-3:
                failures.append(f"remat {mode} loss rel diff {rel}")
        if reps == REMAT_GATED_REPEATS:
            # block-by-block remat lowers the whole step's peak: full by at
            # least REMAT_FULL_MARGIN GiB, save_heavy below none
            none, full, heavy = (results[m][2] for m in REMAT_MODES)
            print(f"remat peaks at micro-batch {len(big['rgb_norm'])}: none "
                  f"{none:.2f}, full {full:.2f} ({none - full:.2f} GiB less), "
                  f"save_heavy {heavy:.2f} ({none - heavy:.2f} GiB less)",
                  flush=True)
            if not (full <= none - REMAT_FULL_MARGIN and heavy < none):
                failures.append(f"remat peaks none {none:.2f}, full {full:.2f}, "
                                f"save_heavy {heavy:.2f} GiB")
        del big
    core.vae.encode_mean_scaled = encode

    # one Adafactor update against one Adam update, on the same gradients
    adam = trainer.optimizer
    ada = ts.make_optimizer(float(trainer.cfg.lr), trainer.lr_schedule_fn, 1,
                            name="adafactor")
    ada_state = ada.init(trainer.state.params)
    ms = {}
    for name, opt, st in (("Adam", adam, trainer.state), ("Adafactor", ada, ada_state)):
        ms[name] = []
        for _ in range(2):
            st.acc = {n: g.float().clone() for n, g in grads.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.apply(st)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    def state_bytes(opt, st):  # the update rule's state, accumulator excluded
        return sum(t.numel() * t.element_size() for g in opt.groups
                   for t in getattr(st, g).values())

    print(f"optimizer apply ms (host clock around a synchronize, 2 calls): Adam "
          f"{ms['Adam'][0]:.1f}, {ms['Adam'][1]:.1f}; Adafactor {ms['Adafactor'][0]:.1f}, "
          f"{ms['Adafactor'][1]:.1f}; state bytes Adam {state_bytes(adam, trainer.state)}, "
          f"Adafactor {state_bytes(ada, ada_state)} ({len(ada_state.v_row)} of "
          f"{len(trainer.state.params)} tensors factored)", flush=True)
    bad = [n for n, p in trainer.state.params.items() if not torch.isfinite(p).all()]
    if bad:
        failures.append(f"non-finite parameters after the updates: {bad[:8]}")
    del grads, ada_state


def train_cli_phase(base_ckpt: str) -> dict:
    """The training CLI on the four shipped recipes at full SD2 width, from
    the SD2 checkpoint `base_ckpt`/stable-diffusion-2. Returns the flash
    launch counts of its runs."""
    import shutil
    import tempfile

    import yaml

    os.environ.setdefault("WANDB_MODE", "disabled")
    _free()
    failures: list = []
    total = collections.Counter()
    tmp = tempfile.TemporaryDirectory()
    base_data = os.path.join(tmp.name, "data")
    lists_dir = os.path.join(tmp.name, "splits")
    os.makedirs(lists_dir)
    lists = build_train_data(base_data, lists_dir, CLI_TRAIN_RECIPES, seed=0)
    out = os.path.join(tmp.name, "runs")
    common = ["--base_ckpt_dir", base_ckpt, "--base_data_dir", base_data,
              "--output_dir", out, "--no_wandb", "--device", "cuda"]
    for run, recipe, eff_bs, channels in CLI_TRAIN_RECIPES:
        cfg_path = write_overlay(os.path.join(tmp.name, "configs"), run, recipe,
                                 lists, eff_bs)
        run_dir = os.path.join(out, os.path.splitext(os.path.basename(recipe))[0])
        trainer, counts, times, hws = _cli_train_run(
            ["--config", cfg_path] + common, failures, f"cli.train {run}")
        total.update(counts)
        _check_run_dir(run_dir, [CLI_TRAIN_ITERS], channels, failures, run)
        _check_metrics(trainer, failures, run)
        if run == "depth":
            micro = times["micro"]
            k = trainer.accumulation_steps
            ends = times["apply_end"]
            warm = sorted(micro[k:])
            print(f"depth CLI run (the recipe's loader, {trainer.train_loader.num_workers} "
                  f"workers): ms per micro-step {micro[0]:.1f} first, median of the "
                  f"{len(micro) - k} of iteration 2 {warm[len(warm) // 2]:.1f} (min "
                  f"{warm[0]:.1f}, max {warm[-1]:.1f}); ms per effective iteration of "
                  f"{k} micro-steps, iteration 2 (apply end to apply end, loader "
                  f"waits included) {(ends[1] - ends[0]) * 1e3:.1f}; "
                  f"validation pass ms {times['validate']}", flush=True)
            with open(os.path.join(run_dir, "checkpoint/latest/trainer.json")) as f:
                saved = json.load(f)
            state_before = (saved["effective_iter"], saved["epoch"],
                            saved["n_batch_in_epoch"], saved["step"])
            # the lr logged at iteration 3: the schedule's next value
            lr_next = trainer.optimizer.learning_rate(CLI_TRAIN_ITERS + 1)
            del trainer
            _free()
            # resume from checkpoint/latest for one more iteration
            cfg_file = os.path.join(run_dir, "config.yaml")
            with open(cfg_file) as f:
                cfg = yaml.safe_load(f)
            cfg["max_iter"] = CLI_TRAIN_ITERS + 1
            with open(cfg_file, "w") as f:
                yaml.safe_dump(cfg, f)
            print(f"  depth resume: {cfg_file} max_iter {CLI_TRAIN_ITERS} -> "
                  f"{CLI_TRAIN_ITERS + 1}; checkpoint/latest at (iter, epoch, batch "
                  f"in epoch, micro-steps) {state_before}", flush=True)
            trainer, counts, times, _ = _cli_train_run(
                ["--resume_run", os.path.join(run_dir, "checkpoint", "latest")]
                + common, failures, "cli.train depth --resume_run")
            total.update(counts)
            first = [e for e in trainer.metrics_log if "loss" in e]
            resumed_at = (first[0]["iter"] if first else None,
                          first[0]["lr"] if first else None)
            want_batches = state_before[2] + k
            print(f"  depth resume: continued at iteration {resumed_at[0]}, logged "
                  f"lr {resumed_at[1]} (the schedule's at iteration "
                  f"{CLI_TRAIN_ITERS + 1}: {lr_next}); updates {trainer.state.count}, "
                  f"micro-steps {trainer.state.step}, epoch {trainer.epoch}, "
                  f"batch in epoch {trainer.n_batch_in_epoch}", flush=True)
            n_epoch = len(trainer.train_loader)
            if resumed_at != (CLI_TRAIN_ITERS + 1, lr_next) or \
                    trainer.state.count != CLI_TRAIN_ITERS + 1 or \
                    trainer.state.step != state_before[3] + k or \
                    (trainer.epoch - state_before[1]) * n_epoch + \
                    trainer.n_batch_in_epoch != want_batches:
                failures.append(f"resume: at {resumed_at}, step {trainer.state.step}, "
                                f"epoch {trainer.epoch}, batch {trainer.n_batch_in_epoch}")
            _check_run_dir(run_dir, [CLI_TRAIN_ITERS, CLI_TRAIN_ITERS + 1], channels,
                           failures, "depth resumed")
            cli_train_measures(trainer, failures, warm[len(warm) // 2])
        del trainer
        _free()
        shutil.rmtree(run_dir)
    tmp.cleanup()
    print(f"training CLI phase flash launches: {dict(total)}", flush=True)
    if failures:
        _fail(f"training CLI phase: {failures}")
    return dict(total)


SERVE_CLASSES = [("flash", r"flash_fwd"),
                 ("tf32 operand split", r"tf32_split"),
                 ("cudnn NCHW<->NHWC copies", r"nchwToNhwc|nhwcToNchw"),
                 ("conv", r"fprop|dgrad|conv|winograd|nchw_to_nhwc|nchw_split"),
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
    main(sys.argv[1:])
