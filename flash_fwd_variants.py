"""The bf16 flash forward's online mode measured against variants of
itself: the library `flash_attention` (`marigold_tpu_torch/csrc/
flash_attention.cu`, `flash_fwd_sm90.cu`, `flash_fwd_d512_sm90.cu`) built
as it is ("base") and from copies of `flash_fwd_sm90.cu` with a part of
its text edited (VARIANTS), timed side by side on an NVIDIA GPU at the
shapes of PERF.md's rows 3, 4 and 7 (the online forward, the training
forward with the lse, the folded entry).

    python3 flash_fwd_variants.py [--check] [VARIANT ...]
    python3 flash_fwd_variants.py --traffic PARENT_DIR

Variants: tau0 (kRescale2 = 0: the running max of FlashAttention-2, the
design before the conditional rescale, bit for bit); stages3 (3 K/V
stages for the online mode at d <= 64, not 4); nopingpong, nopingpong3
(the online mode's two consumers start their products together, over 4
or 3 stages). The probe_* variants take a part of the online softmax
out: the row max and its vote after the first tile, or O's rescale. What
is left of the time says what that part costs. Their outputs are wrong
by design where that part acts ("within_gate" false, another digest: the
rising cases).

Each variant runs in a process of its own with a time limit, so that a
hang loses only it, and the variants run in turns (each twice: A B B A):
per case, the output (and the lse) against the plain version within
chip_smoke.py's phase 3 gates and a digest of their bits (a schedule
changes no sum: those variants print base's digest), then (without
--check) torch.profiler's device ms per call of the forward kernel. The
"rising" cases put keys whose logits rise along the sequence
(chip_smoke.rising_logits).

--traffic builds this tree's library and the one of the tree at
PARENT_DIR (an unpacked copy of another commit with the same C
interface), captures q, k and v of every online forward call of head
width <= 160 in one depth request at the benchmark's NYU pins (480x640,
E=10, 1 step, online softmax as `--parity` sets it; chip_smoke.py's
full-width checkpoint, random weights from seed 0), prints per call
shape the share of warp-tiles whose running max moves under this build's
rule (`warp_tile_moves`), then both libraries' device ms over all the
captured calls and on the rising and random inputs of rows 3 (d = 64
and 40), in turns (this, parent, parent, this).

Prints one JSON line per variant, run and case. Builds into
marigold_tpu_torch/_build/variants_fwd/ (git-ignored).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "marigold_tpu_torch", "csrc")
OUT_DIR = os.path.join(HERE, "marigold_tpu_torch", "_build", "variants_fwd")
LOG2E = 1.4426950408889634

SOURCE = "flash_fwd_sm90.cu"
# edits of SOURCE's text: (pattern, replacement, the matches it must have)
NO_TURNS = (r"named_barrier(_arrive)?\(TURN_BAR",
            r"if (!ONLINE) named_barrier\1(TURN_BAR", 5)
STAGES3 = (r"STAGES = ONLINE && D <= 64 \? 4 : 3;", "STAGES = 3;", 1)
# name -> its edits
VARIANTS = {
    "base": [],
    # the running max moved wherever it grows (FlashAttention-2's online
    # softmax): the design before the conditional rescale, and its bits
    "tau0": [(r"kRescale2 = 8\.0f;", "kRescale2 = 0.0f;", 1)],
    "stages3": [STAGES3],
    "nopingpong": [NO_TURNS],
    "nopingpong3": [NO_TURNS, STAGES3],
    # probes: the online softmax with a part taken out (outputs wrong by
    # design where that part acts)
    "probe_nomax": [(r"exps\(pn\);\n(\s+)if \(!__any_sync",
                     r"exps(pn);\n\1return false;\n\1if (!__any_sync", 1)],
    "probe_norescale": [(r"if \(moved\) \{", "if (false) {", 1)],
}
# (name, mode, B, N, C, heads, rising): rows 3 (online), 4 (lse) and 7
# (folded: [B, N, D], one head)
CASES = [
    ("online_d64", "online", 1, 9216, 320, 5, False),
    ("online_d40", "online", 1, 9216, 320, 8, False),
    ("online_d64_b10", "online", 10, 9216, 320, 5, False),
    ("online_d80", "online", 1, 2304, 640, 8, False),
    ("online_d160", "online", 1, 1024, 1280, 8, False),
    ("lse_d64", "lse", 2, 4800, 320, 5, False),
    ("lse_d40", "lse", 2, 4800, 320, 8, False),
    ("folded_d64", "folded", 50, 9216, 64, 1, False),
    ("folded_d40", "folded", 8, 9216, 40, 1, False),
    ("online_d64_rising", "online", 1, 9216, 320, 5, True),
    ("online_d40_rising", "online", 1, 9216, 320, 8, True),
]
TIME_LIMIT_S = 300
PROFILE_CALLS = 20


def variant_source(name: str) -> str:
    """SOURCE's text with variant `name`'s edits; raises where an edit
    does not match as often as it must (the source moved on)."""
    with open(os.path.join(CSRC, SOURCE)) as f:
        text = f.read()
    for pattern, repl, count in VARIANTS[name]:
        text, n = re.subn(pattern, repl, text)
        if n != count:
            raise ValueError(f"variant {name}: {pattern!r} matched {n} "
                             f"times, not {count}")
    return text


def _sources(name: str, parent: str = None) -> tuple:
    """(csrc directory, {source: text}) that variant `name`'s library (or
    "parent"'s, from the tree at `parent`) is built from."""
    from marigold_tpu_torch.ops import flash_attention as fa

    csrc = (os.path.join(parent, "marigold_tpu_torch", "csrc")
            if name == "parent" else CSRC)
    texts = {}
    for src in fa.SOURCES:
        with open(os.path.join(csrc, src)) as f:
            texts[src] = f.read()
    if name != "parent":
        texts[SOURCE] = variant_source(name)
    return csrc, texts


def library(name: str, parent: str = None) -> str:
    """Variant `name`'s library (or "parent"'s), keyed on its sources and
    their headers."""
    csrc, texts = _sources(name, parent)
    h = hashlib.sha256()
    for src in sorted(os.listdir(csrc)):
        if src.endswith(".cuh"):
            with open(os.path.join(csrc, src), "rb") as f:
                h.update(f.read())
    for src in sorted(texts):
        h.update(texts[src].encode())
    return os.path.join(OUT_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: list, parent: str = None) -> list:
    """nvcc of each variant's library (and of the library of the tree at
    `parent` as "parent"), all started together; returns the built ones
    (spills and ptxas's wgmma serialization notes printed)."""
    from marigold_tpu_torch.ops import cuda_build

    procs, built = {}, []
    for name in names + (["parent"] if parent else []):
        so = library(name, parent)
        if os.path.exists(so):
            built.append(name)  # built from these sources by an earlier run
            continue
        csrc, texts = _sources(name, parent)
        src_dir = os.path.join(OUT_DIR, name)
        os.makedirs(src_dir, exist_ok=True)
        for src, text in texts.items():
            with open(os.path.join(src_dir, src), "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", csrc,
             "-shared", "-o", so,
             *(os.path.join(src_dir, src) for src in texts)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out = proc.communicate()[0]
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", out)))
        notes = sorted(set(re.findall(r"C75\d\d", out)))
        print(f"variant {name}: nvcc rc {proc.returncode}, spill stores "
              f"{spills}, wgmma notes {notes}", flush=True)
        if proc.returncode == 0:
            built.append(name)
        else:
            print(out[-2000:], flush=True)
    return built


def digest(tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run(name: str, check: bool) -> None:
    """Every case on variant `name`'s library (already built): its gates,
    its digest and (unless `check`) the forward's device ms per call."""
    import torch

    import chip_smoke
    from marigold_tpu_torch.ops import cuda_build
    from marigold_tpu_torch.ops import flash_attention as fa

    # the library the wrappers load: this variant's
    cuda_build._LIBS["flash_attention"] = ctypes.CDLL(library(name))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(26)
    for case, mode, b, n, c, h, rising in CASES:
        q, k, v = (torch.randn((b, n, c), generator=gen, device="cuda")
                   for _ in range(3))
        if rising:
            q, k = chip_smoke.rising_logits(q, k, h)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        call = {"online": lambda: fa.flash_attention(q, k, v, h, "online"),
                "lse": lambda: fa.flash_attention_lse(q, k, v, h),
                "folded": lambda: fa.flash_attention_folded(q, k, v)}[mode]
        got = call()
        got = got if mode == "lse" else (got,)
        refs, rows = [], max(1, chip_smoke.PLAIN_CHUNK // h)
        for i in range(0, b, rows):  # [rows, h, N, N] fp32 logits at a time
            sl = slice(i, i + rows)
            refs.append(fa.flash_attention_lse_plain(q[sl], k[sl], v[sl], h)
                        if mode == "lse" else
                        (fa.flash_attention_plain(q[sl], k[sl], v[sl], h,
                                                  "online"),))
        refs = [torch.cat(parts) for parts in zip(*refs)]
        torch.cuda.synchronize()
        gates = [(chip_smoke.TOL_REL, chip_smoke.TOL_ABS),
                 (chip_smoke.LSE_TOL_REL, chip_smoke.LSE_TOL_ABS)]
        errs = [(x.float() - r.float()).abs().max().item()
                for x, r in zip(got, refs)]
        ok = all(bool(torch.isfinite(x.float()).all())
                 and e <= rel * r.float().abs().max().item() + tol_abs
                 for x, r, e, (rel, tol_abs) in zip(got, refs, errs, gates))
        line = {"variant": name, "case": case, "within_gate": ok,
                "max_abs_err": errs, "digest": digest(got)}
        if not check:
            _, split = chip_smoke.kernel_profile(call, PROFILE_CALLS,
                                                 "flash_fwd")
            line["device_ms"] = round(sum(
                t for key, t in split.items() if "flash_fwd" in key), 5)
        print(json.dumps(line), flush=True)
        del q, k, v, got, refs
        torch.cuda.empty_cache()


def rescale2() -> float:
    """SOURCE's kRescale2, the growth of a row's max (base 2) past which
    the online kernel moves it."""
    with open(os.path.join(CSRC, SOURCE)) as f:
        m = re.search(r"^constexpr float kRescale2 = ([\d.]+)f;", f.read(),
                      re.M)
    return float(m.group(1))


def warp_tile_moves(q, k, heads: int, tau: float) -> tuple:
    """(warp-tiles in which the online kernel moves the running max, the
    warp-tiles after each row's first tile) of the forward on q [B, nq, C]
    and k [B, nk, C] (heads of C // heads lanes), by the kernel's rule: the
    logits in fp32 and base 2, tiles of BK keys (64 at d > 128, else 128;
    the ragged last one masked), warps of 16 query rows (rows past nq are
    zeros and never move); tile 0 sets each row's max, and in a later tile
    a warp moves where some row's tile max passes its running max by more
    than tau, each of its rows then taking the larger."""
    import torch

    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // heads
    bk = 64 if d > 128 else 128
    n_tiles, rows = -(-nk // bk), -(-nq // 16) * 16
    scale_log2 = float(torch.tensor(d ** -0.5, dtype=torch.float32)) * LOG2E
    t = torch.zeros(b * heads, rows, n_tiles, device=q.device)
    for i in range(b * heads):
        qh = q[i // heads, :, (i % heads) * d:(i % heads + 1) * d].float()
        kh = k[i // heads, :, (i % heads) * d:(i % heads + 1) * d].float()
        for r0 in range(0, nq, 2048):  # [2048, nk] fp32 logits at a time
            s = torch.nn.functional.pad(qh[r0:r0 + 2048] @ kh.T,
                                        (0, n_tiles * bk - nk),
                                        value=float("-inf"))
            t[i, r0:r0 + s.shape[0]] = \
                s.view(s.shape[0], n_tiles, bk).amax(-1) * scale_log2
    m = t[:, :, 0]
    moved = torch.zeros((), dtype=torch.int64, device=q.device)
    for j in range(1, n_tiles):
        grew = (t[:, :, j] > m + tau).view(b * heads, -1, 16).any(-1)
        moved += grew.sum()
        m = torch.where(grew.repeat_interleave(16, -1),
                        torch.maximum(m, t[:, :, j]), m)
    return int(moved), b * heads * (rows // 16) * (n_tiles - 1)


def traffic(parent: str) -> None:
    """--traffic (module docstring): the main path's own inputs."""
    import numpy as np
    import torch

    import chip_smoke
    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.ops import attention as attn
    from marigold_tpu_torch.ops import cuda_build
    from marigold_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {name: ctypes.CDLL(library(name, parent))
            for name in ("base", "parent")}

    def use(name):
        cuda_build._LIBS["flash_attention"] = libs[name]
        fa._library.cache_clear()

    use("base")
    real, calls = fa.flash_attention, []

    def spy(q, k, v, num_heads, softmax="shifted"):
        if softmax == "online" and q.shape[-1] // num_heads <= 160:
            calls.append((q.clone(), k.clone(), v.clone(), num_heads))
        return real(q, k, v, num_heads, softmax)

    root = os.path.join(OUT_DIR, "ckpt")
    chip_smoke.write_checkpoint(root, 0)
    pipe = MarigoldDepthPipeline.from_pretrained(
        root, dtype=torch.bfloat16, device="cuda", variant="fp16")
    attn.set_flash_softmax("online")
    fa.flash_attention = spy
    try:
        image = np.random.default_rng(0).integers(
            0, 256, chip_smoke.NYU_HW + (3,), dtype=np.uint8)
        pipe(image, denoising_steps=1, ensemble_size=10, processing_res=0,
             seed=1234, color_map=None)
    finally:
        fa.flash_attention = real
    del pipe
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(26)
    cases = {}
    for name, h in (("d64", 5), ("d40", 8)):
        for rising in (False, True):
            q, k, v = (torch.randn((1, 9216, 320), generator=gen,
                                   device="cuda") for _ in range(3))
            if rising:
                q, k = chip_smoke.rising_logits(q, k, h)
            cases[f"{'rising' if rising else 'random'}_{name}"] = (
                [tuple(x.to(torch.bfloat16) for x in (q, k, v)) + (h,)])
    cases["captured"] = calls

    tau = rescale2()
    shares = {}
    for case, inputs in cases.items():
        for q, k, v, h in inputs:
            key = (case, tuple(q.shape), h)
            n, moved, total = shares.get(key, (0, 0, 0))
            got = warp_tile_moves(q, k, h, tau)
            shares[key] = (n + 1, moved + got[0], total + got[1])
    for (case, shape, h), (n, moved, total) in shares.items():
        print(json.dumps({"case": case, "shape": list(shape), "heads": h,
                          "calls": n, "warp_tiles_moved": moved,
                          "warp_tiles": total,
                          "share": round(moved / total, 6)}), flush=True)

    for turn in ("base", "parent", "parent", "base"):
        use(turn)
        for case, inputs in cases.items():
            def call(inputs=inputs):
                for q, k, v, h in inputs:
                    fa.flash_attention(q, k, v, h, "online")
            n, split = chip_smoke.kernel_profile(call, PROFILE_CALLS,
                                                 "flash_fwd")
            print(json.dumps({"build": turn, "case": case,
                              "launches_per_call": n,
                              "device_ms": round(sum(
                                  t for key, t in split.items()
                                  if "flash_fwd" in key), 5)}), flush=True)


def main(argv: list) -> None:
    if argv[:1] == ["--run"]:
        run(argv[1], argv[2:] == ["--check"])
        return
    if argv[:1] == ["--traffic"] and len(argv) == 2:
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=False)
        if sorted(build(["base"], parent=argv[1])) != ["base", "parent"]:
            raise SystemExit(1)
        traffic(argv[1])
        return
    check = argv[:1] == ["--check"]
    names = argv[1:] if check else argv
    names = names or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    built = build(names)
    turns = built if check else built + built[::-1]
    failed = False
    for name in turns:
        try:
            r = subprocess.run(
                [sys.executable, __file__, "--run", name,
                 *(["--check"] if check else [])],
                capture_output=True, text=True, timeout=TIME_LIMIT_S, cwd=HERE)
            print(r.stdout.strip(), flush=True)
            if r.returncode:
                failed = True
                print(f"variant {name}: rc {r.returncode}: "
                      f"{r.stderr.strip().splitlines()[-3:]}", flush=True)
        except subprocess.TimeoutExpired:
            failed = True
            print(f"variant {name}: no end within {TIME_LIMIT_S} s", flush=True)
    if failed or len(built) != len(names):
        raise SystemExit(1)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main(sys.argv[1:])
