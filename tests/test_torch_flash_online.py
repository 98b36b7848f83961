"""The bf16 online-softmax forward as the port's kernel computes it.

The online instantiations of `csrc/flash_fwd_sm90.cu` (the exact forward,
the training forward with the lse, the folded entry) keep each row's
running max stale until a tile's max grows past it by more than kRescale2
(base-2 units): their exponentials are taken against the stale max, and
only a warp in which some row grew past it moves its rows' max, rescales
l and O and takes the tile's exponentials again. They run only on the card
(`chip_smoke.py` holds them to their plain versions there); here an
emulation tiled as the kernel tiles (the source's BK keys, bf16 operands
and bf16 P, fp32 sums, base-2 units, τ read from the source, the vote over
each warp's 16 query rows) is held to the TPU package's online forward
(`_flash_dt_impl(softmax="online")`) and its lse (`_flash_dt_impl_lse`),
both in Pallas interpret mode, and to the port's plain version, on a
random input, a rising-logit one (the max moves in most tiles), a ragged
nk and a row whose max comes in its last tile.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marigold_tpu.ops import flash_attention as jfa
from marigold_tpu_torch.ops import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "flash_fwd_sm90.cu").read_text()
LOG2E = np.float32(np.log2(np.e))
LN2 = np.float32(np.log(2.0))
WARP_ROWS = 16  # query rows of one consumer warp: 16w + lane/4, and + 8
# chip_smoke.py's phase 3 gates, which hold the kernel on the card: the
# output max|err| <= OUT_TOL_REL * max|ref| + OUT_TOL_ABS (the emulation
# rounds P to bf16, the TPU kernel on fp32 inputs does not), the lse (fp32,
# sums in another order) LSE_TOL_REL * max|lse| + LSE_TOL_ABS
OUT_TOL_REL, OUT_TOL_ABS = 1e-2, 1e-3
LSE_TOL_REL, LSE_TOL_ABS = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rescale2() -> float:
    """The source's kRescale2: the growth of a row's max, in base 2, past
    which the online kernel moves it."""
    m = re.search(r"^constexpr float kRescale2 = ([\d.]+)f;", SOURCE, re.M)
    return float(m.group(1))


def _cue() -> float:
    """The source's kRescaleCue: half of 2^kRescale2."""
    assert re.search(r"^constexpr float kRescaleCue = 0\.5f \* "
                     r"\(1 << \(int\)kRescale2\);", SOURCE, re.M)
    return 0.5 * 2.0 ** int(_rescale2())


def _tile(d: int) -> int:
    """csrc/flash_fwd_sm90.cu's keys per K tile at head width d."""
    assert "static constexpr int BK = D > 128 ? 64 : 128;" in SOURCE
    return 64 if d > 128 else 128


def test_source_rescale_threshold():
    """τ = 8 in base 2: an exponential against the stale max is at most
    256, which bf16 P and the fp32 sums hold."""
    assert _rescale2() == 8.0 and _cue() == 128.0
    assert "__any_sync(0xffffffffu, t0 > m0 + kRescale2 || t1 > m1 + kRescale2)" \
        in SOURCE


def emulated_online(q, k, v, tau):
    """(out [nq, d] bf16, lse [nq] fp32, moves: the tiles in which some warp
    moved its max, warp_moves: the warp-tiles that moved it) of one head as the online kernel computes it on bf16
    q [nq, d], k and v [nk, d]: tiles of BK keys (zeros past nk, their
    columns masked to -1e30); S in fp32; tile 0 takes its row max first,
    every later tile its exponentials against the running max m (base 2),
    and where a row of a warp grew past m + tau, that warp's rows take
    m = max(m, tile max), l and O times exp2(m_old - m_new) and the tile's
    exponentials again; P rounded to bf16 meets V; out = O / max(l, 1e-30)
    in bf16, lse = m ln 2 + log(max(l, 1e-30)). Asserts that no
    exponential passes 2^tau and that the kernel's cue (a thread's
    exponentials of a row, its 2 of every 8 columns, summing past half of
    2^tau) is up in every warp whose max moves."""
    nq, d = q.shape
    nk = k.shape[0]
    bk = _tile(d)
    rows = -(-nq // WARP_ROWS) * WARP_ROWS  # the kernel's rows past nq: q = 0
    qf = torch.zeros(rows, d)
    qf[:nq] = q.float()
    scale_log2 = np.float32(np.float32(1.0 / np.sqrt(d)) * LOG2E)
    m = torch.full((rows,), -1e30)
    l = torch.zeros(rows)
    o = torch.zeros(rows, d)
    moves, warp_moves = [], 0
    for it, k0 in enumerate(range(0, nk, bk)):
        kt = torch.zeros(bk, d)
        vt = torch.zeros(bk, d)
        kt[:min(bk, nk - k0)] = k[k0:k0 + bk].float()
        vt[:min(bk, nk - k0)] = v[k0:k0 + bk].float()
        s = qf @ kt.T
        s[:, max(0, nk - k0):] = -1e30
        t = s.amax(-1) * scale_log2
        if it == 0:
            m = torch.maximum(m, t)
        else:
            x = (s.double() * float(scale_log2) - m.double()[:, None]).float()
            quads = torch.exp2(x).reshape(rows, bk // 8, 4, 2).sum((1, 3))
            cued = (quads > 0.5 * 2.0 ** tau).reshape(-1, WARP_ROWS * 4)
            grew = (t > m + tau).reshape(-1, WARP_ROWS).any(-1)
            assert not (grew & ~cued.any(-1)).any()
            moved = grew.repeat_interleave(WARP_ROWS)
            if grew.any():
                moves.append(it)
            warp_moves += int(grew.sum())
            m_new = torch.where(moved, torch.maximum(m, t), m)
            a = torch.exp2(m - m_new)
            l, o, m = l * a, o * a[:, None], m_new
        # fma(s, scale log2(e), -m), rounded once
        x = (s.double() * float(scale_log2) - m.double()[:, None]).float()
        e = torch.exp2(x)
        assert e.max() <= 2.0 ** tau * (1 + 1e-6)
        l = l + e.sum(-1)
        o = o + e.to(torch.bfloat16).float() @ vt
    out = (o / l.clamp(min=1e-30)[:, None]).to(torch.bfloat16)[:nq]
    lse = (m * LN2 + torch.log(l.clamp(min=1e-30)))[:nq]
    return out, lse, moves, warp_moves


def _inputs(kind, d, rng):
    """bf16 (q [nq, d], k, v [nk, d]) of one case."""
    nq, nk = {"random": (150, 640), "rising": (100, 1024),
              "ragged": (77, 1000), "last_tile_max": (40, 700)}[kind]
    q, k, v = (rng.standard_normal((n, d)).astype(np.float32)
               for n in (nq, nk, nk))
    if kind == "rising":
        # scaled logits rising 0.12 a key (22 in base 2 over 128 keys, 11
        # over 64): each row's max grows past the threshold in every tile
        q += 1.0
        k += (np.arange(nk, dtype=np.float32) * (0.12 / np.sqrt(d)))[:, None]
    if kind == "last_tile_max":
        # row 3's largest logit, 30 above the rest, at key nk - 5: in the
        # last (ragged) tile
        k[nk - 5] = q[3] * (30.0 * np.sqrt(d) / (q[3] @ q[3]))
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))


def _jax(q, k, v):
    """The TPU package's online forward and its lse on the same (bf16)
    values in fp32, [1, d, n] layout, in Pallas interpret mode."""
    qt, kt, vt = (jnp.asarray(x.float().numpy().T[None]) for x in (q, k, v))
    out = jfa._flash_dt_impl(qt, kt, vt, block_q=128, block_k=128,
                             interpret=True, softmax="online")
    _, lse = jfa._flash_dt_impl_lse(qt, kt, vt, 128, 128, True)
    return np.asarray(out)[0].T, np.asarray(lse)[0]


@pytest.mark.parametrize("kind", ["random", "rising", "ragged",
                                  "last_tile_max"])
@pytest.mark.parametrize("d", [40, 64, 160])
def test_emulated_online_meets_the_jax_kernels(d, kind):
    """The emulated kernel against the TPU online forward and lse (and the
    port's plain version, which the card's checks hold the kernel to), at
    phase 3's gates; the max moves in the tiles the case is built for."""
    rng = np.random.default_rng(d * 7 + len(kind))
    q, k, v = _inputs(kind, d, rng)
    tau = _rescale2()
    out, lse, moves, _ = emulated_online(q, k, v, tau)
    n_tiles = -(-k.shape[0] // _tile(d))
    if kind == "rising":
        assert len(moves) == n_tiles - 1
    elif kind == "last_tile_max":
        assert moves[-1:] == [n_tiles - 1]
    else:  # the max settles in the first tiles
        assert len(moves) <= 2
    ref_out, ref_lse = _jax(q, k, v)
    plain_out, plain_lse = fa.flash_attention_lse_plain(q[None], k[None],
                                                        v[None], 1)
    for ref, ref_l in ((ref_out, ref_lse),
                       (plain_out[0].float().numpy(), plain_lse[0].numpy())):
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= OUT_TOL_REL * np.abs(ref).max() + OUT_TOL_ABS, err
        err_l = np.abs(lse.numpy() - ref_l).max()
        assert err_l <= LSE_TOL_REL * np.abs(ref_l).max() + LSE_TOL_ABS, err_l


@pytest.mark.parametrize("d", [40, 64])
def test_no_threshold_is_the_running_max(d):
    """With τ = 0 the emulation moves the max in every tile where it grows:
    FlashAttention-2's online softmax, which reaches the same output and
    lse; τ = 8 changes the rounding only."""
    rng = np.random.default_rng(d)
    q, k, v = _inputs("random", d, rng)
    out0, lse0, moves0, _ = emulated_online(q, k, v, 0.0)
    out8, lse8, moves8, _ = emulated_online(q, k, v, _rescale2())
    assert len(moves0) > len(moves8)
    ref = out0.float().abs().max().item()
    assert (out8.float() - out0.float()).abs().max().item() \
        <= OUT_TOL_REL * ref + OUT_TOL_ABS
    assert (lse8 - lse0).abs().max().item() \
        <= LSE_TOL_REL * lse0.abs().max().item() + LSE_TOL_ABS


@pytest.mark.parametrize("kind", ["random", "rising", "ragged",
                                  "last_tile_max"])
@pytest.mark.parametrize("d", [40, 160])
def test_traffic_share_counts_the_emulated_moves(d, kind):
    """flash_fwd_variants.warp_tile_moves, which reads the share of
    warp-tiles whose max moves on the main path's captured inputs, counts
    the moves of the emulated kernel, here on two heads side by side."""
    import flash_fwd_variants as fv

    rng = np.random.default_rng(d * 7 + len(kind))
    q, k, v = _inputs(kind, d, rng)
    q2, k2, v2 = _inputs(kind, d, np.random.default_rng(d))
    tau = _rescale2()
    assert fv.rescale2() == tau
    moved = sum(emulated_online(*x, tau)[3] for x in ((q, k, v),
                                                       (q2, k2, v2)))
    got = fv.warp_tile_moves(torch.cat([q, q2], -1)[None],
                             torch.cat([k, k2], -1)[None], 2, tau)
    n_tiles = -(-k.shape[0] // _tile(d))
    assert got == (moved, 2 * -(-q.shape[0] // WARP_ROWS) * (n_tiles - 1))


@pytest.mark.parametrize("name", ["base", "tau0", "stages3", "nopingpong",
                                  "nopingpong3", "probe_nomax",
                                  "probe_norescale"])
def test_variant_edits_apply(name):
    """Each variant of flash_fwd_variants.py is the source with its edits,
    each matched as often as it must be; base is the source itself."""
    import flash_fwd_variants as fv

    text = fv.variant_source(name)
    assert (text == SOURCE) == (name == "base")
