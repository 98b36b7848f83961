"""The 3xTF32 arithmetic of the port's fp32 tensor-core kernels on the CPU.

The fp32 flash kernels (`csrc/flash_fwd_d64_f32_sm90.cu` and
`csrc/flash_fwd_d512_f32_sm90.cu`, the forwards; `csrc/flash_bwd_dq_f32_sm90.cu`
and `csrc/flash_bwd_dkv_f32_sm90.cu`, the backward) split each fp32 operand
into two tf32 parts, hi + lo, by `csrc/tf32_split.cu` or in registers, and
sum lo.hi + hi.lo + hi.hi on the tensor cores. They run only on the card
(`chip_smoke.py`, `tests/test_torch_cuda.py`); here the plain emulation in
`ops/flash_attention.py` is held to its definition: the split's
reconstruction, the 3xTF32 product against float64 at the fp32 gate that
`chip_smoke.py` holds the kernels to (and one tf32 product missing it),
the split's transposed layout and the A-fragment permutation it encodes,
and emulated forwards, dQ (with its delta and padded statistics) and dK/dV
against the TPU kernels (Pallas interpret mode) and the port's plain
versions, dQ and dK/dV also at the SD1.x head widths 40, 80 and 160; the
emulations walk the keys and query rows in the sources' tiles.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marigold_tpu.ops import flash_attention as jfa
from marigold_tpu_torch.ops import flash_attention as fa

# chip_smoke.py's fp32 gate: max|err| <= F32_TOL_REL * max|ref| + F32_TOL_ABS
F32_TOL_REL, F32_TOL_ABS = 1e-4, 1e-6
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
# The 64-wide kernels' key tile: one fresh tile product per KEY_TILE keys
KEY_TILE = 64
LOG2E = np.float32(np.log2(np.e))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _gate(err, ref):
    return err <= F32_TOL_REL * ref.abs().max().item() + F32_TOL_ABS


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4, 1e30])
def test_split_reconstructs_x(scale):
    x = _randn(1, 4096, scale=scale)
    hi, lo = fa.split_tf32_plain(x)
    for part in (hi, lo):  # tf32 values: the low 13 mantissa bits are zero
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -20
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()


def test_rna_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # a tf32 ulp at 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4, 0.0, float("inf"), float("-inf")])
    hi, lo = fa.split_tf32_plain(x)
    assert hi.tolist()[:5] == [1 + one_ulp, -(1 + one_ulp), 1.0,
                               1 + one_ulp, 0.0]
    assert hi.tolist()[5:] == [float("inf"), float("-inf")]
    assert lo.tolist()[:5] == [-one_ulp / 2, one_ulp / 2, one_ulp / 4,
                               -one_ulp / 4, 0.0]
    nan_hi, _ = fa.split_tf32_plain(torch.tensor([float("nan")]))
    assert torch.isnan(nan_hi).all()


@pytest.mark.parametrize("k", [64, 512])
def test_tf32x3_product_meets_the_fp32_gate(k):
    """lo.hi + hi.lo + hi.hi carries fp32 operands to the gate chip_smoke.py
    holds the kernels to; hi.hi alone, one tf32 product, misses it."""
    a, b = _randn(k, 64, k), _randn(k + 1, k, 96)
    ref = a.double() @ b.double()
    three = (fa.matmul_tf32x3_plain(a, b).double() - ref).abs().max().item()
    a_hi, _ = fa.split_tf32_plain(a)
    b_hi, _ = fa.split_tf32_plain(b)
    one = ((a_hi @ b_hi).double() - ref).abs().max().item()
    assert _gate(three, ref)
    assert not _gate(one, ref)
    assert three < one / 100


def test_transposed_copy_layout():
    """[B, N, C] -> [B, C, NP]: NP = N rounded up to 8, stored column
    8g + i is row 8g + TF32_PERM[i], rows past N read as zeros."""
    b, n, c = 2, 21, 32
    x = _randn(3, b, n, c)
    xt = fa.transpose_tf32_plain(x)
    assert xt.shape == (b, c, 24)
    for pos in range(24):
        row = 8 * (pos // 8) + fa.TF32_PERM[pos % 8]
        want = x[:, row] if row < n else torch.zeros(b, c)
        assert torch.equal(xt[:, :, pos], want), pos
    # the CPU path of the split wrapper: the plain versions, rows then cols
    (q_hi, q_lo), (t_hi, t_lo) = fa.split_tf32([x], [x])
    assert torch.equal(q_hi + q_lo, fa.split_tf32_plain(x)[0]
                       + fa.split_tf32_plain(x)[1])
    assert torch.equal(t_hi, fa.split_tf32_plain(xt)[0])
    assert torch.equal(t_lo, fa.split_tf32_plain(xt)[1])


def _fragment_matrix(p):
    """The [64, 64] A operand that wgmma reads from an m64n64 accumulator
    holding `p`, packed as csrc/tf32x3.cuh:acc_to_tf32x2 packs it: thread t
    (warp w, lane l; rows r = 16w + l/4 and r + 8, q = l % 4) holds
    p[r, 8j + 2q + e] and p[r + 8, 8j + 2q + e]; its fragment of k8 step j
    is (p[r, 2q], p[r + 8, 2q], p[r, 2q + 1], p[r + 8, 2q + 1]), which the
    tensor core reads as (r, k q), (r + 8, k q), (r, k q + 4),
    (r + 8, k q + 4)."""
    a = torch.zeros_like(p)
    for t in range(128):
        w, lane = divmod(t, 32)
        r, q = 16 * w + lane // 4, lane % 4
        for j in range(8):
            acc = [p[r, 8 * j + 2 * q], p[r, 8 * j + 2 * q + 1],
                   p[r + 8, 8 * j + 2 * q], p[r + 8, 8 * j + 2 * q + 1]]
            frag = [acc[0], acc[2], acc[1], acc[3]]
            a[r, 8 * j + q], a[r + 8, 8 * j + q] = frag[0], frag[1]
            a[r, 8 * j + q + 4], a[r + 8, 8 * j + q + 4] = frag[2], frag[3]
    return a


def test_accumulator_fragments_meet_the_permuted_copy():
    """P's registers as A against the transposed, permuted copy of V is
    P V: the permutation TF32_PERM undoes the fragment packing. Small
    integers keep every sum exact."""
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.integers(-4, 5, (64, 64)).astype(np.float32))
    v = torch.from_numpy(rng.integers(-4, 5, (1, 64, 40)).astype(np.float32))
    vt = fa.transpose_tf32_plain(v)[0]  # [40, 64]
    assert torch.equal(_fragment_matrix(p) @ vt.T, p @ v[0])
    assert not torch.equal(p @ vt.T, p @ v[0])  # the permutation matters


def _emulated_forward(q, k, v, softmax):
    """One head's fp32 forward with both products as 3xTF32, the softmax
    in fp32 as the d=512 kernel computes it."""
    s = fa.matmul_tf32x3_plain(q, k.T) / np.sqrt(q.shape[-1])
    if softmax == "shifted":
        shift = fa.row_shift(q[None], k[None], 1)[0][:, None]
        p = torch.exp(torch.clamp(s - shift, max=fa.EXP_CLAMP))
    else:
        p = torch.exp(s - s.amax(-1, keepdim=True))
    return fa.matmul_tf32x3_plain(p, v) / p.sum(-1, keepdim=True).clamp(
        min=1e-30)


@pytest.mark.parametrize("softmax", ["shifted", "online"])
def test_emulated_d512_forward_matches_the_tpu_kernel(softmax):
    nq, nk, d = 96, 75, 512
    q, k, v = _randn(5, nq, d), _randn(6, nk, d), _randn(7, nk, d)
    got = _emulated_forward(q, k, v, softmax)

    def fold(x):  # [N, D] -> the TPU kernel's [BH, D, N]
        return jnp.asarray(x.numpy().T[None])

    ref = np.asarray(jfa._flash_dt_impl(
        fold(q), fold(k), fold(v), block_q=128, block_k=128, interpret=True,
        softmax=softmax))[0].T
    err = np.abs(got.numpy() - ref).max()
    assert err <= F32_TOL_REL * np.abs(ref).max() + F32_TOL_ABS


def test_emulated_dkv_matches_the_plain_backward():
    """dK/dV with its four products as 3xTF32 (S^T, dP^T, dV, dK; P and dS
    fp32 from the logsumexp and delta) against the port's plain
    backward."""
    nq, nk, d = 70, 90, 64
    q, g = _randn(8, nq, d), _randn(9, nq, d)
    k, v = _randn(10, nk, d), _randn(11, nk, d)
    scale = 1.0 / np.sqrt(d)
    out, lse = fa.flash_attention_lse_plain(q[None], k[None], v[None], 1)
    delta = (out[0] * g).sum(-1)
    st = fa.matmul_tf32x3_plain(k, q.T) * scale  # [nk, nq]
    pt = torch.exp(st - lse[0][None])
    dpt = fa.matmul_tf32x3_plain(v, g.T)
    dst = pt * (dpt - delta[None])
    dv = fa.matmul_tf32x3_plain(pt, g)
    dk = fa.matmul_tf32x3_plain(dst, q) * scale
    _, dk_ref, dv_ref = fa.flash_attention_bwd_plain(q[None], k[None], v[None],
                                                     g[None], 1)
    for got, ref in ((dk, dk_ref[0]), (dv, dv_ref[0])):
        assert _gate((got - ref).abs().max().item(), ref)


def _fold(x):  # one head's [N, D] -> the TPU kernels' [BH, D, N]
    return jnp.asarray(x.numpy().T[None])


def _emulated_shift(q, k):
    """The row shift [nq, 1] in base-2 units as the shifted kernel of
    csrc/flash_fwd_d64_f32_sm90.cu computes it, before its key loop: the
    sampled keys (`fa.shift_sample`: 0, stride, ... < nk) in tiles of
    KEY_TILE rows (zeros past n_sub, as TMA fills them), S as 3xTF32, the
    columns >= n_sub masked to -1e30, the row max, then max * scale log2(e)
    + 40 log2(e) in fp32."""
    nq, d = q.shape
    scale_log2 = np.float32(1.0 / np.sqrt(d)) * LOG2E
    stride, n_sub = fa.shift_sample(k.shape[0])
    n_pad = -(-n_sub // KEY_TILE) * KEY_TILE
    sample = torch.zeros(n_pad, d)
    sample[:n_sub] = k[::stride]
    mx = torch.full((nq, 1), -1e30)
    for k0 in range(0, n_pad, KEY_TILE):
        s = fa.matmul_tf32x3_plain(q, sample[k0:k0 + KEY_TILE].T)
        s[:, max(0, n_sub - k0):] = -1e30
        mx = torch.maximum(mx, s.amax(-1, keepdim=True))
    return mx * scale_log2 + np.float32(fa.SHIFT_MARGIN) * LOG2E


def _emulated_d64_forward(q, k, v, softmax):
    """One head (the kernel's instantiations at 40, 64, 80 and 160 walk the
    keys alike) as csrc/flash_fwd_d64_f32_sm90.cu computes it in fp32: in
    shifted mode first the row shift (`_emulated_shift`), then per
    KEY_TILE keys S as 3xTF32, the softmax in base 2 (online: the running
    max, O and l rescaled; shifted: the row shift and the clamp in base-2
    units), the tile's P V as 3xTF32 into a fresh product added into O.
    Returns (out, lse in natural-log units)."""
    nq, d = q.shape
    scale_log2 = np.float32(1.0 / np.sqrt(d)) * LOG2E
    m = torch.full((nq, 1), -1e30)
    ref = _emulated_shift(q, k) if softmax == "shifted" else None
    l, o = torch.zeros(nq, 1), torch.zeros(nq, d)
    for k0 in range(0, k.shape[0], KEY_TILE):
        s = fa.matmul_tf32x3_plain(q, k[k0:k0 + KEY_TILE].T)
        if softmax == "online":
            ref = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
            alpha = torch.exp2(m - ref)
            m, l, o = ref, l * alpha, o * alpha
        x = s * scale_log2 - ref
        if softmax == "shifted":
            x = torch.clamp(x, max=fa.EXP_CLAMP * LOG2E)
        p = torch.exp2(x)
        l = l + p.sum(-1, keepdim=True)
        o = o + fa.matmul_tf32x3_plain(p, v[k0:k0 + KEY_TILE])
    l = l.clamp(min=1e-30)
    return o / l, (np.log(2.0) * (m + torch.log2(l)))[:, 0]


@pytest.mark.parametrize("softmax", ["shifted", "online"])
@pytest.mark.parametrize("nq,nk", [(150, 131), (64, 200), (129, 127)])
def test_emulated_d64_forward_matches_the_tpu_kernel(softmax, nq, nk):
    q, k, v = _randn(20, nq, 64), _randn(21, nk, 64), _randn(22, nk, 64)
    got, _ = _emulated_d64_forward(q, k, v, softmax)
    ref = np.asarray(jfa._flash_dt_impl(
        _fold(q), _fold(k), _fold(v), block_q=128, block_k=128, interpret=True,
        softmax=softmax))[0].T
    err = np.abs(got.numpy() - ref).max()
    assert err <= F32_TOL_REL * np.abs(ref).max() + F32_TOL_ABS


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("nq,nk", [(129, 300), (70, 1300)])
def test_emulated_shift_meets_row_shift(d, nq, nk, negative):
    """The kernel's own shift (3xTF32 on the sampled keys, base 2) against
    row_shift's (fp32 products of the same keys) in base 2: nk = 300 takes
    stride 2 and 150 keys over three 64-key sample tiles, nk = 1300 stride
    10 and 130 keys. With every logit negative a zero-filled sample row
    left unmasked would win the max."""
    q, k = _randn(40, nq, d), _randn(41, nk, d)
    if negative:
        q, k = q.abs(), -k.abs()
    got = _emulated_shift(q, k)[:, 0]
    ref = fa.row_shift(q[None], k[None], 1)[0] * LOG2E
    assert bool(((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1)).all())


@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("nq,nk", [(129, 300), (70, 1300)])
def test_emulated_shifted_forward_matches_the_tpu_kernel(d, nq, nk):
    """The emulated shifted forward, with the shift the kernel computes
    itself, against the Pallas kernel (interpret mode), whose wrapper takes
    the shift from its own strided product: nq != nk, nk ragged against
    the 64-key tiles, at every width the kernel is instantiated for."""
    q, k, v = _randn(42, nq, d), _randn(43, nk, d), _randn(44, nk, d)
    got, _ = _emulated_d64_forward(q, k, v, "shifted")
    ref = np.asarray(jfa._flash_dt_impl(
        _fold(q), _fold(k), _fold(v), block_q=128, block_k=128, interpret=True,
        softmax="shifted"))[0].T
    err = np.abs(got.numpy() - ref).max()
    assert err <= F32_TOL_REL * np.abs(ref).max() + F32_TOL_ABS


@pytest.mark.parametrize("nq,nk", [(150, 131), (129, 200)])
def test_emulated_d64_lse_forward_matches_the_tpu_kernel(nq, nk):
    """The training forward, out and lse (natural-log units, written by the
    kernel as ln(2) (m_2 + log2(l)))."""
    q, k, v = _randn(23, nq, 64), _randn(24, nk, 64), _randn(25, nk, 64)
    out, lse = _emulated_d64_forward(q, k, v, "online")
    out_j, lse_j = jfa._flash_dt_impl_lse(_fold(q), _fold(k), _fold(v), 128,
                                          128, True)
    for got, ref in ((out.numpy(), np.asarray(out_j)[0].T),
                     (lse.numpy(), np.asarray(lse_j)[0])):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= (F32_TOL_REL * np.abs(ref).max()
                                           + F32_TOL_ABS)


def _emulated_dq(q, k, v, out, lse, g):
    """One 64-wide head as csrc/flash_bwd_dq_f32_sm90.cu computes it in
    fp32: delta = rowsum(dO * O), the padded lse and delta rows
    ([round_up(nq, STAT_PAD)], LSE_PAD and 0 past nq), then per KEY_TILE
    keys S and dP as 3xTF32, P = exp2(S scale log2(e) - lse log2(e)),
    dS = P (dP - delta), dS K as 3xTF32 into a fresh product added into dQ;
    dQ * scale at the end. Returns (dq, lse_p, delta_p)."""
    nq, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    delta = (out * g).sum(-1)
    n_pad = -(-nq // fa.STAT_PAD) * fa.STAT_PAD
    lse_p = torch.full((n_pad,), fa.LSE_PAD)
    lse_p[:nq] = lse
    delta_p = torch.zeros(n_pad)
    delta_p[:nq] = delta
    acc = torch.zeros(nq, d)
    for k0 in range(0, k.shape[0], KEY_TILE):
        kt, vt = k[k0:k0 + KEY_TILE], v[k0:k0 + KEY_TILE]
        s = fa.matmul_tf32x3_plain(q, kt.T)
        p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[:, None])
        ds = p * (fa.matmul_tf32x3_plain(g, vt.T) - delta[:, None])
        acc = acc + fa.matmul_tf32x3_plain(ds, kt)
    return acc * scale, lse_p, delta_p


@pytest.mark.parametrize("nq,nk", [(150, 131), (129, 127), (64, 128)])
def test_emulated_dq_matches_the_tpu_kernel(nq, nk):
    """dQ against the Pallas dQ kernel (interpret mode) on the JAX
    forward's out and lse, and against the port's plain backward; the
    padded rows against bwd_stats."""
    q, g = _randn(26, nq, 64), _randn(27, nq, 64)
    k, v = _randn(28, nk, 64), _randn(29, nk, 64)
    out_j, lse_j = jfa._flash_dt_impl_lse(_fold(q), _fold(k), _fold(v), 128,
                                          128, True)
    dq_j, _, _ = jfa._flash_dt_bwd_pallas(
        _fold(q), _fold(k), _fold(v), out_j, lse_j, _fold(g), block_q=128,
        block_k=128, interpret=True)
    out = torch.from_numpy(np.asarray(out_j)[0].T.copy())
    lse = torch.from_numpy(np.asarray(lse_j)[0].copy())
    dq, lse_p, delta_p = _emulated_dq(q, k, v, out, lse, g)
    dq_plain = fa.flash_attention_bwd_plain(q[None], k[None], v[None],
                                            g[None], 1)[0][0]
    for ref in (np.asarray(dq_j)[0].T, dq_plain.numpy()):
        assert np.abs(dq.numpy() - ref).max() <= (
            F32_TOL_REL * np.abs(ref).max() + F32_TOL_ABS)
    lse_ref, delta_ref = fa.bwd_stats(out[None], lse[None], g[None], 1)
    assert torch.equal(lse_p, lse_ref[0])
    assert _gate((delta_p - delta_ref[0]).abs().max().item(), delta_ref[0])
    assert bool((delta_p[nq:] == 0).all())


@pytest.mark.parametrize("source", ["flash_fwd_d64_f32_sm90.cu",
                                    "flash_bwd_dq_f32_sm90.cu"])
def test_emulations_walk_the_keys_as_the_sources(source):
    """The emulations' key tile is the sources' BK; the forward takes 128
    query rows per block (two consumers of 64), the dQ kernel 128 at
    D <= 64 and 64 at 80 and 160 (both consumers on the same rows), which
    leaves each row's sums as they are; the dQ kernel pads the statistics
    to STAT_PAD."""
    text = (CSRC / source).read_text()
    assert int(re.search(r"constexpr int BK = (\d+);", text).group(1)) == KEY_TILE
    assert "constexpr int CONSUMERS = 2;" in text
    if "dq" in source:
        assert "static constexpr int BQ = COLSPLIT ? 64 : 128;" in text
        assert "static constexpr bool COLSPLIT = D > 64;" in text
        pad = int(re.search(r"constexpr int STAT_PAD = (\d+);", text).group(1))
        assert pad == fa.STAT_PAD
    else:
        assert "constexpr int BQ = 128;" in text


@pytest.mark.parametrize("d", [40, 80, 160])
def test_emulated_dq_matches_the_tpu_kernel_at_sd1_widths(d):
    """The dQ emulation (KEY_TILE keys per fresh tile product, as
    csrc/flash_bwd_dq_f32_sm90.cu walks them at every width) at the SD1.x
    head widths against the Pallas dQ kernel in interpret mode and the
    port's plain backward, nq != nk across the tiles; the padded rows
    against bwd_stats."""
    nq, nk = 129, 150
    q, g = _randn(50 + d, nq, d), _randn(51 + d, nq, d)
    k, v = _randn(52 + d, nk, d), _randn(53 + d, nk, d)
    out_j, lse_j = jfa._flash_dt_impl_lse(_fold(q), _fold(k), _fold(v), 128,
                                          128, True)
    dq_j, _, _ = jfa._flash_dt_bwd_pallas(
        _fold(q), _fold(k), _fold(v), out_j, lse_j, _fold(g), block_q=128,
        block_k=128, interpret=True)
    out = torch.from_numpy(np.asarray(out_j)[0].T.copy())
    lse = torch.from_numpy(np.asarray(lse_j)[0].copy())
    dq, lse_p, delta_p = _emulated_dq(q, k, v, out, lse, g)
    dq_plain = fa.flash_attention_bwd_plain(q[None], k[None], v[None],
                                            g[None], 1)[0][0]
    for ref in (np.asarray(dq_j)[0].T, dq_plain.numpy()):
        assert np.abs(dq.numpy() - ref).max() <= (
            F32_TOL_REL * np.abs(ref).max() + F32_TOL_ABS)
    lse_ref, delta_ref = fa.bwd_stats(out[None], lse[None], g[None], 1)
    assert torch.equal(lse_p, lse_ref[0])
    assert _gate((delta_p - delta_ref[0]).abs().max().item(), delta_ref[0])


def _emulated_dkv(q, k, v, g):
    """One head's dK and dV as csrc/flash_bwd_dkv_f32_sm90.cu computes them
    in fp32: per KEY_TILE query rows S^T and dP^T as 3xTF32, P^T and dS^T
    from the logsumexp and delta, and the stage's dV and dK products as
    3xTF32 into fresh products added into dV and dK; dK * scale at the
    end."""
    nq, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    out, lse = fa.flash_attention_lse_plain(q[None], k[None], v[None], 1)
    delta = (out[0] * g).sum(-1)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r0 in range(0, nq, KEY_TILE):
        qt, gt = q[r0:r0 + KEY_TILE], g[r0:r0 + KEY_TILE]
        st = fa.matmul_tf32x3_plain(k, qt.T)
        pt = torch.exp2(st * (scale * LOG2E)
                        - (lse[0, r0:r0 + KEY_TILE] * LOG2E)[None])
        dst = pt * (fa.matmul_tf32x3_plain(v, gt.T)
                    - delta[r0:r0 + KEY_TILE][None])
        dv = dv + fa.matmul_tf32x3_plain(pt, gt)
        dk = dk + fa.matmul_tf32x3_plain(dst, qt)
    return dk * scale, dv


@pytest.mark.parametrize("d", [40, 80, 160])
def test_emulated_dkv_matches_the_plain_backward_at_sd1_widths(d):
    """dK/dV walked in the source's 64-row query stages (its BN, at every
    width) at the SD1.x head widths, against the port's plain backward and
    the Pallas dK/dV kernel in interpret mode."""
    text = (CSRC / "flash_bwd_dkv_f32_sm90.cu").read_text()
    assert int(re.search(r"constexpr int BN = (\d+);", text).group(1)) == KEY_TILE
    nq, nk = 150, 129
    q, g = _randn(60 + d, nq, d), _randn(61 + d, nq, d)
    k, v = _randn(62 + d, nk, d), _randn(63 + d, nk, d)
    dk, dv = _emulated_dkv(q, k, v, g)
    _, dk_ref, dv_ref = fa.flash_attention_bwd_plain(q[None], k[None], v[None],
                                                     g[None], 1)
    out_j, lse_j = jfa._flash_dt_impl_lse(_fold(q), _fold(k), _fold(v), 128,
                                          128, True)
    _, dk_j, dv_j = jfa._flash_dt_bwd_pallas(
        _fold(q), _fold(k), _fold(v), out_j, lse_j, _fold(g), block_q=128,
        block_k=128, interpret=True)
    for got, refs in ((dk, (dk_ref[0].numpy(), np.asarray(dk_j)[0].T)),
                      (dv, (dv_ref[0].numpy(), np.asarray(dv_j)[0].T))):
        for ref in refs:
            assert np.abs(got.numpy() - ref).max() <= (
                F32_TOL_REL * np.abs(ref).max() + F32_TOL_ABS)


def test_split_takes_the_backward_s_seven_jobs():
    """The fp32 backward's one split (split_bwd_f32): q, dO, k, v in their
    layout, then q, dO, k transposed, within the kernel's MAX_JOBS; on CPU
    tensors the plain versions."""
    text = (CSRC / "tf32_split.cu").read_text()
    max_jobs = int(re.search(r"constexpr int MAX_JOBS = (\d+);", text).group(1))
    q, g = _randn(30, 2, 21, 64), _randn(31, 2, 21, 64)
    k, v = _randn(32, 2, 13, 64), _randn(33, 2, 13, 64)
    parts = fa.split_bwd_f32(q, k, v, g)
    assert len(parts) == 7 <= max_jobs
    want = ([fa.split_tf32_plain(x) for x in (q, g, k, v)]
            + [fa.split_tf32_plain(fa.transpose_tf32_plain(x))
               for x in (q, g, k)])
    for got, ref in zip(parts, want):
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
