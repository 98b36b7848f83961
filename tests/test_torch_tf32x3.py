"""The 3xTF32 arithmetic of the port's fp32 tensor-core kernels on the CPU.

`csrc/flash_fwd_d512_f32_sm90.cu` (the 512-wide fp32 forward) and
`csrc/flash_bwd_dkv_f32_sm90.cu` (fp32 dK/dV) split each fp32 operand into
two tf32 parts, hi + lo, by `csrc/tf32_split.cu` or in registers, and sum
lo.hi + hi.lo + hi.hi on the tensor cores. They run only on the card
(`chip_smoke.py`, `tests/test_torch_cuda.py`); here the plain emulation in
`ops/flash_attention.py` is held to its definition: the split's
reconstruction, the 3xTF32 product against float64 at the fp32 gate that
`chip_smoke.py` holds the kernels to (and one tf32 product missing it),
the split's transposed layout and the A-fragment permutation it encodes,
and an emulated forward and dK/dV against the TPU kernels (Pallas interpret
mode) and the port's plain backward.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marigold_tpu.ops import flash_attention as jfa
from marigold_tpu_torch.ops import flash_attention as fa

# chip_smoke.py's fp32 gate: max|err| <= F32_TOL_REL * max|ref| + F32_TOL_ABS
F32_TOL_REL, F32_TOL_ABS = 1e-4, 1e-6


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
