"""The port's flash attention (marigold_tpu_torch.ops.flash_attention) and
attention dispatch against the JAX package.

On the CPU the wrapper runs its plain PyTorch version, which is held here
against the TPU kernels themselves in Pallas interpret mode
(`_flash_dt_impl(..., block_q=128, block_k=128, interpret=True)`), in each of
the three forward variants the CUDA kernel replaces, and the folded
`[BH, N, D]` entry against the first `flash_attention`. fp32, atol 2e-5.
The CUDA kernel against the plain version is in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from marigold_tpu.ops import attention as JA
from marigold_tpu.ops.flash_attention import _flash_dt_impl
from marigold_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from marigold_tpu_torch.ops import attention as TA
from marigold_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5


def _qkv(rng, b, n, c, scale=1.0):
    return [(rng.standard_normal((b, n, c)) * scale).astype(np.float32)
            for _ in range(3)]


def _jax_dt(q, k, v, heads, softmax):
    """[B, N, C] numpy -> the TPU kernel's [BH, D, N] layout and back."""
    b, n, c = q.shape
    d = c // heads

    def fold(x):
        return jnp.asarray(x.reshape(b, -1, heads, d).transpose(0, 2, 3, 1)
                           .reshape(b * heads, d, -1))

    out = _flash_dt_impl(fold(q), fold(k), fold(v), block_q=128, block_k=128,
                         interpret=True, softmax=softmax)
    return np.asarray(out).reshape(b, heads, d, n).transpose(0, 3, 1, 2).reshape(b, n, c)


def _port(q, k, v, heads, softmax):
    return fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), heads, softmax).numpy()


@pytest.mark.parametrize("softmax", ["shifted", "online"])
@pytest.mark.parametrize("b,n,c,heads", [
    (1, 300, 128, 2),   # d=64, ragged N: K-resident shifted kernel (#1)
    (1, 256, 512, 1),   # d=512: K-blocked shifted kernel (#2)
])
def test_plain_matches_tpu_kernels(b, n, c, heads, softmax, rng):
    q, k, v = _qkv(rng, b, n, c)
    np.testing.assert_allclose(_port(q, k, v, heads, softmax),
                               _jax_dt(q, k, v, heads, softmax),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("softmax", ["shifted", "online"])
@pytest.mark.parametrize("b,nq,nk", [
    (2, 300, 200),  # B = 2; nq, nk ragged against 64 and nq != nk
    (1, 100, 330),  # nq < nk, one key past 5 tiles of 64
])
def test_plain_matches_tpu_kernels_d512_edges(b, nq, nk, softmax, rng):
    """The 512-wide head at the Hopper kernel's edges (64-row query tiles,
    64-key tiles, B > 1): the K-blocked shifted kernel (#2) and the online
    kernel (#3), which the TPU package reaches at d = 512 through
    `_flash_dt_impl(softmax="online")`."""
    q = rng.standard_normal((b, nq, 512)).astype(np.float32)
    k, v = (rng.standard_normal((b, nk, 512)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(_port(q, k, v, 1, softmax),
                               _jax_dt(q, k, v, 1, softmax), atol=ATOL, rtol=0)


def test_plain_matches_online_kernel_multi_batch(rng):
    """Online kernel (#3) with B > 1 and several heads."""
    q, k, v = _qkv(rng, 2, 200, 128)
    np.testing.assert_allclose(_port(q, k, v, 2, "online"),
                               _jax_dt(q, k, v, 2, "online"), atol=ATOL, rtol=0)


def test_shifted_clamp_case_matches(rng):
    """One key column 200x larger, missed by the stride-4 subsample: the
    exp clamp engages, and the plain version must clamp exactly as the TPU
    kernel does (tests/test_flash_attention.py's spiky-K case)."""
    q, k, v = _qkv(rng, 1, 512, 64)
    k[0, 137] *= 200.0
    shift = fa.row_shift(torch.from_numpy(q), torch.from_numpy(k), 1)
    s = (q[0] @ k[0].T) / 8.0
    assert (s - shift.numpy()[0][:, None]).max() > fa.EXP_CLAMP  # clamp engages
    got = _port(q, k, v, 1, "shifted")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_dt(q, k, v, 1, "shifted"),
                               atol=ATOL, rtol=0)


def test_row_shift_stride_and_margin(rng):
    q, k, _ = _qkv(rng, 1, 700, 64)
    shift = fa.row_shift(torch.from_numpy(q), torch.from_numpy(k), 1).numpy()
    stride = 700 // 128
    s_sub = (q[0] @ k[0, ::stride].T) / 8.0
    np.testing.assert_allclose(shift[0], s_sub.max(-1) + 40.0, atol=1e-4, rtol=0)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 130, 64))
    before = sum(fa.launches.values())
    for mode in fa.SOFTMAX_MODES:
        torch.testing.assert_close(fa.flash_attention(q, k, v, 1, mode),
                                   fa.flash_attention_plain(q, k, v, 1, mode),
                                   atol=0, rtol=0)
    assert sum(fa.launches.values()) == before


def test_check_tma_takes_what_the_tensor_maps_take():
    """The forward kernels' TMA preconditions, checked on CPU tensors: a
    16-byte aligned base, a row stride that is a multiple of 16 bytes, at
    least one row. Contiguous [B, N, 64*H] bf16 tensors always pass."""
    ok = torch.zeros(2, 130, 320, dtype=torch.bfloat16)
    fa.check_tma({"q": ok, "k": ok[:1, :1]})
    flat = torch.zeros(4 * 64 + 16, dtype=torch.bfloat16)
    for shift, aligned in ((0, True), (1, False), (8, True)):
        t = flat[shift:shift + 4 * 64].view(1, 4, 64)
        if aligned:
            fa.check_tma({"q": t})
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                fa.check_tma({"q": t})
    with pytest.raises(ValueError, match="row stride of 120 bytes"):
        fa.check_tma({"k": torch.zeros(1, 3, 60, dtype=torch.bfloat16)})
    # a 512-wide head read out of rows of 516 channels
    wide = torch.zeros(1, 3, 516, dtype=torch.bfloat16)[..., :512]
    with pytest.raises(ValueError, match="row stride of 1032 bytes"):
        fa.check_tma({"q": wide})
    with pytest.raises(ValueError, match="no rows"):
        fa.check_tma({"v": ok[:, :0]})


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 32), torch.zeros(1, 8, 32), 1)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, 1, softmax="exact")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, 3)  # 64 channels over 3 heads
    m = torch.zeros(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention(m, m, m, 1)  # never the plain version off the CPU


@pytest.mark.parametrize("b,nq,nk,c,heads,masked", [
    (2, 1100, 1100, 128, 2, False),  # long self-attention (CPU: plain)
    (2, 64, 2, 48, 4, False),        # length-2 empty-prompt cross-attention
    (1, 6, 6, 24, 3, True),          # causal mask (CLIP)
])
def test_dispatch_matches_jax(b, nq, nk, c, heads, masked, rng):
    q = rng.standard_normal((b, nq, c)).astype(np.float32)
    k, v = (rng.standard_normal((b, nk, c)).astype(np.float32) for _ in range(2))
    mask = None
    if masked:
        mask = np.where(np.tril(np.ones((nq, nk), bool)), 0.0, -1e30).astype(np.float32)
    ref = np.asarray(JA.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
        mask=None if mask is None else jnp.asarray(mask)))
    got = TA.dispatch_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_flash_softmax_mode_switch():
    assert TA.get_flash_softmax() == "shifted"
    TA.set_flash_softmax("online")
    try:
        assert TA.get_flash_softmax() == "online"
        with pytest.raises(ValueError):
            TA.set_flash_softmax("exact")
    finally:
        TA.set_flash_softmax("shifted")


@pytest.mark.parametrize("bh,n,d", [(2, 256, 64), (1, 300, 64), (3, 130, 64),
                                    (1, 1024, 64)])
def test_folded_entry_matches_the_pallas_kernel(bh, n, d):
    """flash_attention_folded ([BH, N, D], kernel 7) against the TPU
    package's first flash_attention in interpret mode, which zero-pads D to
    128; the port's kernel takes D as it is."""
    rng = np.random.default_rng(bh * n)
    q, k, v = (rng.standard_normal((bh, n, d)).astype(np.float32)
               for _ in range(3))
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=128, block_k=128, interpret=True)
    got = fa.flash_attention_folded(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
