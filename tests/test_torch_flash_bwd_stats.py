"""The backward kernels' row statistics (marigold_tpu_torch.ops.
flash_attention.row_delta and bwd_stats) against what the JAX package's
`_flash_dt_bwd_pallas` hands its Pallas kernels: delta = rowsum(dO * O) per
query row in fp32, and lse and delta padded with `_LSE_PAD` and 0. The port
pads to a multiple of STAT_PAD (one 64-row stage of the dK/dV kernel) where
the TPU wrapper pads to its block; the padded values are the same. fp32,
atol 1e-5 and rtol 1e-5 (sums of 64 products in another order). Then the
dQ kernels' plain version, `flash_attention_bwd_dq_plain` (dq with those
statistics), against the Pallas dQ kernel in interpret mode at the four
training head widths, atol 2e-4 and rtol 1e-3 (the backward tests'
tolerance, tests/test_torch_flash_backward.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marigold_tpu.ops import flash_attention as JF
from marigold_tpu_torch.ops import flash_attention as fa


@pytest.mark.parametrize("b,nq,c,heads", [
    (1, 64, 64, 1),    # a whole stage: no padding
    (2, 77, 128, 2),   # fewer rows than one stage
    (1, 130, 320, 5),  # one row past two stages
])
def test_bwd_stats_match_the_tpu_wrapper(rng, b, nq, c, heads):
    out = rng.standard_normal((b, nq, c)).astype(np.float32)
    dout = rng.standard_normal((b, nq, c)).astype(np.float32)
    lse = rng.standard_normal((b * heads, nq)).astype(np.float32)
    d = c // heads

    def fold(x):  # [B, N, C] -> the TPU kernels' [BH, D, N]
        return jnp.asarray(x.reshape(b, nq, heads, d).transpose(0, 2, 3, 1)
                           .reshape(b * heads, d, nq))

    # _flash_dt_bwd_pallas: delta = sum(got * out, axis=1), then the pads
    delta_j = np.asarray(jnp.sum(fold(dout) * fold(out), axis=1))
    lse_p, delta_p = fa.bwd_stats(torch.from_numpy(out), torch.from_numpy(lse),
                                  torch.from_numpy(dout), heads)
    n_pad = -(-nq // fa.STAT_PAD) * fa.STAT_PAD
    assert lse_p.shape == delta_p.shape == (b * heads, n_pad)
    assert lse_p.dtype == delta_p.dtype == torch.float32
    np.testing.assert_array_equal(lse_p[:, :nq].numpy(), lse)
    np.testing.assert_allclose(delta_p[:, :nq].numpy(), delta_j, atol=1e-5,
                               rtol=1e-5)
    assert fa.LSE_PAD == JF._LSE_PAD
    assert bool((lse_p[:, nq:] == JF._LSE_PAD).all())
    assert bool((delta_p[:, nq:] == 0).all())
    np.testing.assert_allclose(
        fa.row_delta(torch.from_numpy(out), torch.from_numpy(dout), heads).numpy(),
        delta_j, atol=1e-5, rtol=1e-5)


def _fold_heads(x, heads):
    """[B, N, C] numpy -> the TPU kernels' [BH, D, N]."""
    b, n, c = x.shape
    return jnp.asarray(x.reshape(b, n, heads, c // heads).transpose(0, 2, 3, 1)
                       .reshape(b * heads, c // heads, n))


@pytest.mark.parametrize("d,b,nq,nk,heads", [
    (40, 1, 70, 90, 2),    # a stage and a part of query rows, ragged keys
    (64, 2, 64, 130, 2),   # one whole stage, two batch rows
    (80, 1, 129, 65, 2),   # a row past a 128-row dQ block
    (160, 1, 33, 100, 2),  # fewer rows than one stage
])
def test_dq_plain_matches_the_tpu_kernel_and_statistics(rng, d, b, nq, nk,
                                                        heads):
    c = d * heads
    q, g = (rng.standard_normal((b, nq, c)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, nk, c)).astype(np.float32)
            for _ in range(2))
    qt, kt, vt, gt = (_fold_heads(x, heads) for x in (q, k, v, g))
    out_j, lse_j = JF._flash_dt_impl_lse(qt, kt, vt, 128, 128, True)
    dq_j = JF._flash_dt_bwd_pallas(qt, kt, vt, out_j, lse_j, gt, block_q=128,
                                   block_k=128, interpret=True)[0]
    delta_j = np.asarray(jnp.sum(gt * out_j, axis=1))  # the TPU wrapper's
    out = np.asarray(out_j).reshape(b, heads, d, nq).transpose(0, 3, 1, 2) \
        .reshape(b, nq, c)
    dq, lse_p, delta_p = fa.flash_attention_bwd_dq_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v, out)),
        torch.from_numpy(np.array(lse_j)), torch.from_numpy(g), heads)
    dq_ref = np.asarray(dq_j).reshape(b, heads, d, nq).transpose(0, 3, 1, 2) \
        .reshape(b, nq, c)
    np.testing.assert_allclose(dq.numpy(), dq_ref, atol=2e-4, rtol=1e-3)
    n_pad = -(-nq // fa.STAT_PAD) * fa.STAT_PAD
    assert lse_p.shape == delta_p.shape == (b * heads, n_pad)
    np.testing.assert_array_equal(lse_p[:, :nq].numpy(), np.asarray(lse_j))
    assert bool((lse_p[:, nq:] == JF._LSE_PAD).all())
    np.testing.assert_allclose(delta_p[:, :nq].numpy(), delta_j, atol=1e-5,
                               rtol=1e-5)
    assert bool((delta_p[:, nq:] == 0).all())
