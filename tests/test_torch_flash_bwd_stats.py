"""The backward kernels' row statistics (marigold_tpu_torch.ops.
flash_attention.row_delta and bwd_stats) against what the JAX package's
`_flash_dt_bwd_pallas` hands its Pallas kernels: delta = rowsum(dO * O) per
query row in fp32, and lse and delta padded with `_LSE_PAD` and 0. The port
pads to a multiple of STAT_PAD (one 64-row stage of the dK/dV kernel) where
the TPU wrapper pads to its block; the padded values are the same. fp32,
atol 1e-5 and rtol 1e-5 (sums of 64 products in another order)."""

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
