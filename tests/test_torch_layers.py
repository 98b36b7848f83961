"""The port's building blocks (marigold_tpu_torch.models.layers, NCHW with
torch-layout weights) against marigold_tpu.models.layers (NHWC, HWIO) on
the same numpy inputs and weights. fp32, atol 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from marigold_tpu.models import layers as JL
from marigold_tpu_torch.models import layers as TL

ATOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("kernel,stride,padding,hw", [
    (3, 1, 1, (7, 9)), (3, 2, 1, (7, 9)), (1, 1, 0, (5, 6)), (3, 2, 0, (8, 8)),
])
def test_conv2d(kernel, stride, padding, hw, rng):
    cin, cout = 6, 10
    x = rng.standard_normal((2,) + hw + (cin,)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, cin, cout)).astype(np.float32) * 0.2
    b = rng.standard_normal((cout,)).astype(np.float32)
    ref = np.asarray(JL.conv2d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                               jnp.asarray(x), stride=stride, padding=padding))
    conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(_nhwc(conv(_nchw(x))), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_group_norm(act, eps, rng):
    c, g = 16, 4
    x = (rng.standard_normal((2, 5, 7, c)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal((c,)).astype(np.float32)
    b = rng.standard_normal((c,)).astype(np.float32)
    ref = np.asarray(JL.group_norm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                   jnp.asarray(x), g, eps=eps, act=act))
    gn = TL.GroupNorm(g, c, eps)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(w))
        gn.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(_nhwc(gn(_nchw(x), act=act)), ref, atol=ATOL, rtol=0)


def test_group_norm_keeps_storage_dtype():
    x = torch.randn(1, 8, 4, 4, dtype=torch.bfloat16)
    gn = TL.GroupNorm(2, 8).to(torch.bfloat16)
    assert gn(x, act="silu").dtype == torch.bfloat16


def test_layer_norm(rng):
    x = (rng.standard_normal((2, 9, 12)) * 2).astype(np.float32)
    w = rng.standard_normal((12,)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    ref = np.asarray(JL.layer_norm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                   jnp.asarray(x)))
    ln = TL.LayerNorm(12)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=ATOL, rtol=0)


def test_linear(rng):
    x = rng.standard_normal((3, 4, 6)).astype(np.float32)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    ref = np.asarray(JL.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                               jnp.asarray(x)))
    lin = nn.Linear(6, 5)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("dim", [8, 320, 11])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 249, 999], np.int32)
    ref = np.asarray(JL.timestep_embedding(jnp.asarray(t), dim))
    got = TL.timestep_embedding(torch.from_numpy(t), dim).numpy()
    # XLA's and torch's fp32 exp differ by up to 1 ulp in some frequencies;
    # the argument t * freq carries that as t * eps, up to ~1.2e-4 rad at
    # t = 999, so the bound grows with t
    atol = ATOL + t.max() * np.finfo(np.float32).eps
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    np.testing.assert_allclose(got[:2], ref[:2], atol=ATOL, rtol=0)


def test_geglu(rng):
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = (rng.standard_normal((6, 16)) * 0.5).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    ref = np.asarray(JL.geglu({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                              jnp.asarray(x)))
    ff = TL.GEGLU(6, 8)
    with torch.no_grad():
        ff.proj.weight.copy_(torch.from_numpy(w.T.copy()))
        ff.proj.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(ff(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=ATOL, rtol=0)


def test_upsample_nearest_2x(rng):
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    ref = np.asarray(JL.upsample_nearest_2x(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(TL.upsample_nearest_2x(_nchw(x))), ref)
