"""The port's training attention (marigold_tpu_torch.ops.flash_attention:
the lse forward, the backward and FlashAttentionFunction) against the JAX
package's flash_attention_dt custom VJP.

On the CPU the wrappers run their plain PyTorch versions, which are held
here against the TPU kernels themselves in Pallas interpret mode
(`_flash_dt_impl_lse(..., 128, 128, True)`,
`_flash_dt_bwd_pallas(..., interpret=True)`), fp32, atol 2e-4 and rtol 1e-3
(the tolerance of tests/test_flash_attention.py's backward tests). The
CUDA kernels against the plain versions are in test_torch_cuda.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marigold_tpu.ops import flash_attention as JF
from marigold_tpu_torch.models import weights as TW
from marigold_tpu_torch.ops import attention as TA
from marigold_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 2e-4, 1e-3


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _fold(x, heads):
    """[B, N, C] numpy -> the TPU kernels' [BH, D, N]."""
    b, n, c = x.shape
    return jnp.asarray(x.reshape(b, n, heads, c // heads).transpose(0, 2, 3, 1)
                       .reshape(b * heads, c // heads, n))


def _unfold(x, b, heads):
    """[BH, D, N] -> [B, N, C] numpy."""
    x = np.asarray(x)
    _, d, n = x.shape
    return x.reshape(b, heads, d, n).transpose(0, 3, 1, 2).reshape(b, n, heads * d)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (2, 300, 300, 128, 2),  # several heads, ragged against the 128 blocks
    (1, 200, 300, 64, 1),   # nq != nk
    # the fp32 kernels' tiles (csrc/flash_fwd_d64_f32_sm90.cu,
    # csrc/flash_bwd_dq_f32_sm90.cu: 128-row query blocks, 64-key tiles;
    # the dK/dV kernel's 64-row stages): one whole tile, a row past it, a
    # row short of two, then a row short of a block with a key past two
    # tiles and a row past a block, two heads of 64
    (1, 64, 64, 128, 2),
    (1, 65, 127, 128, 2),
    (1, 127, 65, 128, 2),
    (1, 127, 129, 128, 2),
    (1, 129, 128, 128, 2),
])
def test_lse_plain_matches_tpu_kernel(rng, b, nq, nk, c, heads):
    q, k, v = _rand(rng, b, nq, c), _rand(rng, b, nk, c), _rand(rng, b, nk, c)
    out_j, lse_j = JF._flash_dt_impl_lse(_fold(q, heads), _fold(k, heads),
                                         _fold(v, heads), 128, 128, True)
    out, lse = fa.flash_attention_lse(_t(q), _t(k), _t(v), heads)
    np.testing.assert_allclose(out.numpy(), _unfold(out_j, b, heads),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (2, 384, 384, 128, 2),
    (1, 200, 300, 64, 1),
    # the fp32 kernels' tiles (csrc/flash_fwd_d64_f32_sm90.cu,
    # csrc/flash_bwd_dq_f32_sm90.cu: 128-row query blocks, 64-key tiles;
    # the dK/dV kernel's 64-row stages): one whole tile, a row past it, a
    # row short of two, then a row short of a block with a key past two
    # tiles and a row past a block, two heads of 64
    (1, 64, 64, 128, 2),
    (1, 65, 127, 128, 2),
    (1, 127, 65, 128, 2),
    (1, 127, 129, 128, 2),
    (1, 129, 128, 128, 2),
])
def test_bwd_plain_matches_tpu_kernels(rng, b, nq, nk, c, heads):
    q, g = _rand(rng, b, nq, c), _rand(rng, b, nq, c)
    k, v = _rand(rng, b, nk, c), _rand(rng, b, nk, c)
    qt, kt, vt, gt = (_fold(x, heads) for x in (q, k, v, g))
    out, lse = JF._flash_dt_impl_lse(qt, kt, vt, 128, 128, True)
    ref = JF._flash_dt_bwd_pallas(qt, kt, vt, out, lse, gt, block_q=128,
                                  block_k=128, interpret=True)
    got = fa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(g), heads)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), _unfold(r, b, heads), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (2, 256, 256, 128, 2),  # multi-head [B, N, C]
    (1, 200, 300, 64, 1),   # nq != nk
])
def test_function_grads_match_jax_custom_vjp(rng, b, nq, nk, c, heads):
    q, w = _rand(rng, b, nq, c), _rand(rng, b, nq, c)
    k, v = _rand(rng, b, nk, c), _rand(rng, b, nk, c)

    def loss_jax(qt, kt, vt):
        out = JF.flash_attention_dt(qt, kt, vt, 128, 128, True)
        return jnp.sum(out * _fold(w, heads))

    ref = jax.grad(loss_jax, argnums=(0, 1, 2))(
        _fold(q, heads), _fold(k, heads), _fold(v, heads))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttentionFunction.apply(*leaves, heads, "shifted")
    (out * _t(w)).sum().backward()
    for name, leaf, r in zip("qkv", leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), _unfold(r, b, heads),
                                   atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("c,heads", [
    (64, 1),  # 64-wide head: lse forward + kernel backward route
    (32, 2),  # other widths: serving forward + plain backward route
])
def test_function_gradcheck_float64(c, heads):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 12, c), generator=gen, dtype=torch.float64)
    k = torch.randn((1, 9, c), generator=gen, dtype=torch.float64)
    v = torch.randn((1, 9, c), generator=gen, dtype=torch.float64)
    for softmax in fa.SOFTMAX_MODES:
        assert torch.autograd.gradcheck(
            lambda q, k, v: fa.FlashAttentionFunction.apply(q, k, v, heads,
                                                            softmax),
            tuple(t.clone().requires_grad_() for t in (q, k, v)))


@pytest.mark.parametrize("kernel_route", [True, False])
def test_unet_grads_through_flash_dispatch_match_jax(rng, monkeypatch,
                                                    kernel_route):
    """A tiny UNet differentiated with the port's flash dispatch forced on
    (FlashAttentionFunction on the CPU for every attention), every
    parameter's gradient against jax.grad of the JAX UNet, which
    tests/test_flash_attention.py::test_unet_grad_flows_through_flash_dispatch
    holds to the same gradients with its flash dispatch forced on. The tiny
    heads are 4 wide; `kernel_route` admits that width to the lse/backward
    route, else it takes the serving-forward route."""
    from marigold_tpu.models import unet as junet
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

    cfg = junet.UNetConfig(
        sample_size=16, in_channels=8, out_channels=4, block_out_channels=(8, 16),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        layers_per_block=1, attention_head_dim=(2, 4), cross_attention_dim=12,
        norm_num_groups=4,
    )
    params = junet.init_params(jax.random.PRNGKey(0), cfg)
    x = _rand(rng, 1, 16, 16, 8)
    ctx = np.zeros((1, 2, 12), np.float32)
    ref = jax.jit(jax.grad(lambda p: jnp.mean(
        junet.apply(p, cfg, jnp.asarray(x), jnp.asarray(10), jnp.asarray(ctx)) ** 2
    )))(params)
    ref = TW.from_jax_tree(ref)

    tcfg = UNetConfig.from_dict(cfg.to_dict())
    unet = TW.build_module(UNet2DConditionModel, tcfg, TW.from_jax_tree(params),
                           torch.float32, "cpu").requires_grad_(True)
    routes = []
    fwd = fa.FlashAttentionFunction.forward

    def spy(ctx_, *a):
        out = fwd(ctx_, *a)
        routes.append(ctx_.kernel_bwd)
        return out

    monkeypatch.setattr(TA, "use_flash", lambda q, nk: True)
    monkeypatch.setattr(fa, "TRAIN_HEAD_DIMS", (4,) if kernel_route else ())
    monkeypatch.setattr(fa.FlashAttentionFunction, "forward", staticmethod(spy))
    out = unet(_t(x.transpose(0, 3, 1, 2)), 10, _t(ctx))
    (out ** 2).mean().backward()
    # 4 transformer blocks (down, mid, 2 up): 4 self- and 4
    # cross-attentions, all through the autograd Function
    assert len(routes) == 8 and set(routes) == {kernel_route}
    for n, p in unet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(), atol=5e-5,
                                   rtol=1e-3, err_msg=n)
