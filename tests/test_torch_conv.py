"""The port's 3x3 conv kernels' plain versions (marigold_tpu_torch.ops.conv,
ops.winograd) and the conv dispatch of models/layers.py against the JAX
package, fp32 on the CPU.

The plain versions are held to the TPU kernels themselves in Pallas
interpret mode, at the shapes of tests/test_conv_kernel.py and
tests/test_winograd.py, at atol REL * max|ref| (fp32 sums in another order).
The gate is compared with the JAX `supports()` functions at every 3x3 conv
of the full SD2 UNet and VAE at 768x768 and 576x768, and a 128-channel VAE
decode runs through the dispatch in both packages. The CUDA kernels against
these plain versions are in tests/test_torch_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from marigold_tpu.models import layers as JL
from marigold_tpu.models import vae as jvae
from marigold_tpu.ops import conv as jconv
from marigold_tpu.ops import winograd as jwino
from marigold_tpu_torch.models import layers as TL
from marigold_tpu_torch.models import unet as tunet
from marigold_tpu_torch.models import vae as tvae
from marigold_tpu_torch.models import weights as TW
from marigold_tpu_torch.ops import conv as tconv
from marigold_tpu_torch.ops import winograd as twino

REL = 1e-5
# F(2x2, 3x3) in fp32 reassociates the sums through the transforms: the
# JAX package's own test bounds it at 1e-4 of max|ref| (test_winograd.py)
WINO_REL = 1e-4


def _inputs(b, h, w, c, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, k)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(k).astype(np.float32)
    return x, wt, bias


def _port(fn, x, wt, bias):
    """NHWC / HWIO numpy -> the port's NCHW / OIHW call -> NHWC numpy."""
    out = fn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
             torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
             torch.from_numpy(bias))
    return out.numpy().transpose(0, 2, 3, 1)


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("b,h,w,c,k", [
    (2, 8, 16, 128, 128), (1, 6, 16, 256, 384), (1, 12, 12, 128, 128),
    (2, 4, 8, 384, 256)])
def test_nine_tap_plain_matches_the_pallas_kernel(b, h, w, c, k):
    x, wt, bias = _inputs(b, h, w, c, k)
    ref = jconv.conv3x3(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), True)
    _close(_port(tconv.conv3x3, x, wt, bias), ref, REL)
    _close(_port(tconv.conv3x3_plain, x, wt, bias), ref, REL)


@pytest.mark.parametrize("b,h,w,c,k", [
    (2, 8, 16, 128, 128), (1, 6, 16, 256, 384), (1, 12, 12, 128, 128),
    (2, 4, 8, 384, 256), (1, 8, 10, 128, 128)])
def test_winograd_plain_matches_the_pallas_kernel(b, h, w, c, k):
    x, wt, bias = _inputs(b, h, w, c, k, seed=1)
    with jax.default_matmul_precision("float32"):
        ref = jwino.winograd3x3(jnp.asarray(x), jnp.asarray(wt),
                                jnp.asarray(bias), True)
    _close(_port(twino.winograd3x3, x, wt, bias), ref, WINO_REL)
    # and it is the conv: against F.conv2d in float64
    x64, w64, b64 = (torch.from_numpy(a.astype(np.float64)) for a in (x, wt, bias))
    conv = F.conv2d(x64.permute(0, 3, 1, 2), w64.permute(3, 2, 0, 1), b64,
                    padding=1).permute(0, 2, 3, 1).numpy()
    _close(_port(twino.winograd3x3, x, wt, bias), conv, WINO_REL)


def test_bf16_plain_versions_against_the_fp32_conv():
    """bf16 inputs: the nine-tap sums exact products in fp32 (2% bound as
    tests/test_conv_kernel.py); Winograd rounds U and V to bf16 (4% bound as
    tests/test_winograd.py:52-55), in both packages."""
    x, wt, bias = _inputs(2, 6, 16, 128, 256, seed=2)
    ref = _port(lambda a, b, c: F.conv2d(a, b, c, padding=1), x, wt, bias)
    bf = [a.astype(jnp.bfloat16) for a in (x, wt, bias)]
    to_t = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
            for a in bf]
    for port, jax_fn, tol in ((tconv.conv3x3, jconv.conv3x3, 0.02),
                              (twino.winograd3x3, jwino.winograd3x3, 0.04)):
        got = port(to_t[0].permute(0, 3, 1, 2), to_t[1].permute(3, 2, 0, 1),
                   to_t[2]).float().numpy().transpose(0, 2, 3, 1)
        jgot = np.asarray(jax_fn(*[jnp.asarray(a) for a in bf], True), np.float32)
        for out in (got, jgot):
            assert np.abs(out - ref).max() / np.abs(ref).max() < tol


# ------------------------------------------------------------------ #
# the gate and the per-forward counts


def _conv_calls(model, *args):
    """(x NCHW shape, w OIHW shape, stride, padding) of every 3x3 Conv2d
    call of one forward on the meta device."""
    calls = []

    def hook(mod, inp, out):
        if mod.kernel_size == (3, 3):
            calls.append((tuple(inp[0].shape), tuple(mod.weight.shape),
                          mod.stride, mod.padding))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(*args)
    for h in handles:
        h.remove()
    return calls


@pytest.fixture(scope="module")
def sd2_conv_calls():
    """{(part, H, W): calls} for the SD2 UNet forward (batch 10, one denoise
    chunk of E=10) and the VAE encode/decode at 768x768 and 576x768."""
    with torch.device("meta"):
        unet = tunet.UNet2DConditionModel(tunet.UNetConfig())
        vae = tvae.AutoencoderKL(tvae.VAEConfig())
    out = {}
    for h, w in ((768, 768), (576, 768)):
        lat = torch.empty((10, 8, h // 8, w // 8), device="meta")
        ctx = torch.empty((1, 2, 1024), device="meta")
        out[("unet", h, w)] = _conv_calls(unet, lat, 801, ctx)
        out[("encode", h, w)] = _conv_calls(
            vae.encoder, torch.empty((1, 3, h, w), device="meta"))
        out[("decode", h, w)] = _conv_calls(
            vae.decoder, torch.empty((10, 4, h // 8, w // 8), device="meta"))
    return out


def _jax_gate(mod, x_shape, w_shape, stride, padding):
    b, c, h, w = x_shape
    k = w_shape[0]
    return mod.supports((b, h, w, c), (3, 3, c, k), stride[0],
                        [(padding[0], padding[0]), (padding[1], padding[1])],
                        jnp.bfloat16)


@pytest.mark.parametrize("part", ["unet", "encode", "decode"])
@pytest.mark.parametrize("hw", [(768, 768), (576, 768)])
def test_gate_and_counts_match_jax_supports(sd2_conv_calls, monkeypatch,
                                            part, hw):
    """The port's gate is JAX's `supports()` without the TPU VMEM `_plan`.
    That plan rejects one class of SD2 convs on the TPU: Winograd's 16 x C x
    128 filter panel exceeds its 5 MB VMEM budget at C = 1920 and 2560, the
    UNet's concatenated skip inputs (7 per forward at 768x768, 4 at
    576x768). The card has no such limit, so the port's Winograd takes them."""
    calls = sd2_conv_calls[(part,) + hw]
    counts = {}
    for impl, tmod, jmod in (("pallas", tconv, jconv), ("winograd", twino, jwino)):
        port = [tmod.supports(x, w, s, p, torch.bfloat16) for x, w, s, p in calls]
        with_plan = [_jax_gate(jmod, x, w, s, p) for x, w, s, p in calls]
        with monkeypatch.context() as mp:
            mp.setattr(jmod, "_plan", lambda *args: (1, 128))
            no_plan = [_jax_gate(jmod, x, w, s, p) for x, w, s, p in calls]
        assert port == no_plan
        counts[impl] = sum(port)
        counts[impl + "_tpu"] = sum(with_plan)
        counts[impl + "_wide"] = sum(p and w[1] in (1920, 2560)
                                     for p, (x, w, s, pad) in zip(port, calls))
    # the counts per forward at SD2 width, derived from the shapes: 35 per
    # UNet forward, 20 per VAE encode, 31 per VAE decode at 768x768; at
    # 576x768 Winograd also drops the UNet's 9x12 level (odd H: 14 convs)
    want = {"unet": 35, "encode": 20, "decode": 31}[part]
    odd = 14 if (part, hw) == ("unet", (576, 768)) else 0
    assert counts["pallas"] == counts["pallas_tpu"] == want
    assert counts["winograd"] == want - odd
    assert counts["winograd_tpu"] == want - odd - counts["winograd_wide"]
    assert counts["winograd_wide"] == {("unet", (768, 768)): 7,
                                       ("unet", (576, 768)): 4}.get((part, hw), 0)


def test_winograd_cap_is_read_per_call(monkeypatch):
    shape, w = (1, 128, 8, 16), (128, 128, 3, 3)
    assert twino.supports(shape, w, 1, 1, torch.bfloat16)
    monkeypatch.setenv("MARIGOLD_TPU_WINO_MAX_HW", str(8 * 16 - 1))
    assert not twino.supports(shape, w, 1, 1, torch.bfloat16)
    assert not jwino.supports((1, 8, 16, 128), (3, 3, 128, 128), 1,
                              [(1, 1), (1, 1)], jnp.bfloat16)


# ------------------------------------------------------------------ #
# the dispatch


@pytest.mark.parametrize("impl", ["pallas", "winograd"])
def test_kernel_conv_gradients_are_the_plain_conv_gradients(monkeypatch, impl):
    """Under autograd a kernel conv runs KernelConvFunction, whose input,
    weight and bias gradients are those of F.conv2d."""
    monkeypatch.setattr(TL, "_CONV_IMPL", impl)
    torch.manual_seed(0)
    conv = TL.Conv2d(128, 128, 3, padding=1)
    x = torch.randn(1, 128, 6, 8, requires_grad=True)
    g = torch.randn(1, 128, 6, 8)
    out = conv(x)
    assert out.grad_fn is not None and "KernelConvFunction" in type(out.grad_fn).__name__
    grads = torch.autograd.grad((out * g).sum(), (x, conv.weight, conv.bias))
    ref = F.conv2d(x, conv.weight, conv.bias, padding=1)
    ref_grads = torch.autograd.grad((ref * g).sum(), (x, conv.weight, conv.bias))
    for a, r in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl", ["pallas", "winograd"])
def test_vae_decode_through_the_dispatch_matches_jax(monkeypatch, impl):
    """A 128-channel VAE decode with every gated conv on the kernel path in
    both packages (JAX: `_CONV_IMPL` patched, Pallas interpret mode)."""
    cfg = jvae.VAEConfig(block_out_channels=(128, 128), layers_per_block=1,
                         latent_channels=4, norm_num_groups=32)
    params = jvae.init_params(jax.random.PRNGKey(0), cfg)
    model = TW.build_module(tvae.AutoencoderKL,
                            tvae.VAEConfig.from_dict(cfg.to_dict()),
                            TW.from_jax_tree(params), torch.float32, "cpu")
    z = np.random.default_rng(3).standard_normal((1, 4, 4, 4)).astype(np.float32)
    monkeypatch.setenv("MARIGOLD_TPU_CONV_INTERPRET", "1")
    monkeypatch.setattr(JL, "_CONV_IMPL", impl)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jvae.decode(params, cfg, jnp.asarray(z)))
    monkeypatch.setattr(TL, "_CONV_IMPL", impl)
    seen = []
    for name in ("conv3x3", "winograd3x3"):
        mod = tconv if name == "conv3x3" else twino
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda x, w, b, orig=orig, name=name:
                            seen.append(name) or orig(x, w, b))
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z.transpose(0, 3, 1, 2).copy()))
    # the decoder's gated convs: mid 2 resnets (4), up blocks 2 x 2 resnets
    # (8) and one upsampler
    assert seen == [{"pallas": "conv3x3", "winograd": "winograd3x3"}[impl]] * 13
    _close(got.numpy().transpose(0, 2, 3, 1), ref, 1e-4)


@pytest.mark.parametrize("impl", ["pallas", "winograd"])
def test_cached_kernel_weight_follows_the_weight(monkeypatch, impl):
    """Conv2d's rearranged weight (what the kernels read on the card) is
    reused while the weight is unchanged and recomputed after an in-place
    update, whether it bumps `_version` or goes through `.data` (which does
    not); the next output follows the new weight."""
    monkeypatch.setattr(TL, "_CONV_IMPL", impl)
    prepare = tconv.prepare_weight if impl == "pallas" else twino.prepare_weight
    torch.manual_seed(0)
    conv = TL.Conv2d(128, 128, 3, padding=1).eval().requires_grad_(False)
    x = torch.randn(1, 128, 6, 8)
    w = conv.weight
    first = conv.prepared_weight(impl)
    assert conv.prepared_weight(impl) is first
    torch.testing.assert_close(first, prepare(w), rtol=0, atol=0)
    with torch.no_grad():
        out0 = conv(x)
        w.mul_(0.5)  # bumps _version; no fetch of conv.weight
        halved = conv.prepared_weight(impl)
        torch.testing.assert_close(halved, prepare(w), rtol=0, atol=0)
        version = w._version
        conv.weight.data.add_(0.25)  # leaves _version as it is
        assert w._version == version
        shifted = conv.prepared_weight(impl)
        torch.testing.assert_close(shifted, prepare(w), rtol=0, atol=0)
        out1 = conv(x)
    assert not torch.allclose(out0, out1)
    ref = F.conv2d(x, w, conv.bias, padding=1)
    np.testing.assert_allclose(out1.numpy(), ref.numpy(), atol=1e-4, rtol=0)


def test_build_key_covers_every_header(tmp_path):
    """A kernel library's build directory changes with the bytes of its
    sources and of any header under csrc/, so a header edit rebuilds."""
    from marigold_tpu_torch.ops import cuda_build

    (tmp_path / "a.cu").write_bytes(b'#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_bytes(b"// v1\n")
    key = cuda_build.build_key(("a.cu",), tmp_path)
    assert cuda_build.build_key(("a.cu",), tmp_path) == key
    (tmp_path / "h.cuh").write_bytes(b"// v2\n")
    after_header = cuda_build.build_key(("a.cu",), tmp_path)
    assert after_header != key
    (tmp_path / "b.cuh").write_bytes(b"")
    assert cuda_build.build_key(("a.cu",), tmp_path) != after_header
    (tmp_path / "a.cu").write_bytes(b'#include "h.cuh"\n// edit\n')
    assert cuda_build.build_key(("a.cu",), tmp_path) not in (key, after_header)
    # the repository's own sources: the header enters every library's key
    assert "sm90.cuh" in {p.name for p in cuda_build.CSRC_DIR.glob("*.cuh")}
