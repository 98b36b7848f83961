"""Card-only tests of the port: the Hopper flash kernels (serving forward,
training forward with the logsumexp, dQ and dK/dV backward) against their
plain PyTorch versions, the wrappers' checks, the dispatch on CUDA tensors
with and without autograd, and the slice on the card against the CPU. They
skip without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from marigold_tpu_torch.ops import attention as TA
from marigold_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, b, n, c, dtype=torch.bfloat16):
    return [torch.randn((b, n, c), generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("softmax", ["shifted", "online"])
@pytest.mark.parametrize("b,n,c,heads", [
    (2, 1300, 320, 5),   # d=64, B > 1, ragged against the 64-row tiles
    (3, 1030, 640, 10),  # d=64, 10 heads
    (1, 1100, 512, 1),   # d=512, ragged against the 32-row tiles
    (1, 77, 64, 1),      # fewer rows than one tile
])
def test_kernel_matches_plain(cuda, b, n, c, heads, softmax):
    q, k, v = _qkv(cuda, b, n, c)
    key = f"{softmax}_d{c // heads}"
    before = fa.launches[key]
    out = fa.flash_attention(q, k, v, heads, softmax)
    assert fa.launches[key] == before + 1
    ref = fa.flash_attention_plain(q, k, v, heads, softmax)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    # bf16 output ulps: the chip_smoke.py tolerance
    tol = 1e-2 * ref.float().abs().max().item() + 1e-3
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 128, 64)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q.float(), k.float(), v.float(), 1)
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k.half(), v.half(), 1)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v, 2)  # d = 32
    nc = torch.randn((1, 64, 128), device="cuda").to(torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(nc, k, v, 1)


def test_dispatch_takes_the_kernel_only_for_long_self_attention(cuda):
    q, k, v = _qkv(cuda, 1, 1024, 128)
    before = sum(fa.launches.values())
    out = TA.dispatch_attention(q, k, v, 2)
    assert sum(fa.launches.values()) == before + 1
    ref = TA.xla_attention(q, k, v, 2)
    tol = 1e-2 * ref.float().abs().max().item() + 1e-3
    assert (out.float() - ref.float()).abs().max().item() <= tol
    short = [t[:, :1023] for t in (q, k, v)]
    TA.dispatch_attention(*short, 2)
    TA.dispatch_attention(q, k[:, :2], v[:, :2], 2)  # cross-attention
    assert sum(fa.launches.values()) == before + 1


def test_slice_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small model (sequences under 1024 tokens: no flash) in fp32 on the
    card and on the CPU, from one random checkpoint written and loaded
    through from_pretrained."""
    import numpy as np

    from marigold_tpu_torch import MarigoldDepthPipeline
    from marigold_tpu_torch.core.scheduler import DiffusionSchedule
    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
    from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    parts = [
        ("unet", UNet2DConditionModel, dataclasses.replace(
            UNetConfig(), block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            attention_head_dim=(2, 4), cross_attention_dim=32),
         "diffusion_pytorch_model.safetensors", ""),
        ("vae", AutoencoderKL, dataclasses.replace(
            VAEConfig(), block_out_channels=(32, 64), layers_per_block=1),
         "diffusion_pytorch_model.safetensors", ""),
        ("text_encoder", CLIPTextModel, dataclasses.replace(
            CLIPTextConfig(), hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2),
         "model.safetensors", "text_model."),
    ]
    gen = torch.Generator().manual_seed(0)
    for sub, cls, cfg, fname, prefix in parts:
        with torch.device("meta"):
            model = cls(cfg)
        W.save_component(cfg.to_dict(), W.random_state_dict(model, gen),
                         str(tmp_path / sub), fname, prefix)
    DiffusionSchedule.create().save_pretrained(str(tmp_path / "scheduler"))
    img = np.random.default_rng(0).integers(0, 256, (48, 40, 3), dtype=np.uint8)
    maps = []
    for device in ("cpu", "cuda"):
        pipe = MarigoldDepthPipeline.from_pretrained(
            str(tmp_path), dtype=torch.float32, device=device)
        noise = torch.randn((1, 4, 24, 20), generator=torch.Generator().manual_seed(1))
        pipe._noise = lambda n, h, w, seed, noise=noise, d=device: noise.to(d)
        maps.append(pipe(img, denoising_steps=2, processing_res=0,
                         color_map=None).depth_np)
    np.testing.assert_allclose(maps[1], maps[0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (2, 1300, 1300, 320, 5),  # ragged against the 64-row tiles, B > 1
    (1, 77, 200, 64, 1),      # fewer q rows than one tile, nq != nk
    (1, 1100, 700, 128, 2),   # nq > nk
])
def test_training_kernels_match_plain(cuda, b, nq, nk, c, heads):
    q, g = (torch.randn((b, nq, c), generator=cuda, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    k, v = (torch.randn((b, nk, c), generator=cuda, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    before = dict(fa.launches)
    out, lse = fa.flash_attention_lse(q, k, v, heads)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, heads)
    for key in ("lse_d64", "bwd_dq_d64", "bwd_dkv_d64"):
        assert fa.launches[key] == before.get(key, 0) + 1
    out_p, lse_p = fa.flash_attention_lse_plain(q, k, v, heads)
    refs = fa.flash_attention_bwd_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (b * heads, nq)
    # fp32 logsumexp summed in another order
    assert (lse - lse_p).abs().max().item() <= 1e-5 * lse_p.abs().max().item() + 1e-4
    # bf16 outputs; dS and P rounded to bf16 at the same places as plain:
    # the chip_smoke.py tolerances
    for got, ref in zip((out, *grads), (out_p, *refs)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        tol = 1e-2 * ref.float().abs().max().item() + 1e-5
        assert (got.float() - ref.float()).abs().max().item() <= tol


def test_raw_kernels_raise_under_grad(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, 1, 128, 64))
    with pytest.raises(RuntimeError, match="not differentiable"):
        fa.flash_attention(q, k, v, 1)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fa.flash_attention_lse(q, k, v, 1)
    with torch.no_grad():
        fa.flash_attention(q, k, v, 1)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_lse(*(t.detach()[..., :32].contiguous()
                                 for t in (q, k, v)), 1)


def test_unet_grads_through_dispatch_reach_to_q_and_match_plain(cuda, monkeypatch):
    """A small bf16 UNet on the card with 64-wide heads and a 1024-token
    level 0: with grad enabled the dispatch runs FlashAttentionFunction
    (the lse forward and both backward kernels), the to_q/to_k/to_v
    gradients of that attention are non-zero, and every gradient matches
    the same model on the plain attention path."""
    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

    cfg = dataclasses.replace(
        UNetConfig(), block_out_channels=(64, 128),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        attention_head_dim=(1, 2), cross_attention_dim=32, layers_per_block=1)
    with torch.device("meta"):
        model = UNet2DConditionModel(cfg)
    sd = W.random_state_dict(model, torch.Generator(device="cuda").manual_seed(0))
    unet = W.build_module(UNet2DConditionModel, cfg, sd, torch.bfloat16,
                          "cuda").requires_grad_(True)
    x = torch.randn((2, 8, 32, 32), generator=cuda, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((1, 2, 32), generator=cuda, device="cuda").to(torch.bfloat16)
    t = torch.tensor([10, 700], device="cuda")

    def grads():
        unet.zero_grad(set_to_none=True)
        out = unet(x, t, ctx).float()
        (out ** 2).mean().backward()
        return {n: p.grad.float() for n, p in unet.named_parameters()}

    before = dict(fa.launches)
    g_flash = grads()
    # level 0 (1024 tokens): down 1 + up 2 self-attentions
    for key in ("lse_d64", "bwd_dq_d64", "bwd_dkv_d64"):
        assert fa.launches[key] == before.get(key, 0) + 3
    attn = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    for proj in ("to_q", "to_k", "to_v"):
        assert g_flash[f"{attn}.{proj}.weight"].abs().max().item() > 0
    monkeypatch.setattr(TA, "FLASH_MIN_SEQ", 1 << 30)
    g_plain = grads()
    for n, ref in g_plain.items():
        # two bf16 models that round at different places: relative L2
        # distance per parameter
        err = (g_flash[n] - ref).norm().item()
        assert err <= 5e-2 * ref.norm().item() + 1e-6, n
