"""Card-only tests of the port: the Hopper flash kernels (serving forward,
training forward with the logsumexp, dQ and dK/dV backward, the folded
entry; every 64-wide forward is the wgmma/TMA kernel of
csrc/flash_fwd_sm90.cu, with 128-row query blocks and 128-key tiles, every
512-wide one that of csrc/flash_fwd_d512_sm90.cu, with 64-row query tiles
and 64-key tiles, and the backward pair that of csrc/flash_bwd_sm90.cu,
with 128-row output blocks and 64-row stages)
and the 3x3 conv kernels (nine-tap, Winograd), and the fp32 kernels of
`--full_precision` and fp32 training, all 3xTF32 (the forwards
csrc/flash_fwd_d64_f32_sm90.cu, with 128-row query blocks and 64-key
tiles, and csrc/flash_fwd_d512_f32_sm90.cu, the backward
csrc/flash_bwd_dq_f32_sm90.cu, with 128-row query blocks, and
csrc/flash_bwd_dkv_f32_sm90.cu, with their operand split
csrc/tf32_split.cu, and the convs csrc/conv3x3_f32_sm90.cu and
csrc/winograd_f32_sm90.cu), against
their plain PyTorch versions, the wrappers' checks, the dispatch on CUDA tensors with
and without autograd, and the slices on the card against the CPU: depth at
E=1 and E=3, normals and IID appearance at E=1, and bf16 normals and IID
requests through the flash kernels against plain attention, and the
command-line entry points on the card (run, and serve with two batches in
flight against one at a time), and eval's LPIPS on the card against the
CPU. They skip without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from marigold_tpu_torch.models import layers as TL
from marigold_tpu_torch.ops import attention as TA
from marigold_tpu_torch.ops import conv as tconv
from marigold_tpu_torch.ops import flash_attention as fa
from marigold_tpu_torch.ops import winograd as twino

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
@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (2, 1300, 1300, 320, 5),   # d=64, B > 1, ragged against the 64-row tiles
    (3, 1030, 1030, 640, 10),  # d=64, 10 heads
    (1, 77, 77, 64, 1),        # fewer rows than one tile
    (1, 129, 129, 64, 1),      # d=64: one key past a 128-key tile
    (1, 1025, 1025, 128, 2),   # d=64: one key past 8 tiles, two heads
    (10, 2304, 2304, 640, 10),  # d=64: the E=10 rows at UNet level 1
    (3, 1100, 700, 512, 1),    # d=512: nq > nk, ragged against 64, B = 3
    (1, 1100, 1300, 512, 1),   # d=512: nq < nk
    (2, 77, 130, 512, 1),      # d=512: fewer query rows than one tile
    (10, 2304, 2304, 512, 1),  # d=512: B = 10 rows of a decoder chunk
])
def test_kernel_matches_plain(cuda, b, nq, nk, c, heads, softmax):
    q = torch.randn((b, nq, c), generator=cuda, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, nk, c), generator=cuda, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
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


def test_check_tma_raises_on_a_512_wide_row_stride(cuda):
    """A 512-wide head read out of rows of 516 channels (1032 bytes, not a
    multiple of 16): the TMA maps cannot take it."""
    wide = torch.zeros((1, 64, 516), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="row stride of 1032 bytes"):
        fa.check_tma({"q": wide[..., :512]})
    fa.check_tma({"q": wide[..., :512].contiguous()})


def test_shifted_kernel_clamps_a_spiky_key(cuda):
    """One key column 200x larger, missed by the shift's stride-4 subsample
    (tests/test_flash_attention.py's spiky-K case): exp(min(s - shift, 75))
    engages the clamp, and the kernel clamps as the plain version does."""
    q, k, v = _qkv(cuda, 1, 512, 64)
    k[0, 137] *= 200.0
    before = fa.launches["shifted_d64"]
    out = fa.flash_attention(q, k, v, 1, "shifted")
    assert fa.launches["shifted_d64"] == before + 1
    ref = fa.flash_attention_plain(q, k, v, 1, "shifted")
    torch.cuda.synchronize()
    s = (q[0].float() @ k[0].float().T) / 8.0
    assert (s - fa.row_shift(q, k, 1)[0][:, None]).max().item() > fa.EXP_CLAMP
    assert bool(torch.isfinite(out.float()).all())
    tol = 1e-2 * ref.float().abs().max().item() + 1e-3
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 128, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k.half(), v.half(), 1)
    with pytest.raises(ValueError):
        fa.flash_attention_lse(q.half(), k.half(), v.half(), 1)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v, 2)  # d = 32
    nc = torch.randn((1, 64, 128), device="cuda").to(torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(nc, k, v, 1)
    flat = torch.zeros(128 * 64 + 8, device="cuda", dtype=torch.bfloat16)
    off = flat[1:1 + 128 * 64].view(1, 128, 64)  # 2 bytes past 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(off, k, v, 1)
    with pytest.raises(ValueError, match="no rows"):
        fa.flash_attention(q[:, :0], k[:, :0], v[:, :0], 1)


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


def _small_checkpoint(root, in_ch=8, out_ch=4):
    """A small random checkpoint (sequences under 1024 tokens: no flash)
    written through the port's own writer; in_ch/out_ch set the UNet's
    conv_in and conv_out (IID: 4 * (n + 1) and 4 * n)."""
    from marigold_tpu_torch.core.scheduler import DiffusionSchedule
    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
    from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    parts = [
        ("unet", UNet2DConditionModel, dataclasses.replace(
            UNetConfig(), in_channels=in_ch, out_channels=out_ch,
            block_out_channels=(32, 64),
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
                         str(root / sub), fname, prefix)
    DiffusionSchedule.create().save_pretrained(str(root / "scheduler"))


def test_slice_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small model in fp32 on the card and on the CPU, from one random
    checkpoint written and loaded through from_pretrained."""
    import numpy as np

    from marigold_tpu_torch import MarigoldDepthPipeline

    _small_checkpoint(tmp_path)
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


def test_ensemble_request_on_the_card_matches_the_cpu(cuda, tmp_path):
    """E=3 through __call__ and batch_call in fp32 on the card and on the
    CPU: the device solve on each. The members start from correlated noise
    (a shared draw plus an independent one), as a trained model's members
    are correlated; the maps then agree to 1e-3 (float32 rounding through
    up to 50 BFGS iterations and the renormalization)."""
    import numpy as np

    from marigold_tpu_torch import MarigoldDepthPipeline

    _small_checkpoint(tmp_path)
    img = np.random.default_rng(0).integers(0, 256, (48, 40, 3), dtype=np.uint8)
    gen = torch.Generator().manual_seed(2)
    shared = torch.randn((1, 4, 24, 20), generator=gen)
    noise = 0.95 * shared + 0.3 * torch.randn((6, 4, 24, 20), generator=gen)
    out = {}
    for device in ("cpu", "cuda"):
        pipe = MarigoldDepthPipeline.from_pretrained(
            str(tmp_path), dtype=torch.float32, device=device)
        pipe._noise = lambda n, h, w, seed, d=device: noise[:n].to(d)
        one = pipe(img, denoising_steps=2, ensemble_size=3, processing_res=0,
                   color_map=None)
        two = pipe.batch_call([img, img], denoising_steps=2, ensemble_size=3,
                              processing_res=0)
        out[device] = [one] + two
    for got, ref in zip(out["cuda"], out["cpu"]):
        assert got.uncertainty.shape == got.depth_np.shape == (48, 40)
        assert np.isfinite(got.uncertainty).all() and got.uncertainty.min() >= 0
        np.testing.assert_allclose(got.depth_np, ref.depth_np, atol=1e-3, rtol=0)
        np.testing.assert_allclose(got.uncertainty, ref.uncertainty, atol=1e-3,
                                   rtol=0)


def _modality(mode, root, **kw):
    """The normals or IID-appearance pipeline on the checkpoint at root."""
    from marigold_tpu_torch import MarigoldIIDPipeline, MarigoldNormalsPipeline

    cls = MarigoldNormalsPipeline if mode == "normals" else MarigoldIIDPipeline
    return cls.from_pretrained(str(root), **kw)


def _maps(mode, out):
    """The output's maps as one [H, W, C] array."""
    import numpy as np

    if mode == "normals":
        return out.normals_np
    return np.concatenate([np.moveaxis(e.array, 0, -1) for e in out], -1)


@pytest.mark.parametrize("mode,n_targets", [("normals", 1), ("iid", 2)])
def test_modality_on_the_card_matches_the_cpu(cuda, tmp_path, mode, n_targets):
    """Normals and IID appearance (two targets, each decoded by its own VAE
    call) in fp32 on the card and on the CPU, from one random checkpoint and
    one noise: the maps agree to 1e-4, as depth's do."""
    import numpy as np

    _small_checkpoint(tmp_path, 4 * (n_targets + 1), 4 * n_targets)
    img = np.random.default_rng(0).integers(0, 256, (48, 40, 3), dtype=np.uint8)
    noise = torch.randn((1, 4 * n_targets, 24, 20),
                        generator=torch.Generator().manual_seed(1))
    maps = []
    for device in ("cpu", "cuda"):
        pipe = _modality(mode, tmp_path, dtype=torch.float32, device=device)
        assert pipe.n_targets == n_targets
        pipe._noise = lambda n, h, w, seed, d=device: noise.to(d)
        maps.append(_maps(mode, pipe(img, denoising_steps=2, processing_res=0)))
    assert maps[1].shape == (48, 40, 3 * n_targets)
    np.testing.assert_allclose(maps[1], maps[0], atol=1e-4, rtol=0)


def _narrow_checkpoint(root, in_ch, out_ch):
    """A narrow random checkpoint whose 256 px requests reach both flash
    kernels: the VAE downsamples by 8 with a 512-wide last level (its mid
    attention: one 512-wide head over 32x32 = 1024 latent tokens) and the
    UNet's level 0 has one 64-wide head over the same 1024 tokens."""
    from marigold_tpu_torch.core.scheduler import DiffusionSchedule
    from marigold_tpu_torch.models import weights as W
    from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
    from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    parts = [
        ("unet", UNet2DConditionModel, dataclasses.replace(
            UNetConfig(), in_channels=in_ch, out_channels=out_ch,
            block_out_channels=(64, 128),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            attention_head_dim=(1, 2), cross_attention_dim=32,
            layers_per_block=1),
         "diffusion_pytorch_model.safetensors", ""),
        ("vae", AutoencoderKL, dataclasses.replace(
            VAEConfig(), block_out_channels=(32, 64, 128, 512),
            layers_per_block=1), "diffusion_pytorch_model.safetensors", ""),
        ("text_encoder", CLIPTextModel, dataclasses.replace(
            CLIPTextConfig(), hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2),
         "model.safetensors", "text_model."),
    ]
    gen = torch.Generator().manual_seed(3)
    for sub, cls, cfg, fname, prefix in parts:
        with torch.device("meta"):
            model = cls(cfg)
        W.save_component(cfg.to_dict(), W.random_state_dict(model, gen),
                         str(root / sub), fname, prefix)
    DiffusionSchedule.create().save_pretrained(str(root / "scheduler"))


# A bf16 normals or IID map through the flash kernels against the same
# request on plain attention: both run the bf16 model, so the maps differ by
# bf16 rounding carried through 4 steps and the decoder (as chip_smoke.py's
# DEPTH_TOL bounds for depth). Measured on an H100 for this model and image
# (the test prints its numbers under pytest -s):
# IID max |diff| 4.5e-2, mean 2.9e-3 (bf16 steps near 1 are 3.9e-3, and
# IID channels are not averaged as depth's three are); normals median angle
# 0.99 deg and 0.34% of pixels more than 10 deg apart (a normal decoded near
# zero length turns far on a small change before its renormalization).
# Held at about twice (IID), three and six times (normals) those.
IID_TOL = (1e-1, 1e-2)  # max, mean |diff| of the [H, W, 3n] maps
NORMALS_TOL = (3.0, 0.02)  # median angle in degrees, share of pixels > 10 deg


@pytest.mark.parametrize("mode,n_targets", [("normals", 1), ("iid", 2)])
def test_bf16_modality_through_the_flash_kernels(cuda, tmp_path, monkeypatch,
                                                mode, n_targets):
    """A bf16 256 px request on the narrow model: 3 d=64 launches per UNet
    forward (level 0: one down and two up self-attentions), one d=512 launch
    in the encoder and one per decoded target group; the map within
    IID_TOL or NORMALS_TOL of the plain-attention request's."""
    import numpy as np

    _narrow_checkpoint(tmp_path, 4 * (n_targets + 1), 4 * n_targets)
    pipe = _modality(mode, tmp_path, dtype=torch.bfloat16, device="cuda")
    img = np.random.default_rng(1).integers(0, 256, (256, 256, 3), dtype=np.uint8)
    steps = 4

    def request():
        return _maps(mode, pipe(img, denoising_steps=steps, processing_res=256,
                                seed=0))

    before = dict(fa.launches)
    got = request()
    delta = {k: n - before.get(k, 0) for k, n in fa.launches.items()
             if n != before.get(k, 0)}
    assert delta == {"shifted_d64": 3 * steps, "shifted_d512": 1 + n_targets}
    monkeypatch.setattr(TA, "FLASH_MIN_SEQ", 1 << 30)
    ref = request()
    assert got.shape == (256, 256, 3 * n_targets) and np.isfinite(got).all()
    diff = np.abs(got - ref)
    print(f"{mode} bf16 kernels vs plain: max |diff| {diff.max():.3e}, mean "
          f"{diff.mean():.3e}")  # shown by pytest -s
    if mode == "normals":
        deg = np.degrees(np.arccos(np.clip((got * ref).sum(-1), -1.0, 1.0)))
        stats = (np.median(deg), (deg > 10.0).mean())
        print(f"normals median angle {stats[0]:.3f} deg, "
              f"{100 * stats[1]:.2f}% of pixels over 10 deg")
        assert stats[0] <= NORMALS_TOL[0] and stats[1] <= NORMALS_TOL[1], stats
    else:
        assert diff.max() <= IID_TOL[0] and diff.mean() <= IID_TOL[1], \
            (diff.max(), diff.mean())


def _cli_images(folder, n, hw=(256, 256)):
    import numpy as np
    from PIL import Image

    folder.mkdir()
    rng = np.random.default_rng(4)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(
            folder / f"img{i}.png")


def test_run_cli_on_the_card(cuda, tmp_path):
    """run --modality depth on the card by default, bf16, with its files
    checked and the flash launches exact (3 d=64 per UNet forward, one
    d=512 launch in the encoder and one in the decoder per image); then
    --full_precision: fp32 maps, finite, in [0, 1], of the input's shape,
    through the fp32 kernels with the same launch counts."""
    import numpy as np
    from PIL import Image

    from marigold_tpu_torch.cli.run import main

    ckpt = tmp_path / "ckpt"
    _narrow_checkpoint(ckpt, 8, 4)
    _cli_images(tmp_path / "in", 2)
    steps = 4
    argv = ["--checkpoint", str(ckpt), "--input_rgb_dir", str(tmp_path / "in"),
            "--denoise_steps", str(steps), "--processing_res", "256",
            "--seed", "0"]
    before = dict(fa.launches)
    assert main(argv + ["--output_dir", str(tmp_path / "out")]) == 0
    delta = {k: n - before.get(k, 0) for k, n in fa.launches.items()
             if n != before.get(k, 0)}
    assert delta == {"shifted_d64": 2 * 3 * steps, "shifted_d512": 2 * 2}
    for i in range(2):
        depth = np.load(tmp_path / "out" / "depth_npy" / f"img{i}_pred.npy")
        assert depth.shape == (256, 256) and np.isfinite(depth).all()
        assert 0.0 <= depth.min() and depth.max() <= 1.0
        bw = np.asarray(Image.open(tmp_path / "out" / f"img{i}_depth_bw.png"))
        assert bw.dtype == np.uint16 and bw.shape == (256, 256)
        colored = Image.open(tmp_path / "out" / f"img{i}_depth_colored.png")
        assert colored.mode == "RGB" and colored.size == (256, 256)
    before = dict(fa.launches_f32)
    assert main(argv + ["--output_dir", str(tmp_path / "fp32"),
                        "--full_precision"]) == 0
    delta = {k: n - before.get(k, 0) for k, n in fa.launches_f32.items()
             if n != before.get(k, 0)}
    # each fp32 forward, of either head width, runs after one operand split
    assert delta == {"shifted_d64": 2 * 3 * steps, "shifted_d512": 2 * 2,
                     "tf32_split": 2 * 3 * steps + 2 * 2}
    assert not torch.backends.cudnn.allow_tf32
    for i in range(2):
        depth = np.load(tmp_path / "fp32" / "depth_npy" / f"img{i}_pred.npy")
        assert depth.shape == (256, 256) and np.isfinite(depth).all()
        assert 0.0 <= depth.min() and depth.max() <= 1.0


def test_serve_batches_in_flight_match_one_at_a_time(cuda, tmp_path):
    """serve --once with two batches in flight (each on its own CUDA stream)
    writes the maps that one batch at a time writes, to the bit: each batch
    draws its noise from its own generator."""
    import numpy as np

    from marigold_tpu_torch.cli.serve import main

    ckpt = tmp_path / "ckpt"
    _narrow_checkpoint(ckpt, 8, 4)
    _cli_images(tmp_path / "watch", 6)
    maps = {}
    for in_flight in (2, 1):
        out = tmp_path / f"out{in_flight}"
        before = dict(fa.launches)
        assert main(["--checkpoint", str(ckpt), "--watch_dir",
                     str(tmp_path / "watch"), "--output_dir", str(out),
                     "--once", "--batch_images", "2", "--ensemble_size", "3",
                     "--denoise_steps", "2", "--processing_res", "256",
                     "--max_in_flight", str(in_flight), "--poll_interval",
                     "0.05", "--seed", "3"]) == 0
        assert fa.launches["shifted_d64"] - before.get("shifted_d64", 0) == \
            3 * 3 * 2
        maps[in_flight] = [np.load(out / "depth_npy" / f"img{i}_pred.npy")
                           for i in range(6)]
    for a, b in zip(maps[2], maps[1]):
        assert a.shape == (256, 256) and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


def test_lpips_on_the_card_matches_the_cpu(cuda, tmp_path):
    """LPIPS on the card (its default device) gives the CPU's metric within
    1e-5 on one random weight file, with cuDNN's TF32 allowed by the
    caller: the metric's convolutions run in full fp32."""
    import os
    import sys

    import numpy as np

    from marigold_tpu_torch.eval.lpips import get_lpips

    scripts = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts")
    sys.path.insert(0, scripts)
    try:
        from export_lpips_weights import random_init_flat
    finally:
        sys.path.pop(0)
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **random_init_flat(seed=3))
    rng = np.random.default_rng(4)
    a, b = (rng.random((96, 128, 3)).astype(np.float32) for _ in range(2))
    on_card, on_cpu = get_lpips(path), get_lpips(path, "cpu")
    assert on_card.params["lins"][0].device.type == "cuda"
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = [on_card(x, y) for x, y in ((a, b), (b, a), (a, a))]
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ref = [on_cpu(x, y) for x, y in ((a, b), (b, a), (a, a))]
    assert got[0] > 0 and got[2] == 0.0
    for g, r in zip(got, ref):
        assert abs(g - r) <= 1e-5


def _conv_inputs(gen, b, c, h, w, k):
    x = torch.randn((b, c, h, w), generator=gen, device="cuda").to(torch.bfloat16)
    wt = (0.05 * torch.randn((k, c, 3, 3), generator=gen, device="cuda")
          ).to(torch.bfloat16)
    bias = torch.randn((k,), generator=gen, device="cuda").to(torch.bfloat16)
    return x, wt, bias


@pytest.mark.parametrize("kernel", ["conv3x3", "winograd"])
@pytest.mark.parametrize("b,c,h,w,k", [
    (2, 128, 12, 12, 128),   # narrower than one 16-wide tile
    (1, 256, 10, 34, 384),   # ragged against the tiles in H and W
    (3, 640, 24, 24, 640),   # a UNet level
    (1, 2560, 6, 8, 1280),   # the widest skip input
    (10, 2560, 12, 12, 1280),  # W = 12 at B = 10: the small grid
    (3, 256, 22, 46, 256),   # box and tile counts not multiples of a block
    (1, 128, 768, 768, 128),  # the 768 px VAE level at batch 1
    (2, 512, 16, 48, 640),   # H != W, K not a multiple of 256
])
def test_conv_kernels_match_plain(cuda, kernel, b, c, h, w, k):
    x, wt, bias = _conv_inputs(cuda, b, c, h, w, k)
    fn, plain, counter = {
        "conv3x3": (tconv.conv3x3, tconv.conv3x3_plain, tconv.launches),
        "winograd": (twino.winograd3x3, twino.winograd3x3_plain, twino.launches),
    }[kernel]
    before = counter[kernel]
    out = fn(x, wt, bias)
    assert counter[kernel] == before + 1
    ref = plain(x, wt, bias)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (b, k, h, w)
    # fp32 sums in another order, bf16 output: the chip_smoke.py tolerance
    tol = 1e-2 * ref.float().abs().max().item() + 1e-3
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_conv3x3_odd_pixel_count(cuda):
    """H * W odd: the NHWC copy takes its scalar path (Winograd takes even H
    and W only)."""
    x, wt, bias = _conv_inputs(cuda, 2, 128, 9, 13, 256)
    out = tconv.conv3x3(x, wt, bias)
    ref = tconv.conv3x3_plain(x, wt, bias)
    torch.cuda.synchronize()
    tol = 1e-2 * ref.float().abs().max().item() + 1e-3
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_conv_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, wt, bias = _conv_inputs(cuda, 1, 128, 8, 8, 128)
    for fn in (tconv.conv3x3, twino.winograd3x3):
        with pytest.raises(ValueError, match="x is torch.float32"):
            fn(x.float(), wt, bias)
        with pytest.raises(ValueError, match="kernels take"):
            fn(x.half(), wt.half(), bias.half())
        with pytest.raises(ValueError, match="prepared weight"):
            fn(x.float(), wt.float(), bias.float(), prepared=tconv.taps(wt))
        with pytest.raises(ValueError, match="gated"):
            fn(x[:, :64].contiguous(), wt[:, :64].contiguous(), bias)
        with pytest.raises(RuntimeError, match="KernelConvFunction"):
            fn(x, wt.requires_grad_(), bias)
        wt.requires_grad_(False)
        with pytest.raises(ValueError, match="prepared weight"):
            fn(x, wt, bias, prepared=torch.zeros((3, 128, 128), device="cuda",
                                                 dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="even"):
        twino.winograd3x3(x[:, :, :7].contiguous(), wt, bias)


@pytest.mark.parametrize("impl", ["pallas", "winograd"])
def test_conv_dispatch_on_the_card(cuda, monkeypatch, impl):
    """Conv2d under a kernel mode: the kernel without grad, and
    KernelConvFunction (plain conv gradients) with grad."""
    monkeypatch.setattr(TL, "_CONV_IMPL", impl)
    conv = TL.Conv2d(256, 128, 3, padding=1).to("cuda", torch.bfloat16)
    x = torch.randn((2, 256, 16, 20), device="cuda").to(torch.bfloat16)
    counter, key = ((tconv.launches, "conv3x3") if impl == "pallas"
                    else (twino.launches, "winograd"))
    before = counter[key]
    with torch.no_grad():
        out = conv(x)
    ref = torch.nn.functional.conv2d(x.float(), conv.weight.float(),
                                     conv.bias.float(), padding=1)
    tol = 4e-2 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    xg = x.detach().requires_grad_()
    (conv(xg).float().sum()).backward()
    assert counter[key] == before + 2
    assert xg.grad is not None and conv.weight.grad is not None
    # without grad the kernel reads the cached rearranged weight, which
    # follows a write through .data
    with torch.no_grad():
        first = conv(x)
        conv.weight.data.mul_(-1.0)
        second = conv(x)
    bias = conv.bias.float().reshape(1, -1, 1, 1)
    torch.testing.assert_close(second.float() - bias, -(first.float() - bias),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("bh,n,d", [(5, 1030, 64), (2, 77, 64), (1, 600, 512),
                                    (3, 1100, 512)])
def test_folded_flash_matches_plain(cuda, bh, n, d):
    q, k, v = _qkv(cuda, bh, n, d)
    before = fa.launches[f"folded_d{d}"]
    out = fa.flash_attention_folded(q, k, v)
    assert fa.launches[f"folded_d{d}"] == before + 1
    ref = fa.flash_attention_plain(q, k, v, 1, "online")
    torch.cuda.synchronize()
    tol = 1e-2 * ref.float().abs().max().item() + 1e-3
    assert (out.float() - ref.float()).abs().max().item() <= tol
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention_folded(*_qkv(cuda, 1, 64, 32))


# The fp32 kernels (`--full_precision`) against their plain fp32 versions,
# TF32 off for both: fp32 sums in another order, so a few fp32 ulps of the
# largest output (the chip_smoke.py tolerance, 1e-4 * max|ref| + 1e-6).
F32_TOL_REL, F32_TOL_ABS = 1e-4, 1e-6


def _f32_close(out, ref):
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    tol = F32_TOL_REL * ref.abs().max().item() + F32_TOL_ABS
    assert (out - ref).abs().max().item() <= tol


def _f32_launched(before: dict) -> dict:
    return {key: n - before.get(key, 0) for key, n in fa.launches_f32.items()
            if n != before.get(key, 0)}


@pytest.mark.parametrize("softmax", ["shifted", "online"])
@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (2, 1300, 1300, 320, 5),   # d=64, B > 1, ragged against the 128-row blocks
    (1, 77, 130, 64, 1),       # d=64, fewer rows than one block, nq != nk
    (1, 127, 129, 128, 2),     # d=64: a row short of a block, a key past two tiles
    (2, 129, 128, 64, 1),      # d=64: a row past a block, two whole key tiles
    (3, 1100, 700, 512, 1),    # d=512: nq > nk, ragged against 64 and 8, B = 3
    (1, 33, 1300, 512, 1),     # d=512: fewer rows than one 64-row tile
])
def test_f32_kernel_matches_plain(cuda, b, nq, nk, c, heads, softmax):
    """Each fp32 forward: one operand split, then the 3xTF32 kernel of its
    head width (csrc/flash_fwd_d64_f32_sm90.cu, csrc/flash_fwd_d512_f32_sm90.cu)."""
    q = torch.randn((b, nq, c), generator=cuda, device="cuda")
    k, v = (torch.randn((b, nk, c), generator=cuda, device="cuda")
            for _ in range(2))
    key = f"{softmax}_d{c // heads}"
    before, bf16 = dict(fa.launches_f32), sum(fa.launches.values())
    out = fa.flash_attention(q, k, v, heads, softmax)
    assert _f32_launched(before) == {key: 1, "tf32_split": 1}
    assert sum(fa.launches.values()) == bf16
    _f32_close(out, fa.flash_attention_plain(q, k, v, heads, softmax))


@pytest.mark.parametrize("softmax", ["shifted", "online"])
@pytest.mark.parametrize("b,nq,nk", [
    (2, 1100, 1100),    # ragged against the 64-row and 64-key tiles
    (1, 2784, 2780),    # the 768 px latent of a 375x1242 image; nk % 8 = 4
])
def test_f32_d512_forward_on_tf32x3(cuda, b, nq, nk, softmax):
    """The 512-wide fp32 forward: one operand split, then the 3xTF32 wgmma
    kernel (csrc/flash_fwd_d512_f32_sm90.cu), at the fp32 tolerance."""
    q = torch.randn((b, nq, 512), generator=cuda, device="cuda")
    k, v = (torch.randn((b, nk, 512), generator=cuda, device="cuda")
            for _ in range(2))
    before = dict(fa.launches_f32)
    out = fa.flash_attention(q, k, v, 1, softmax)
    got = {key: n - before.get(key, 0) for key, n in fa.launches_f32.items()
           if n != before.get(key, 0)}
    assert got == {f"{softmax}_d512": 1, "tf32_split": 1}
    _f32_close(out, fa.flash_attention_plain(q, k, v, 1, softmax))


@pytest.mark.parametrize("b,nq,nk", [(2, 1000, 1300), (1, 77, 130)])
def test_tf32_split_matches_plain(cuda, b, nq, nk):
    """csrc/tf32_split.cu against its plain version, bit for bit, at the
    fp32 backward's seven jobs (split_bwd_f32): rows in their own layout
    and transposed ones, N ragged against 8 and 32."""
    q, g = (torch.randn((b, nq, 320), generator=cuda, device="cuda") * 10
            for _ in range(2))
    k, v = (torch.randn((b, nk, 320), generator=cuda, device="cuda") * 1e-3
            for _ in range(2))
    got = fa.split_bwd_f32(q, k, v, g)
    want = ([fa.split_tf32_plain(x) for x in (q, g, k, v)]
            + [fa.split_tf32_plain(fa.transpose_tf32_plain(x))
               for x in (q, g, k)])
    assert len(got) == 7
    torch.cuda.synchronize()
    for pair, ref in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(pair, ref))


def test_f32_dkv_on_tf32x3_ragged(cuda):
    """fp32 dK/dV by the 3xTF32 kernel (csrc/flash_bwd_dkv_f32_sm90.cu)
    after its split, nq and nk ragged against 64, 128 and 8, against the
    plain backward; two calls give the same bits."""
    b, nq, nk, c, heads = 2, 1300, 1100, 320, 5
    q, g = (torch.randn((b, nq, c), generator=cuda, device="cuda")
            for _ in range(2))
    k, v = (torch.randn((b, nk, c), generator=cuda, device="cuda")
            for _ in range(2))
    out, lse = fa.flash_attention_lse(q, k, v, heads)
    lse_p, delta_p = fa.bwd_stats(out, lse, g, heads)
    before = dict(fa.launches_f32)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse_p, delta_p, heads)
    assert _f32_launched(before) == {"bwd_dkv_d64": 1, "tf32_split": 1}
    _, dk_ref, dv_ref = fa.flash_attention_bwd_plain(q, k, v, g, heads)
    _f32_close(dk, dk_ref)
    _f32_close(dv, dv_ref)
    again = fa.flash_attention_bwd_dkv(q, k, v, g, lse_p, delta_p, heads)
    torch.cuda.synchronize()
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)


@pytest.mark.parametrize("bh,n,d", [(5, 1030, 64), (3, 700, 512)])
def test_f32_folded_flash_matches_plain(cuda, bh, n, d):
    q, k, v = _qkv(cuda, bh, n, d, torch.float32)
    before = dict(fa.launches_f32)
    out = fa.flash_attention_folded(q, k, v)
    assert _f32_launched(before) == {f"folded_d{d}": 1, "tf32_split": 1}
    _f32_close(out, fa.flash_attention_plain(q, k, v, 1, "online"))


# one split before the lse forward, one for the whole backward
F32_TRAIN_LAUNCHES = {"lse_d64": 1, "bwd_dq_d64": 1, "bwd_dkv_d64": 1,
                      "tf32_split": 2}


@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (1, 128, 128, 64, 1),     # one whole 128-row block, two key tiles
    (1, 65, 127, 128, 2),     # a row past a 64-row stage, a key short of two
    (1, 127, 129, 128, 2),    # a row short of a block, a key past two tiles
    (2, 129, 128, 64, 1),     # a row past a block
    (2, 1300, 1100, 320, 5),  # ragged, B > 1, nq > nk
])
def test_f32_training_kernels_match_plain(cuda, b, nq, nk, c, heads):
    """The fp32 lse forward (csrc/flash_fwd_d64_f32_sm90.cu) and the dQ and
    dK/dV kernels (csrc/flash_bwd_dq_f32_sm90.cu,
    csrc/flash_bwd_dkv_f32_sm90.cu) against their plain versions, fp32
    launches counted (each with its operand splits) and no bf16 kernel
    launched, two backward calls bit-identical; then FlashAttentionFunction
    on fp32 leaves, through the same three kernels."""
    q, g = (torch.randn((b, nq, c), generator=cuda, device="cuda")
            for _ in range(2))
    k, v = (torch.randn((b, nk, c), generator=cuda, device="cuda")
            for _ in range(2))
    before, bf16 = dict(fa.launches_f32), sum(fa.launches.values())
    out, lse = fa.flash_attention_lse(q, k, v, heads)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, heads)
    assert _f32_launched(before) == F32_TRAIN_LAUNCHES
    out_p, lse_p = fa.flash_attention_lse_plain(q, k, v, heads)
    refs = fa.flash_attention_bwd_plain(q, k, v, g, heads)
    assert lse.dtype == torch.float32 and lse.shape == (b * heads, nq)
    for got, ref in zip((out, lse, *grads), (out_p, lse_p, *refs)):
        assert got.shape == ref.shape
        _f32_close(got, ref)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, heads)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(grads, again))

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = dict(fa.launches_f32)
    out_f = fa.FlashAttentionFunction.apply(*leaves, heads, "shifted")
    out_f.backward(g)
    assert _f32_launched(before) == F32_TRAIN_LAUNCHES
    assert sum(fa.launches.values()) == bf16
    _f32_close(out_f.detach(), out_p)
    for leaf, ref in zip(leaves, refs):
        _f32_close(leaf.grad, ref)


@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (1, 64, 100, 64, 1),      # a whole 64-row stage: no padding
    (2, 129, 128, 128, 2),    # 63 padded rows, past the first 128-row block
    (1, 1300, 1100, 320, 5),  # the last block's rows run past the padding
])
def test_f32_dq_writes_the_padded_statistics(cuda, b, nq, nk, c, heads):
    """The fp32 dQ kernel's delta and padded lse and delta rows, which the
    dK/dV kernel reads, against bwd_stats: lse bit for bit (LSE_PAD past
    nq), delta at the fp32 tolerance (0 past nq); dQ against the plain
    backward."""
    q, g = (torch.randn((b, nq, c), generator=cuda, device="cuda")
            for _ in range(2))
    k, v = (torch.randn((b, nk, c), generator=cuda, device="cuda")
            for _ in range(2))
    out, lse = fa.flash_attention_lse(q, k, v, heads)
    before = dict(fa.launches_f32)
    dq, lse_p, delta_p = fa.flash_attention_bwd_dq_f32(q, k, v, out, lse, g,
                                                       heads)
    assert _f32_launched(before) == {"bwd_dq_d64": 1, "tf32_split": 1}
    lse_ref, delta_ref = fa.bwd_stats(out, lse, g, heads)
    assert lse_p.shape == lse_ref.shape == (b * heads, -(-nq // 64) * 64)
    assert torch.equal(lse_p, lse_ref)
    _f32_close(delta_p, delta_ref)
    assert bool((delta_p[:, nq:] == 0).all())
    _f32_close(dq, fa.flash_attention_bwd_plain(q, k, v, g, heads)[0])


def _conv_inputs_f32(gen, b, c, h, w, k):
    """fp32 draws: their tf32 lo parts are not zero, as bf16 values' are."""
    return (torch.randn((b, c, h, w), generator=gen, device="cuda"),
            torch.randn((k, c, 3, 3), generator=gen, device="cuda")
            / (3 * c ** 0.5),
            torch.randn((k,), generator=gen, device="cuda"))


@pytest.mark.parametrize("kernel", ["conv3x3", "winograd"])
@pytest.mark.parametrize("b,c,h,w,k", [
    (2, 128, 12, 12, 128),   # narrower than one 64-pixel tile
    (1, 256, 10, 34, 384),   # ragged against the tiles
    (3, 640, 24, 24, 640),   # a UNet level
    (1, 128, 96, 96, 256),   # a VAE level
    (10, 2560, 12, 12, 1280),  # the longest reduction (unet_2560_1280)
    (1, 1920, 24, 24, 640),  # a decoder concat level, one image
])
def test_f32_conv_kernels_match_plain(cuda, kernel, b, c, h, w, k):
    x, wt, bias = _conv_inputs_f32(cuda, b, c, h, w, k)
    fn, plain, counter = {
        "conv3x3": (tconv.conv3x3, tconv.conv3x3_plain, tconv.launches_f32),
        "winograd": (twino.winograd3x3, twino.winograd3x3_plain,
                     twino.launches_f32),
    }[kernel]
    before = dict(counter)
    out = fn(x, wt, bias)
    want = {kernel: 1, **({"conv3x3_split": 1} if kernel == "conv3x3" else {})}
    assert {key: n - before.get(key, 0) for key, n in counter.items()
            if n != before.get(key, 0)} == want
    assert out.shape == (b, k, h, w)
    _f32_close(out, plain(x, wt, bias))


def test_f32_conv_wrappers_raise_on_an_unsplit_prepared_weight(cuda):
    """The fp32 kernels read the split weight [2, ...]: the bare taps or
    filter transform of an fp32 weight raise, as does bf16's."""
    x, wt, bias = _conv_inputs_f32(cuda, 1, 128, 8, 8, 128)
    for fn, prepare in ((tconv.conv3x3, tconv.taps),
                        (twino.winograd3x3, twino.filter_transform)):
        with pytest.raises(ValueError, match="prepared weight"):
            fn(x, wt, bias, prepared=prepare(wt))
        with pytest.raises(ValueError, match="prepared weight"):
            fn(x, wt, bias, prepared=prepare(wt).bfloat16())


@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (2, 1300, 1300, 320, 5),  # ragged against the 64-row tiles, B > 1
    (1, 77, 200, 64, 1),      # fewer q rows than one tile, nq != nk
    (1, 1100, 700, 128, 2),   # nq > nk
    (1, 1000, 1300, 128, 2),  # nq < nk, both ragged against 128
    (2, 4800, 4800, 320, 5),  # the training shape at level 0
    (2, 1200, 1200, 640, 10),  # level 1: B*H = 20
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


def test_backward_gives_the_same_bits_twice(cuda):
    """The backward kernels use no atomics: one block owns each output
    tile, so two calls on the same inputs give bit-identical gradients."""
    q, g = _qkv(cuda, 2, 1300, 320)[:2]
    k, v = _qkv(cuda, 2, 1100, 320)[:2]
    out, lse = fa.flash_attention_lse(q, k, v, 5)
    first = fa.flash_attention_bwd(q, k, v, out, lse, g, 5)
    second = fa.flash_attention_bwd(q, k, v, out, lse, g, 5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_backward_raises_on_what_tma_does_not_take(cuda):
    """dO read out of rows of 68 channels (136 bytes, not a multiple of 16):
    the backward's TMA maps cannot take it, and the wrapper raises rather
    than copy it into shape."""
    q, k, v = _qkv(cuda, 1, 128, 64)
    out, lse = fa.flash_attention_lse(q, k, v, 1)
    wide = torch.zeros((1, 128, 68), device="cuda", dtype=torch.bfloat16)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="row stride of 136 bytes"):
        fa.flash_attention_bwd(q, k, v, out, lse, wide[..., :64], 1)
    assert dict(fa.launches) == before


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
