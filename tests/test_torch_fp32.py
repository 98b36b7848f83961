"""The fp32 path of the port (`--full_precision`) against the JAX package on
the CPU.

The fp32 kernels (`csrc/flash_fwd_d64_f32_sm90.cu`, `csrc/conv3x3_f32_sm90.cu`,
`csrc/winograd_f32_sm90.cu` and the others) run only on the card, where
`chip_smoke.py` and `tests/test_torch_cuda.py` hold them to their plain
versions; here the plain versions, which a CPU tensor runs, are
held to the TPU kernels in Pallas interpret mode with fp32 inputs: the
flash forward at d=64 (shifted and online) and d=512, the folded entry, the
nine-tap and Winograd convs. Then a tiny fp32 depth `__call__` with every
attention of at least 1024 tokens on the flash path in both packages (the
port's plain flash forward; JAX's Pallas kernel in interpret mode), on
shared noise; and the TF32 switches of `--full_precision`.

Tolerances: attention at atol 1e-5 (outputs of O(1), fp32 sums in another
order); the convs at 1e-5 (nine-tap) and 1e-4 (Winograd, whose transforms
reassociate the sums, the JAX package's own bound in test_winograd.py) of
max|ref|; the depth map at 1e-4, as tests/test_torch_pipeline.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import TINY_CLIP, TINY_VAE, tiny_unet_config
from marigold_tpu.ops import attention as JA
from marigold_tpu.ops import conv as jconv
from marigold_tpu.ops import flash_attention as jfa
from marigold_tpu.ops import winograd as jwino
from marigold_tpu.pipelines.depth import MarigoldDepthPipeline as JaxDepth
from marigold_tpu_torch import MarigoldDepthPipeline as TorchDepth
from marigold_tpu_torch.cli import set_full_precision
from marigold_tpu_torch.core.scheduler import DiffusionSchedule
from marigold_tpu_torch.models import weights as W
from marigold_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from marigold_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from marigold_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from marigold_tpu_torch.ops import attention as TA
from marigold_tpu_torch.ops import conv as tconv
from marigold_tpu_torch.ops import flash_attention as fa
from marigold_tpu_torch.ops import winograd as twino

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_dt(q, k, v, heads, softmax):
    """[B, N, C] numpy through `_flash_dt_impl` in interpret mode (the TPU
    kernel's [BH, D, N] layout and back)."""
    b, nq, c = q.shape
    d = c // heads

    def fold(x):
        n = x.shape[1]
        return jnp.asarray(x.reshape(b, n, heads, d).transpose(0, 2, 3, 1)
                           .reshape(b * heads, d, n))

    out = jfa._flash_dt_impl(fold(q), fold(k), fold(v), block_q=128,
                             block_k=128, interpret=True, softmax=softmax)
    return np.asarray(out).reshape(b, heads, d, nq).transpose(0, 3, 1, 2).reshape(
        b, nq, c)


@pytest.mark.parametrize("softmax", ["shifted", "online"])
@pytest.mark.parametrize("b,nq,nk,c,heads", [
    (2, 200, 200, 128, 2),  # d=64, two batch rows, ragged against 64
    (1, 130, 300, 64, 1),   # d=64, nq != nk
    (1, 256, 256, 512, 1),  # d=512
    (2, 100, 70, 512, 1),   # d=512, ragged, nq != nk
])
def test_fp32_plain_attention_matches_the_tpu_kernels(b, nq, nk, c, heads,
                                                      softmax):
    rng = np.random.default_rng(nq + nk)
    q = rng.standard_normal((b, nq, c)).astype(np.float32)
    k, v = (rng.standard_normal((b, nk, c)).astype(np.float32) for _ in range(2))
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), heads,
                             softmax)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_dt(q, k, v, heads, softmax),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("bh,n,d", [(3, 300, 64), (2, 200, 512)])
def test_fp32_folded_entry_matches_the_tpu_kernel(bh, n, d):
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((bh, n, d)).astype(np.float32)
               for _ in range(3))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=128, block_k=128, interpret=True)
    got = fa.flash_attention_folded(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _conv_inputs(b, h, w, c, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            (rng.standard_normal((3, 3, c, k)) * 0.05).astype(np.float32),
            rng.standard_normal(k).astype(np.float32))


def _port_conv(fn, x, wt, bias):
    out = fn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
             torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
             torch.from_numpy(bias))
    assert out.dtype == torch.float32
    return out.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("kernel,rel", [("nine_tap", 1e-5), ("winograd", 1e-4)])
@pytest.mark.parametrize("b,h,w,c,k", [(1, 10, 12, 256, 128), (2, 6, 8, 128, 256)])
def test_fp32_plain_convs_match_the_pallas_kernels(kernel, rel, b, h, w, c, k):
    x, wt, bias = _conv_inputs(b, h, w, c, k, seed=h * w)
    args = (jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), True)
    with jax.default_matmul_precision("float32"):
        if kernel == "nine_tap":
            ref, fn = jconv.conv3x3(*args), tconv.conv3x3
        else:
            ref, fn = jwino.winograd3x3(*args), twino.winograd3x3
    ref = np.asarray(ref)
    np.testing.assert_allclose(_port_conv(fn, x, wt, bias), ref,
                               atol=rel * np.abs(ref).max(), rtol=0)


def _write_depth_checkpoint(root: str) -> str:
    """A tiny Marigold depth checkpoint (8-channel UNet) with random weights
    drawn by the port, fp32 files, in diffusers layout."""
    gen = torch.Generator().manual_seed(3)
    for sub, cls, cfg, fname, prefix in (
            ("unet", UNet2DConditionModel,
             UNetConfig.from_dict(tiny_unet_config().to_dict()),
             "diffusion_pytorch_model.safetensors", ""),
            ("vae", AutoencoderKL, VAEConfig.from_dict(TINY_VAE.to_dict()),
             "diffusion_pytorch_model.safetensors", ""),
            ("text_encoder", CLIPTextModel,
             CLIPTextConfig.from_dict(TINY_CLIP.to_dict()), "model.safetensors",
             "text_model.")):
        with torch.device("meta"):
            model = cls(cfg)
        W.save_component(cfg.to_dict(), W.random_state_dict(model, gen),
                         os.path.join(root, sub), fname, prefix)
    DiffusionSchedule.create().save_pretrained(os.path.join(root, "scheduler"))
    W.write_config({"_class_name": "MarigoldDepthPipeline",
                    "default_denoising_steps": 2,
                    "default_processing_resolution": 64,
                    "scale_invariant": True, "shift_invariant": True},
                   root, "model_index.json")
    return root


def test_fp32_depth_call_through_the_flash_path_matches_jax(tmp_path,
                                                            monkeypatch):
    """E=1, 2 steps at 64 px: the tiny VAE's 32x32 latent gives the level-0
    self-attentions and the VAE mid attention 1024 tokens, the flash path's
    threshold, in both packages (JAX: the Pallas kernel in interpret mode,
    its TPU check lifted; the port: the flash wrapper on CPU tensors, whose
    plain version the fp32 kernel is held to on the card)."""
    ckpt = _write_depth_checkpoint(str(tmp_path / "ckpt"))
    monkeypatch.setenv("MARIGOLD_TPU_FASTLOAD", "0")
    jpipe = JaxDepth.from_pretrained(ckpt, dtype=jnp.float32)
    tpipe = TorchDepth.from_pretrained(ckpt, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(JA, "use_flash", lambda nq, nk: min(nq, nk) >= 1024)
    monkeypatch.setattr(jfa, "flash_attention_dt", lambda qt, kt, vt, softmax: (
        jfa._flash_dt_impl(qt, kt, vt, block_q=128, block_k=128, interpret=True,
                           softmax=softmax)))
    monkeypatch.setattr(TA, "use_flash", lambda q, nk: min(q.shape[1], nk) >= 1024)
    calls = []
    plain = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **kw: (
        calls.append(a[0].shape) or plain(*a, **kw)))

    img = np.random.default_rng(4).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    ref = jpipe(img, denoising_steps=2, processing_res=64, seed=9,
                color_map=None).depth_np
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (1, 32, 32, 4),
                                         jnp.float32))
    monkeypatch.setattr(tpipe, "_noise", lambda n, h, w, seed: torch.from_numpy(
        np.ascontiguousarray(noise.transpose(0, 3, 1, 2))))
    got = tpipe(img, denoising_steps=2, processing_res=64, seed=9,
                color_map=None).depth_np
    # the flash path ran: 2 steps x (2 down + 3 up) level-0 self-attentions,
    # the VAE mid attention in the encode and the decode
    cfg = tpipe.core.unet_cfg
    n_level0 = cfg.layers_per_block * 2 + 1
    assert len(calls) == 2 * n_level0 + 2
    assert all(s[1] == 1024 for s in calls)
    assert got.shape == (64, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_full_precision_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    set_full_precision()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
