"""The 3xTF32 arithmetic of the port's fp32 conv kernels on the CPU.

`csrc/conv3x3_f32_sm90.cu` (the nine-tap) and `csrc/winograd_f32_sm90.cu`
split each fp32 operand into two tf32 parts, hi + lo, and sum lo.hi +
hi.lo + hi.hi on the tensor cores, each chunk of the reduction into a
fresh accumulator added into the running sum in fp32. They run only on the
card (`chip_smoke.py`, `tests/test_torch_cuda.py`); here their emulations
in `ops/conv.py` and `ops/winograd.py` are held to the TPU kernels (Pallas
interpret mode, fp32) at the fp32 gate that `chip_smoke.py` holds the
kernels to, max|err| <= 1e-4 * max|ref| + 1e-6, where one tf32 product
misses it; the prepared layouts (the split taps and filter, x's split NHWC
copy) reconstruct their input to 2^-22; `Conv2d` caches the split weight
for fp32; and the emulations chunk the reduction as the sources do.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marigold_tpu.ops import conv as jconv
from marigold_tpu.ops import winograd as jwino
from marigold_tpu_torch.models import layers as TL
from marigold_tpu_torch.ops import conv as tconv
from marigold_tpu_torch.ops import flash_attention as fa
from marigold_tpu_torch.ops import winograd as twino

# chip_smoke.py's fp32 gate: max|err| <= F32_TOL_REL * max|ref| + F32_TOL_ABS
F32_TOL_REL, F32_TOL_ABS = 1e-4, 1e-6
CSRC = Path(tconv.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, h, w, c, k, seed):
    """x NHWC, w HWIO (the JAX package's layouts) and the bias, numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            (rng.standard_normal((3, 3, c, k)) / (3 * c ** 0.5))
            .astype(np.float32),
            rng.standard_normal(k).astype(np.float32))


def _jax_ref(kernel, x, wt, bias):
    """The TPU kernel in Pallas interpret mode at fp32, NCHW."""
    args = (jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), True)
    with jax.default_matmul_precision("float32"):
        fn = jconv.conv3x3 if kernel == "nine_tap" else jwino.winograd3x3
        return torch.from_numpy(np.asarray(fn(*args)).transpose(0, 3, 1, 2)
                                .copy())


def _torch(x, wt, bias):
    return (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bias))


def _within_gate(got, ref):
    err = (got - ref).abs().max().item()
    return err, err <= F32_TOL_REL * ref.abs().max().item() + F32_TOL_ABS


@pytest.mark.parametrize("kernel", ["nine_tap", "winograd"])
@pytest.mark.parametrize("b,h,w,c,k", [
    (1, 10, 12, 256, 128),  # two fresh accumulators of the nine-tap
    (2, 6, 8, 128, 256),
    (1, 8, 8, 512, 128),    # four of the nine-tap
])
def test_emulated_kernels_match_the_pallas_kernels(kernel, b, h, w, c, k):
    x, wt, bias = _inputs(b, h, w, c, k, seed=c + h)
    ref = _jax_ref(kernel, x, wt, bias)
    emulate = {"nine_tap": tconv.conv3x3_tf32x3_plain,
               "winograd": twino.winograd3x3_tf32x3_plain}[kernel]
    got = emulate(*_torch(x, wt, bias))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err, ok = _within_gate(got, ref)
    assert ok, err


def test_one_tf32_product_misses_the_gate():
    """hi.hi alone, one tf32 pass (~2^-11 per operand), is what the three
    passes are for: it misses the gate the emulation meets."""
    x, wt, bias = _inputs(1, 8, 8, 256, 128, seed=7)
    ref = _jax_ref("nine_tap", x, wt, bias)
    xt, wtt, bt = _torch(x, wt, bias)
    hi_only = tconv.conv3x3_plain(fa.split_tf32_plain(xt)[0],
                                  fa.split_tf32_plain(wtt)[0], bt)
    assert not _within_gate(hi_only, ref)[1]
    assert _within_gate(tconv.conv3x3_tf32x3_plain(xt, wtt, bt), ref)[1]


def _check_split(pair, whole):
    """pair [2, ...] = (hi, lo) of `whole`: tf32 values (the low 13
    mantissa bits zero), hi rounded to nearest, hi + lo within 2^-22."""
    assert pair.shape == (2,) + whole.shape and pair.is_contiguous()
    for part in pair:
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    hi, _ = fa.split_tf32_plain(whole)
    assert torch.equal(pair[0], hi)
    err = (pair[0].double() + pair[1].double() - whole.double()).abs()
    assert (err <= whole.double().abs() * 2.0 ** -22).all()


def test_prepared_layouts_reconstruct_their_input():
    torch.manual_seed(0)
    w = torch.randn(128, 256, 3, 3) * 0.05
    _check_split(tconv.taps_tf32(w), tconv.taps(w))
    _check_split(twino.filter_transform_tf32(w), twino.filter_transform(w))
    x = torch.randn(2, 64, 5, 7) * 30.0
    _check_split(tconv.split_x_tf32(x), x.permute(0, 2, 3, 1))
    torch.testing.assert_close(tconv.split_x_tf32(x),
                               tconv.split_x_tf32_plain(x), rtol=0, atol=0)


@pytest.mark.parametrize("impl,bare", [("pallas", (9, 128, 256)),
                                       ("winograd", (16, 128, 256))])
def test_conv2d_caches_the_split_weight_for_fp32(monkeypatch, impl, bare):
    """The kernels' prepared weight that Conv2d caches: for an fp32 weight
    the split form [2, ...] that the fp32 kernels read (a bare one makes
    them raise), for bf16 the bare rearrangement."""
    monkeypatch.setattr(TL, "_CONV_IMPL", impl)
    torch.manual_seed(1)
    conv = TL.Conv2d(256, 128, 3, padding=1).requires_grad_(False)
    mod = tconv if impl == "pallas" else twino
    prepared = conv.prepared_weight(impl)
    assert prepared.shape == (2,) + bare
    torch.testing.assert_close(prepared, mod.prepare_weight(conv.weight),
                               rtol=0, atol=0)
    whole = (tconv.taps if impl == "pallas" else twino.filter_transform)(
        conv.weight)
    _check_split(prepared, whole)
    conv = conv.to(torch.bfloat16)
    assert conv.prepared_weight(impl).shape == bare


@pytest.mark.parametrize("source,module", [
    ("conv3x3_f32_sm90.cu", tconv), ("winograd_f32_sm90.cu", twino)])
def test_emulation_chunks_the_reduction_as_the_source(source, module):
    """The emulations' fresh-accumulator chunk (input channels) is the
    source's CHUNK_CB channel blocks of 32."""
    text = (CSRC / source).read_text()
    chunk_cb = int(re.search(r"constexpr int CHUNK_CB = (\d+);", text).group(1))
    assert "constexpr int BC = TF32_ROW;" in text
    assert module.F32_CHUNK == 32 * chunk_cb
