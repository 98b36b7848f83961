"""The shifted softmax's row shift as the port's kernels compute it.

The shifted forwards at head widths 40, 64, 80 and 160
(`csrc/flash_fwd_sm90.cu` in bf16, `csrc/flash_fwd_d64_f32_sm90.cu` in fp32)
compute the row shift in their own launch: a sample pass over K's rows 0,
stride, 2 stride, ... < nk (`ops/flash_attention.py:shift_sample`) before
their key loop. They run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`); here the sample's geometry is held to the TPU wrapper's
strided slice, and a tiled emulation of the bf16 kernel's pass (bf16
operands, fp32 sums, sample tiles of the source's BK keys with the columns
past n_sub masked, base-2 units) to the JAX formula. The fp32 kernel's pass
is emulated in `tests/test_torch_tf32x3.py`.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marigold_tpu.ops import flash_attention as jfa
from marigold_tpu_torch.ops import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
LOG2E = np.float32(np.log2(np.e))
LN2 = np.float32(np.log(2.0))
# The kernel's shift against the formula's: the same logits summed in
# another order, so |err| <= SHIFT_TOL * max(1, |shift|) (chip_smoke.py's
# gate on the card).
SHIFT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("nk", [1, 64, 127, 128, 255, 256, 257, 1000, 1024,
                                1300, 2304, 4800, 9216, 36864])
def test_shift_sample_is_the_tpu_wrappers_slice(nk):
    """(stride, n_sub) name exactly the keys of the JAX wrapper's
    `kt[:, :, ::stride]`; at most 255 of them, so the sample pass takes at
    most 2 tiles of 128 keys or 4 of 64."""
    assert fa.SHIFT_SAMPLE_TARGET == jfa._SHIFT_SAMPLE_TARGET
    assert fa.SHIFT_MARGIN == jfa._SHIFT_MARGIN
    stride, n_sub = fa.shift_sample(nk)
    keys = np.asarray(jnp.arange(nk)[::max(1, nk // 128)])
    np.testing.assert_array_equal(np.arange(n_sub) * stride, keys)
    assert n_sub <= fa.SHIFT_SAMPLE_MAX == 255
    assert -(-n_sub // 128) <= 2 and -(-n_sub // 64) <= 4
    if nk >= 256:  # stride >= 2 keeps the sample near 128 keys
        assert 128 <= n_sub <= 192


@pytest.mark.parametrize("source", ["flash_fwd_sm90.cu",
                                    "flash_fwd_d64_f32_sm90.cu"])
def test_sources_sample_as_the_wrapper(source):
    """Both sources refuse a sample of more than SHIFT_SAMPLE_MAX keys and
    add the wrapper's margin in base-2 units."""
    text = (CSRC / source).read_text()
    assert int(re.search(r"constexpr int kMaxSample = (\d+);", text)
               .group(1)) == fa.SHIFT_SAMPLE_MAX
    margin = re.search(r"constexpr float kMargin2 = ([\d.]+)f \* "
                       r"1\.4426950408889634f;", text)
    assert float(margin.group(1)) == fa.SHIFT_MARGIN
    assert "n_sub != cdiv(nk, stride)" in text


@pytest.mark.parametrize("strided", [False, True])
def test_cpu_shift_entry_is_the_plain_version(strided):
    """On CPU tensors flash_attention_shift returns the plain shifted
    forward and row_shift's shift, counting no launch."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 300, 3 * 80))
                           .astype(np.float32))
    q, k, v = (qkv[..., i * 80:(i + 1) * 80] for i in range(3))
    if not strided:
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = sum(fa.launches.values()) + sum(fa.launches_f32.values())
    out, shift = fa.flash_attention_shift(q, k, v, 2, strided)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, 2, "shifted"))
    assert torch.equal(shift, fa.row_shift(q, k, 2))
    assert sum(fa.launches.values()) + sum(fa.launches_f32.values()) == before


def _bf16_tile(d: int) -> int:
    """csrc/flash_fwd_sm90.cu's keys per K tile at head width d."""
    text = (CSRC / "flash_fwd_sm90.cu").read_text()
    assert "static constexpr int BK = D > 128 ? 64 : 128;" in text
    return 64 if d > 128 else 128


def _emulated_bf16_shift(q, k):
    """[nq] shift in natural-log units as csrc/flash_fwd_sm90.cu's sample
    pass computes it on bf16 q and k: the sampled keys in tiles of BK rows
    (zeros past n_sub, as TMA fills them), S in fp32 from bf16 products, the
    columns >= n_sub masked to -1e30 in each tile, the running row max, then
    fma(max, scale log2(e), 40 log2(e)) in fp32 and times ln(2)."""
    nq, d = q.shape
    bk = _bf16_tile(d)
    scale_log2 = np.float32(np.float32(1.0 / np.sqrt(d)) * LOG2E)
    stride, n_sub = fa.shift_sample(k.shape[0])
    n_pad = -(-n_sub // bk) * bk
    sample = torch.zeros(n_pad, d)
    sample[:n_sub] = k[::stride].float()
    mx = torch.full((nq,), -1e30)
    for k0 in range(0, n_pad, bk):
        s = q.float() @ sample[k0:k0 + bk].T
        s[:, max(0, n_sub - k0):] = -1e30
        mx = torch.maximum(mx, s.amax(-1))
    margin2 = np.float32(np.float32(fa.SHIFT_MARGIN) * LOG2E)
    sh2 = (mx.double() * float(scale_log2) + float(margin2)).float()  # fma
    return sh2 * LN2


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("nq,nk", [(129, 200), (70, 1300), (33, 4800)])
def test_emulated_bf16_shift_meets_the_jax_formula(d, nq, nk, negative):
    """The bf16 kernel's shift against the TPU wrapper's formula on the
    same bf16 inputs, max(dot(q, k[::stride]) * scale) + 40 in fp32:
    nk = 200 takes every key (two 128-key tiles at 40-80, four 64-key
    tiles at 160, the last ragged), 1300 stride 10, 4800 stride 37 (the
    last sampled key, 4773, below nk). With every logit negative a
    zero-filled sample row left unmasked would win the max."""
    rng = np.random.default_rng(d + nk)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((nk, d)).astype(np.float32))
    if negative:
        q, k = q.abs(), -k.abs()
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    got = _emulated_bf16_shift(q, k)
    qj, kj = jnp.asarray(q.float().numpy()), jnp.asarray(k.float().numpy())
    stride = max(1, nk // jfa._SHIFT_SAMPLE_TARGET)
    s_sub = jnp.dot(qj, kj[::stride].T, preferred_element_type=jnp.float32)
    ref = np.asarray(jnp.max(s_sub * (1.0 / np.sqrt(d)), axis=-1)
                     + jfa._SHIFT_MARGIN)
    assert got.shape == ref.shape
    assert (np.abs(got.numpy() - ref) <= SHIFT_TOL
            * np.maximum(1.0, np.abs(ref))).all()
    # the port's plain version, which the card's checks hold the kernel to
    plain = fa.row_shift(q[None], k[None], 1)[0].numpy()
    assert (np.abs(got.numpy() - plain) <= SHIFT_TOL
            * np.maximum(1.0, np.abs(plain))).all()
