"""The blocks of the port's bf16 Winograd kernel (`csrc/winograd.cu`) walked
on the CPU.

The kernel runs only on the card (`chip_smoke.py`,
`tests/test_torch_cuda.py`). Its geometry is emulated by
`ops/winograd.py:winograd3x3_blocks_plain`: the fused design's 4 x 16-tile
blocks of one image, each with its input box (zeros past every image edge,
never another image's rows) and its V slot's row order; the split design's
64 tiles in raster order over the batch; the sums added into the four
Y_q (fused: a fresh M_ij per 64-channel chunk and ij; split: M_ij over all
of C, ij by ij). Here the emulation is
held to `winograd3x3_plain` and to the TPU kernel (the JAX `winograd3x3` in
Pallas interpret mode, as tests/test_torch_conv.py runs it) at WINO_REL of
max|ref| (fp32 sums through the transforms in another order, the bound of
the JAX package's own test), at shapes whose boxes are partial and whose
split blocks span image rows and images; in bf16 at chip_smoke.py's gate;
and its constants to the source's.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from marigold_tpu.ops import winograd as jwino
from marigold_tpu_torch.ops import winograd as twino

# tests/test_torch_conv.py's bound: F(2x2, 3x3) in fp32 reassociates the
# sums through the transforms (the JAX package's test_winograd.py: 1e-4)
WINO_REL = 1e-4
# chip_smoke.py's gate for the bf16 kernel: TOL_REL * max|ref| + TOL_ABS
TOL_REL, TOL_ABS = 1e-2, 1e-3
SOURCE = Path(twino.__file__).resolve().parents[1] / "csrc" / "winograd.cu"


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
            (rng.standard_normal((3, 3, c, k)) * 0.05).astype(np.float32),
            rng.standard_normal(k).astype(np.float32))


def _torch(x, wt, bias):
    return (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bias))


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref,
                               atol=rel * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("b,h,w,c,k,design", [
    (1, 2, 2, 128, 128, "fused"),     # one tile in a 64-tile block
    (3, 6, 18, 128, 128, "fused"),    # a box past the right edge, 3 images
    (1, 16, 34, 256, 128, "fused"),   # two blocks across, the second 1 wide
    (3, 34, 34, 128, 128, "fused"),   # partial boxes in H and W
    (1, 18, 16, 256, 256, "fused"),   # two output-channel slices
    (3, 2, 34, 256, 128, "fused"),    # one tile row per image
    (1, 34, 2, 128, 256, "fused"),    # one tile column
    (1, 18, 34, 512, 128, "fused"),   # eight chunks through the box
    (3, 34, 6, 512, 128, "split"),    # blocks spanning rows and images
    (1, 16, 18, 512, 128, "split"),
    (3, 2, 2, 512, 128, "split"),     # three tiles, one padded block
    (3, 6, 16, 256, 128, "split"),
])
def test_blocks_match_plain_and_the_pallas_kernel(b, h, w, c, k, design):
    x, wt, bias = _inputs(b, h, w, c, k, seed=h * w + c)
    tx, tw, tb = _torch(x, wt, bias)
    got = twino.winograd3x3_blocks_plain(tx, tw, tb, design)
    assert got.shape == (b, k, h, w) and got.dtype == torch.float32
    _close(got, twino.winograd3x3_plain(tx, tw, tb), WINO_REL)
    with jax.default_matmul_precision("float32"):
        ref = jwino.winograd3x3(jnp.asarray(x), jnp.asarray(wt),
                                jnp.asarray(bias), True)
    _close(got.numpy().transpose(0, 2, 3, 1), ref, WINO_REL)
    conv = F.conv2d(tx.double(), tw.double(), tb.double(), padding=1)
    _close(got, conv.numpy(), WINO_REL)


def test_boxes_never_read_another_image():
    """Images of one batch far apart in scale: each image's output is its
    own conv, as if it were alone (zero fill at the edges between images,
    in both designs)."""
    x, wt, bias = _inputs(3, 6, 34, 128, 128, seed=3)
    x = x * np.array([1.0, 1e3, 1e-3], np.float32)[:, None, None, None]
    tx, tw, tb = _torch(x, wt, bias)
    for design in ("fused", "split"):
        got = twino.winograd3x3_blocks_plain(tx, tw, tb, design)
        for i in range(3):
            alone = twino.winograd3x3_blocks_plain(tx[i:i + 1], tw, tb, design)
            torch.testing.assert_close(got[i:i + 1], alone, rtol=0,
                                       atol=WINO_REL * alone.abs().max().item())


@pytest.mark.parametrize("design", ["fused", "split"])
def test_bf16_blocks_within_the_card_gate(design):
    """In bf16 the emulation rounds V and the output where the kernel does:
    within chip_smoke.py's gate of the plain version."""
    x, wt, bias = (t.to(torch.bfloat16)
                   for t in _torch(*_inputs(2, 18, 34, 256, 128, seed=5)))
    got = twino.winograd3x3_blocks_plain(x, wt, bias, design)
    ref = twino.winograd3x3_plain(x, wt, bias)
    assert got.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL_REL * ref.float().abs().max().item() + TOL_ABS


def test_design_rule():
    """One launch (fused) at the VAE's 128- and 256-channel levels, the split
    design from 512 channels on."""
    assert twino.FUSED_MAX_C == 256
    for c in (128, 256):
        assert twino.design(1, c, 768, 768, c) == "fused"
    for c in (512, 640, 1280, 1920, 2560):
        assert twino.design(10, c, 24, 24, 1280) == "split"


def test_emulation_walks_the_source_geometry():
    """The emulation's chunk, rectangle and row order are the source's."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("BC") == twino.CHUNK
    rect = re.search(r"constexpr int RECT_TY = (\d+), RECT_TX = (\d+);", text)
    assert (int(rect.group(1)), int(rect.group(2))) == twino.RECT
    assert const("BOX_W") >= 2 * twino.RECT[1] + 2 and const("BOX_W") % 8 == 0
    # build_quad's stores: tile 2p of tile row ty_l to row 16 ty_l + p,
    # tile 2p + 1 eight rows on
    assert "const int off = (16 * ty_l + p) * 128 + ((o ^ p) << 4) + 4 * cp;" in text
    assert "vq + j * V_SLOT + off + 8 * 128) = w[1][j];" in text
    # the row order: a bijection whose store phases (8 rows, tiles 2p or
    # 2p + 1 of one tile row) hit 8 distinct 16-byte chunks of the swizzle
    m = torch.arange(64)
    ty_l, tx_l = m // 16, 2 * (m % 8) + (m // 8) % 2
    assert sorted((16 * ty_l + tx_l).tolist()) == list(range(64))
    for row in range(4):
        for parity in range(2):
            rows = [16 * row + 8 * parity + p for p in range(8)]
            assert sorted(r % 8 for r in rows) == list(range(8))
