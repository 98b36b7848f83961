"""The flash wrappers' one validation per call, and chip_smoke.py's watchdog.

`ops/flash_attention.py:check_kernel_args` does in one pass what the
wrappers of the Hopper flash kernels checked in three before (the inputs'
devices, dtypes and shapes; what the CUDA kernels take; what their TMA maps
take), with the same errors and messages. It reads only each tensor's
device, dtype, shape, strides, element size, data_ptr and requires_grad, so
the cases here hand it stand-ins that say they live on a card. The
watchdog test runs `chip_smoke.Watchdog` in a fresh interpreter with a 1 s
deadline over a sleeping phase.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from marigold_tpu_torch.ops import flash_attention as fa

REPO = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the CPU's cores; torch's own
    thread pool in each of them would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Stand:
    """What check_kernel_args reads of a tensor, for a tensor that is not
    there: on "cuda:0" unless told, contiguous strides unless given, its
    data at `ptr`."""

    def __init__(self, shape, dtype=BF16, strides=None, ptr=1 << 20,
                 device="cuda:0", requires_grad=False):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self.requires_grad = requires_grad
        b, n, c = shape if len(shape) == 3 else (1, 1, 1)
        self._strides = tuple(strides) if strides else (
            (n * c, c, 1) if len(shape) == 3 else (1,) * len(shape))
        self._ptr = ptr

    @property
    def is_cuda(self):
        return self.device.type == "cuda"

    def stride(self):
        return self._strides

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()

    def data_ptr(self):
        return self._ptr


def _qkv(b=1, n=256, c=320, **kw):
    return {"q": Stand((b, n, c), **kw), "k": Stand((b, n, c), **kw),
            "v": Stand((b, n, c), **kw)}


def _with(name, t, **kw):
    tensors = _qkv(**kw)
    tensors[name] = t
    return tensors


# (case, tensors, num_heads, kwargs, error type, the message the wrappers'
# three checks gave for it)
REJECTED = [
    ("device: the CPU", _qkv(device="cpu"), 5, {}, ValueError,
     "no flash-attention kernel for device cpu"),
    ("device: another card", _with("v", Stand((1, 256, 320), device="cuda:1")),
     5, {}, ValueError, "v is on cuda:1, q on cuda:0"),
    ("dtype: fp16", _qkv(dtype=torch.float16), 5, {}, ValueError,
     f"flash attention on CUDA takes {fa.KERNEL_DTYPES}, got torch.float16"),
    ("dtype: k's", _with("k", Stand((1, 256, 320), dtype=torch.float32)), 5,
     {}, ValueError, "k is torch.float32, q is torch.bfloat16"),
    ("head width 32", _qkv(c=320), 10, {}, ValueError,
     f"head dim 32 not in the kernel's {fa.HEAD_DIMS}; other head widths "
     "are a ROADMAP item (queue 2)"),
    ("head width 512 for training", _qkv(c=512), 1,
     {"head_dims": fa.TRAIN_HEAD_DIMS}, ValueError,
     f"head dim 512 not in the kernel's {fa.TRAIN_HEAD_DIMS}; other head "
     "widths are a ROADMAP item (queue 2)"),
    ("non-contiguous: transposed",
     _with("q", Stand((1, 256, 320), strides=(81920, 1, 256))), 5, {},
     ValueError, "q must be contiguous"),
    ("non-contiguous: a row slice of wider rows",
     _with("k", Stand((1, 256, 320), strides=(256 * 640, 640, 1))), 5, {},
     ValueError, "k must be contiguous"),
    ("non-contiguous: strided batch",
     _with("v", Stand((2, 256, 320), strides=(3 * 256 * 320, 320, 1)),
           b=2), 5, {"strided": True}, ValueError,
     "v must be [B, N, C] rows with contiguous channels, got strides "
     "(245760, 320, 1)"),
    ("non-contiguous channels, strided entry",
     _with("q", Stand((1, 256, 320), strides=(81920, 1, 256))), 5,
     {"strided": True}, ValueError,
     "q must be [B, N, C] rows with contiguous channels, got strides "
     "(81920, 1, 256)"),
    ("misaligned base", _with("q", Stand((1, 256, 320), ptr=(1 << 20) + 2)),
     5, {}, ValueError, "q must be 16-byte aligned"),
    ("row stride of 136 bytes",
     _with("v", Stand((1, 256, 320), strides=(256 * 68, 68, 1))), 5,
     {"strided": True}, ValueError,
     "v's row stride of 136 bytes is not a multiple of 16, which TMA needs"),
    ("no rows", _qkv(n=0), 5, {}, ValueError, "q (1, 0, 320) has no rows"),
    ("grad enabled", _with("k", Stand((1, 256, 320), requires_grad=True)), 5,
     {}, RuntimeError,
     "the flash-attention kernels are not differentiable: with grad enabled "
     "call FlashAttentionFunction (ops/attention.py's dispatch_attention "
     "does)"),
    ("B*H over the grid", _qkv(b=13108, n=16), 5, {}, ValueError,
     "B*H=65540 exceeds the grid's y limit"),
    ("shape mismatch: k's channels",
     _with("k", Stand((1, 256, 640))), 5, {}, ValueError,
     "shape mismatch: q (1, 256, 320), k (1, 256, 640), v (1, 256, 320)"),
    ("shape mismatch: v's rows", _with("v", Stand((1, 128, 320))), 5, {},
     ValueError,
     "shape mismatch: q (1, 256, 320), k (1, 256, 320), v (1, 128, 320)"),
    ("not [B, N, C]", _with("q", Stand((256, 320))), 5, {}, ValueError,
     "q must be [B, N, C], got (256, 320)"),
    ("heads", _qkv(), 3, {}, ValueError, "C=320 is not divisible by 3 heads"),
    ("softmax mode", _qkv(), 5, {"softmax": "exact"}, ValueError,
     "unknown softmax mode: 'exact'"),
    ("the backward's dout on another card",
     {**_qkv(), "dout": Stand((1, 256, 320), device="cuda:1")}, 5,
     {"head_dims": fa.TRAIN_HEAD_DIMS}, ValueError,
     "dout is on cuda:1, q on cuda:0"),
]


@pytest.mark.parametrize(
    "tensors,heads,kwargs,error,message",
    [case[1:] for case in REJECTED], ids=[case[0] for case in REJECTED])
def test_one_check_rejects_what_the_three_rejected(tensors, heads, kwargs,
                                                   error, message):
    kwargs = {"head_dims": fa.HEAD_DIMS, **kwargs}
    with pytest.raises(error) as raised:
        fa.check_kernel_args(tensors, heads, **kwargs)
    assert str(raised.value) == message


def test_grad_passes_with_grad_off():
    tensors = _with("k", Stand((1, 256, 320), requires_grad=True))
    with torch.no_grad():
        assert fa.check_kernel_args(tensors, 5, fa.HEAD_DIMS) == 64


@pytest.mark.parametrize("c,heads,d", [(320, 5, 64), (320, 8, 40),
                                       (640, 8, 80), (1280, 8, 160),
                                       (512, 1, 512)])
def test_one_check_accepts_the_packed_entrys_views(c, heads, d):
    """flash_attention_packed's q, k and v: [B, N, C] views of one
    [B, N, 3C] projection at row stride 3C, the channels of each a third
    of the row further on."""
    b, n = 2, 300
    qkv = torch.zeros((b, n, 3 * c), dtype=BF16)
    views = {name: qkv[..., i * c:(i + 1) * c]
             for i, name in enumerate(("q", "k", "v"))}
    stands = {name: Stand(t.shape, strides=t.stride(), ptr=t.data_ptr())
              for name, t in views.items()}
    assert fa.check_kernel_args(stands, heads, fa.HEAD_DIMS, "shifted",
                                strided=True) == d
    with pytest.raises(ValueError, match="must be contiguous"):
        fa.check_kernel_args(stands, heads, fa.HEAD_DIMS, "shifted")


def test_one_check_accepts_what_the_kernels_take():
    """Contiguous bf16 and fp32 tensors, nq != nk, a size-1 dimension
    whose stride does not count, the training widths, dout and out."""
    for dtype in fa.KERNEL_DTYPES:
        tensors = {"q": Stand((2, 100, 640), dtype),
                   "k": Stand((2, 130, 640), dtype),
                   "v": Stand((2, 130, 640), dtype)}
        assert fa.check_kernel_args(tensors, 8, fa.TRAIN_HEAD_DIMS) == 80
        tensors["dout"] = Stand((2, 100, 640), dtype)
        tensors["out"] = Stand((2, 100, 640), dtype)
        assert fa.check_kernel_args(tensors, 8, fa.TRAIN_HEAD_DIMS) == 80
    odd = _with("q", Stand((1, 256, 320), strides=(7, 320, 1)))
    assert fa.check_kernel_args(odd, 5, fa.HEAD_DIMS) == 64
    folded = {name: Stand((50, 9216, 64)) for name in ("q", "k", "v")}
    assert fa.check_kernel_args(folded, 1, fa.HEAD_DIMS) == 64


def test_contiguity_from_the_strides_is_torchs():
    """_contiguous against torch's is_contiguous on views of every kind
    check_kernel_args meets."""
    x = torch.zeros((3, 5, 24))
    views = [x, x[:1], x[:, :1], x[..., :8], x[:, 1:3], x.transpose(0, 1),
             x[::2], x[:, ::2], x.transpose(1, 2), x[:, :0], x[..., :1],
             x[:1, :1], x.reshape(15, 8, 3)[:, :1]]
    for v in views:
        assert fa._contiguous(v.shape, v.stride()) == v.is_contiguous(), \
            (tuple(v.shape), v.stride())


WATCHDOG_RUN = """
import subprocess, sys, time
import chip_smoke as C
C.WATCHDOG = C.Watchdog(1.0, backstop=5.0)
child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
print("child", child.pid, flush=True)
C.phase("a sleeping phase")
time.sleep(60)
print("never here", flush=True)
"""


def test_watchdog_names_the_phase_and_exits():
    """A 1 s deadline over a phase that sleeps: the run ends nonzero within
    seconds, naming the phase, with every thread's stack, and the process
    it started is gone."""
    proc = subprocess.run([sys.executable, "-c", WATCHDOG_RUN], cwd=REPO,
                          capture_output=True, text=True, timeout=45,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    out = proc.stdout
    assert proc.returncode == 3, (proc.returncode, out, proc.stderr)
    assert "phase a sleeping phase" in out
    assert "FAIL: watchdog: 1 s passed in phase 'a sleeping phase'" in out
    assert "most recent call first" in out.split("FAIL: watchdog")[1]
    assert "never here" not in out
    pid = int(out.split("child ")[1].split()[0])
    try:  # killed: gone, or a zombie not yet reaped
        with open(f"/proc/{pid}/stat") as f:
            assert f.read().split()[2] == "Z"
    except FileNotFoundError:
        pass


# chip_smoke.py --bits-against's decision rule (flash_bits) on runs made
# up here: what each BITS_SNIPPET run returns, with every device time 1 ms
# unless a case says otherwise.

def _ulp_up(x):
    """x with every element one unit in the last place further from 0 (on
    the bits of its integer view)."""
    ints = {BF16: torch.int16, torch.float32: torch.int32}[x.dtype]
    return (x.view(ints) + 1).view(x.dtype)


def _bits_run(ms=1.0, outs=None, slow=()):
    import chip_smoke as C

    gen = torch.Generator().manual_seed(0)
    base = torch.randn((4, 8), generator=gen)
    outs = outs or {
        "l0_bfloat16_online": base.to(BF16),
        "l0_bfloat16_lse": base.clone(),
        "l0_bfloat16_dq": (2 * base).to(BF16),
        "l0_float32_dq": 2 * base,
    }
    dev = {}
    for name, spec in C.BITS_TIMED.items():
        t = ms * (1.5 if name in slow else 1.0)
        kernels = ({"flash_bwd_dq_kernel<64>": 0.4 * t,
                    "flash_bwd_dkv_kernel<64>": 0.6 * t}
                   if spec[-1] == "bwd" else {"flash_fwd_sm90_kernel": t})
        dev[name] = (float(len(kernels)), kernels)
    return {"outs": outs, "twice": {"l0_bfloat16": True},
            "ms": {name: ms for name in C.BITS_TIMED}, "dev": dev,
            "host": {name: (20.0, 25.0) for name in C.BITS_TIMED}}


def test_bits_one_slow_run_among_four_passes():
    """Each build's fastest of its four runs is compared: one run of this
    build 1.5x slower on every kernel does not fail the gate."""
    import chip_smoke as C

    this = [_bits_run(), _bits_run(slow=C.BITS_TIMED), _bits_run(),
            _bits_run()]
    other = [_bits_run() for _ in range(4)]
    assert C.flash_bits(this, other) == []


def test_bits_a_slower_fastest_run_fails():
    """All four runs of this build's whole backward at d=40 over the slack:
    that row fails, and only it."""
    import chip_smoke as C

    this = [_bits_run(slow=("bf16_d40_bwd",)) for _ in range(4)]
    other = [_bits_run() for _ in range(4)]
    assert C.flash_bits(this, other) == [
        "bf16_d40_bwd: slower on the device than the other build"]
    # within the slack passes
    this = [_bits_run(ms=C.BITS_TIME_SLACK * 0.999) for _ in range(4)]
    assert C.flash_bits(this, other) == []


def test_bits_a_bf16_gradient_within_the_gate_passes():
    """A bf16 dq one bf16 ulp off the other build's (delta summed in
    another order) passes; past phase 3's gradient gate it fails."""
    import chip_smoke as C

    other = [_bits_run() for _ in range(4)]
    outs = dict(other[0]["outs"])
    ref = outs["l0_bfloat16_dq"]
    outs["l0_bfloat16_dq"] = _ulp_up(ref)
    assert not torch.equal(outs["l0_bfloat16_dq"], ref)
    this = [_bits_run(outs=outs) for _ in range(4)]
    assert C.flash_bits(this, other) == []
    far = dict(outs, l0_bfloat16_dq=(ref.float() + 1.0).to(BF16))
    this = [_bits_run(outs=far) for _ in range(4)]
    failures = C.flash_bits(this, other)
    assert len(failures) == 1 and failures[0].startswith("l0_bfloat16_dq: ")


def test_bits_an_unequal_forward_or_fp32_gradient_fails():
    """The online forward and the fp32 dq stay exact: a one-ulp change of
    either fails, as does a second call that differs."""
    import chip_smoke as C

    other = [_bits_run() for _ in range(4)]
    for key in ("l0_bfloat16_online", "l0_float32_dq"):
        outs = dict(other[0]["outs"])
        outs[key] = _ulp_up(outs[key])
        this = [_bits_run(outs=outs) for _ in range(4)]
        assert C.flash_bits(this, other) == [
            f"outputs differ from the other build's: ['{key}']"]
    this = [_bits_run() for _ in range(4)]
    this[2]["twice"] = {"l0_bfloat16": False}
    assert C.flash_bits(this, other) == [
        "this build's second calls or runs differ"]
