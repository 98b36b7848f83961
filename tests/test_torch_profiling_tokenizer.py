"""The port's `utils/profiling.py` and `models/tokenizer.py` against the JAX
package's copies on the CPU: `PhaseTimer` totals, counts and report, to the
character, on the same phases under one fake clock; `trace()` writing a
Chrome trace with the `annotate` ranges in it, and nothing without a
directory; the CLIP BPE tokenizer's ids equal to the JAX copy's on a
byte-level vocabulary with merges written as a checkpoint's tokenizer/ dir
(as tests/test_lcm_tokenizer.py builds its toy one)."""

import itertools
import json
import os

import pytest
import torch

from marigold_tpu.models.tokenizer import CLIPTokenizer as JTokenizer
from marigold_tpu.models.tokenizer import _bytes_to_unicode
from marigold_tpu.utils import profiling as jprof
from marigold_tpu_torch.models import clip_text as tclip
from marigold_tpu_torch.models.tokenizer import CLIPTokenizer as TTokenizer
from marigold_tpu_torch.utils import profiling as tprof


def _run_phases(mod, monkeypatch):
    clock = itertools.count(0.0, 0.125)
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
    timer = mod.PhaseTimer()
    for name in ("host pre", "encode", "denoise", "denoise", "decode",
                 "ensemble", "denoise", "host post"):
        with timer.phase(name) as box:
            box["result"] = None
    return timer


def test_phase_timer_matches_jax(monkeypatch):
    port = _run_phases(tprof, monkeypatch)
    ref = _run_phases(jprof, monkeypatch)
    assert dict(port.totals) == dict(ref.totals)
    assert dict(port.counts) == dict(ref.counts) and port.counts["denoise"] == 3
    assert port.report() == ref.report()
    assert port.report().splitlines()[0] == (
        "phase                     total_s   calls   share")
    port.reset()
    assert not port.totals and not port.counts


def test_trace_writes_a_chrome_trace_with_the_ranges(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        assert prof is not None
        with tprof.annotate("marigold_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = tmp_path.iterdir()
    assert path.name.startswith("trace_") and path.suffix == ".json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "marigold_range" for e in events)


def test_trace_without_a_directory_records_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(tprof, "_TRACE_DIR", None)
    with tprof.trace() as prof:
        assert prof is None
    monkeypatch.setattr(tprof, "_TRACE_DIR", str(tmp_path / "env"))
    with tprof.trace():
        pass
    assert len(os.listdir(tmp_path / "env")) == 1


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A byte-level CLIP vocabulary (every byte symbol, alone and with
    </w>) with merges that build a few words, in the transformers file
    layout of a checkpoint's tokenizer/ dir."""
    symbols = list(_bytes_to_unicode().values())
    vocab = {}
    for s in symbols + [s + "</w>" for s in symbols]:
        vocab[s] = len(vocab)
    merges = [("l", "o"), ("lo", "w</w>"), ("e", "r</w>"), ("d", "e"),
              ("de", "p"), ("dep", "t"), ("dept", "h</w>"), ("#", "#"),
              ("c", "a"), ("ca", "f"), ("caf", "Ã"), ("t", "h"), ("th", "e</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = tclip.BOS_TOKEN_ID
    vocab["<|endoftext|>"] = tclip.EOS_TOKEN_ID
    d = tmp_path_factory.mktemp("ckpt") / "tokenizer"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
        encoding="utf-8")
    return str(d)


TEXTS = ["", "  ", "low lower", "The depth of the scene", "café 深度 ## d3pth!",
         "it's a  multi\nline\tprompt, isn't it?", "x" * 200]


@pytest.mark.parametrize("padding", ["do_not_pad", "max_length"])
def test_tokenizer_ids_match_jax(tokenizer_dir, padding):
    port = TTokenizer.from_pretrained(tokenizer_dir)
    ref = JTokenizer.from_pretrained(tokenizer_dir)
    assert (port.bos_token_id, port.eos_token_id) == (
        tclip.BOS_TOKEN_ID, tclip.EOS_TOKEN_ID)
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text), text
    got = port(TEXTS, padding=padding).input_ids
    assert got == ref(TEXTS, padding=padding).input_ids
    assert got[0][:2] == [tclip.BOS_TOKEN_ID, tclip.EOS_TOKEN_ID]
    assert all(len(ids) <= port.model_max_length for ids in got)
