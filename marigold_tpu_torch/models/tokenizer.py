"""CLIP BPE tokenizer (CLIPTokenizer role) — pure Python, loads the
vocab.json + merges.txt shipped in checkpoints' tokenizer/ dirs.

Copy of `marigold_tpu/models/tokenizer.py` for the PyTorch port (framework
free); the special-token ids come from the port's `models/clip_text.py`.

Role parity: the reference only ever tokenizes the empty prompt
(marigold_depth_pipeline.py:383-390, padding="do_not_pad" -> [BOS, EOS]),
but ships a full CLIPTokenizer; we implement the standard CLIP byte-level
BPE (lowercase, whitespace-collapse, word tokens suffixed with "</w>") so
arbitrary prompts work when tokenizer files are present, with a
constant-free fast path for the empty prompt.
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import List, Optional

from marigold_tpu_torch.models.clip_text import BOS_TOKEN_ID, EOS_TOKEN_ID

# stdlib-`re` spelling of CLIP's \p{L}/\p{N} pattern: [^\W\d_] matches
# exactly the unicode letters under re.UNICODE (so 'café' stays one word
# token, matching the reference tokenizer), \d the unicode digits
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE | re.UNICODE,
)

# CJK ideograph ranges BasicTokenizer._is_chinese_char space-separates
_CJK = re.compile(
    "([一-鿿㐀-䶿豈-﫿"
    "\U00020000-\U0002a6df\U0002a700-\U0002b73f"
    "\U0002b740-\U0002b81f\U0002b820-\U0002ceaf\U0002f800-\U0002fa1f])"
)


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    def __init__(self, vocab: dict, merges: List[tuple],
                 bos_token_id: int = BOS_TOKEN_ID,
                 eos_token_id: int = EOS_TOKEN_ID,
                 model_max_length: int = 77):
        self.encoder = vocab
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.model_max_length = model_max_length
        self._cache: dict = {}

    @classmethod
    def from_pretrained(cls, tokenizer_dir: str) -> "CLIPTokenizer":
        with open(os.path.join(tokenizer_dir, "vocab.json")) as f:
            vocab = json.load(f)
        merges: List[tuple] = []
        merges_path = os.path.join(tokenizer_dir, "merges.txt")
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # only the FIRST line is a header ('#version: ...'); later lines
        # beginning with '#' are real merges ('#' is a vocab symbol —
        # transformers' CLIPTokenizer also drops only line 0)
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        for line in lines:
            if not line.strip():
                continue
            parts = line.split()
            if len(parts) == 2:
                merges.append(tuple(parts))
        # derive special-token ids from the vocab itself (standard CLIP
        # checkpoints map them to 49406/49407, but any vocab works)
        kwargs = {}
        if "<|startoftext|>" in vocab:
            kwargs["bos_token_id"] = vocab["<|startoftext|>"]
        if "<|endoftext|>" in vocab:
            kwargs["eos_token_id"] = vocab["<|endoftext|>"]
        return cls(vocab, merges, **kwargs)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> ids WITHOUT special tokens."""
        # transformers' CLIPTokenizer (no-ftfy path) runs BasicTokenizer,
        # which space-separates CJK ideographs — each becomes its own
        # word token (with </w>); mirror that for id parity
        text = _CJK.sub(r" \1 ", text)
        text = re.sub(r"\s+", " ", text.strip()).lower()
        if not text:
            return []
        ids: List[int] = []
        for token in _PAT.findall(text):
            token_bytes = "".join(
                self.byte_encoder[b] for b in token.encode("utf-8")
            )
            for bpe_token in self._bpe(token_bytes).split(" "):
                ids.append(self.encoder[bpe_token])
        return ids

    def __call__(
        self,
        texts,
        padding: str = "do_not_pad",
        max_length: Optional[int] = None,
        truncation: bool = True,
    ):
        """Mirrors the transformers call contract the reference relies on:
        returns an object with .input_ids (list of lists)."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = []
        for t in texts:
            ids = [self.bos_token_id] + self.encode(t) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            if padding == "max_length":
                ids = ids + [self.eos_token_id] * (max_length - len(ids))
            out.append(ids)

        class _Batch:
            input_ids = out

        return _Batch()
