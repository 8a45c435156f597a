"""Byte-level BPE tokenizer (RoBERTa/GPT-2 scheme), pure Python, offline.

The port's own copy of ``tubedetr_tpu/models/tokenizer.py``; the two must
encode identically. It loads the standard ``vocab.json`` + ``merges.txt``
assets of RoBERTa; without them a deterministic ``HashTokenizer`` stands in
(tests and synthetic data).

Special tokens follow RoBERTa: <s>=0, <pad>=1, </s>=2, <unk>=3; sequences
are encoded as ``<s> tokens </s>``.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

BOS, PAD, EOS, UNK = 0, 1, 2, 3


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _compile_pretokenizer():
    """The canonical GPT-2/RoBERTa pre-tokenization pattern. HF's slow
    tokenizer compiles exactly this with the ``regex`` module (unicode
    property classes); when available we use the identical pattern so
    pre-tokenization is equal by construction. The ``re`` fallback
    approximates \\p{L}/\\p{N} with ASCII-era classes (it mis-buckets
    underscore runs and non-decimal numerals like Ⅻ into neighboring runs)."""
    try:
        import regex

        return regex.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
            r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
        )
    except ImportError:
        import re

        return re.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+| ?_+"
            r"|\s+(?!\S)|\s+",
            re.UNICODE,
        )


_PRETOKENIZER = _compile_pretokenizer()


def _word_tokenize(text: str) -> List[str]:
    """GPT-2 pre-tokenization: contractions, letter-runs, digit-runs,
    punctuation-runs, each with an optional leading space."""
    return _PRETOKENIZER.findall(text)


class BPETokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.vocab = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "BPETokenizer":
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and (word[i], word[i + 1]) == best
                ):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids: List[int] = []
        for tok in _word_tokenize(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.vocab.get(piece, UNK))
        if add_special:
            ids = [BOS] + ids + [EOS]
        return ids


class HashTokenizer:
    """Deterministic stand-in when no vocab assets are available: hashes
    whitespace words into a fixed id range. NOT compatible with pretrained
    text encoders — for tests / synthetic training only."""

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        import hashlib

        ids = []
        for word in text.lower().split():
            h = int(hashlib.md5(word.encode()).hexdigest(), 16)
            ids.append(4 + (h % (self.vocab_size - 4)))
        if add_special:
            ids = [BOS] + ids + [EOS]
        return ids


def build_tokenizer(tokenizer_path: Optional[str] = None, vocab_size: int = 50265):
    if tokenizer_path and os.path.exists(
        os.path.join(tokenizer_path, "vocab.json")
    ):
        return BPETokenizer.from_dir(tokenizer_path)
    return HashTokenizer(vocab_size)
