"""Byte-pair-free toy tokenizer: hashed word-piece over bytes.

Deterministic, vocabulary-bounded, reversible enough for pipeline tests --
the framework treats tokenization as a pluggable stage; production would
swap in SentencePiece without touching the pipeline.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

BOS = 1
EOS = 2
PAD = 0
_RESERVED = 4


class HashTokenizer:
    def __init__(self, vocab_size: int = 4096):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> np.ndarray:
        toks = [BOS]
        for w in text.split():
            h = 0
            for ch in w.encode("utf-8"):
                h = (h * 131 + ch) % (self.vocab_size - _RESERVED)
            toks.append(_RESERVED + h)
        toks.append(EOS)
        return np.asarray(toks, np.int32)

    def encode_batch(self, texts: Iterable[str]) -> List[np.ndarray]:
        return [self.encode(t) for t in texts]
