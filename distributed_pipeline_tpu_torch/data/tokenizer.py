"""Subword encoding: a copy of ``stable_hash_id`` and the encoder of
``BPEVocab`` from ``distributed_pipeline_tpu/data/tokenizer.py`` (the port
imports nothing of the JAX package, not even its JAX-free modules).

The artifact is the JAX package's plain JSON, ``{"type": "bpe", "merges":
[[a, b], ...], "vocab": {symbol: id}}``. The port encodes in Python only
(the JAX package's C++ encoder computes the same ids). Training a BPE
vocabulary (``train_bpe``) and the tokenizer CLI are ROADMAP A.7b.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Tuple

__all__ = ["BPEVocab", "EOW", "stable_hash_id", "N_RESERVED"]

N_RESERVED = 4  # PAD/BOS/EOS/SEP, data/dataset.py

EOW = "</w>"  # end-of-word marker symbol


def stable_hash_id(token: str, vocab_size: int,
                   n_reserved: int = N_RESERVED) -> int:
    """The stable out-of-vocabulary hash: blake2s-64 little-endian into
    ``[n_reserved, vocab_size)``, the same on every host, run and Python
    hash seed, and the same as the JAX package's."""
    h = int.from_bytes(
        hashlib.blake2s(token.encode(), digest_size=8).digest(), "little")
    return n_reserved + h % (vocab_size - n_reserved)


class BPEVocab:
    """Encoder over a trained BPE artifact: ``encode(text) -> List[int]``
    with ids in ``[N_RESERVED, vocab_size)``, symbols outside the learned
    alphabet hashed by :func:`stable_hash_id`."""

    def __init__(self, artifact: Dict, vocab_size: int):
        self.vocab_size = vocab_size
        self.token_to_id: Dict[str, int] = dict(artifact["vocab"])
        top = max(self.token_to_id.values(), default=0)
        if top >= vocab_size:
            # an out-of-range id would be clamped or fault in the embedding
            # gather; fail here instead
            raise ValueError(
                f"BPE artifact has ids up to {top} but the run's vocab_size "
                f"is {vocab_size}; retrain the tokenizer with a matching "
                f"--vocab_size")
        self.ranks: Dict[Tuple[str, str], int] = {
            tuple(m): i for i, m in enumerate(artifact["merges"])}

    @classmethod
    def load(cls, path: str, vocab_size: int) -> "BPEVocab":
        with open(path) as f:
            return cls(json.load(f), vocab_size)

    def _bpe_word(self, word: str) -> List[str]:
        seq: List[str] = list(word) + [EOW]
        while len(seq) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(seq, seq[1:])):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            seq[best:best + 2] = [seq[best] + seq[best + 1]]
        return seq

    def _id(self, symbol: str) -> int:
        got = self.token_to_id.get(symbol)
        if got is not None:
            return got
        return stable_hash_id(symbol, self.vocab_size)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for word in text.split():
            out.extend(self._id(s) for s in self._bpe_word(word))
        return out
