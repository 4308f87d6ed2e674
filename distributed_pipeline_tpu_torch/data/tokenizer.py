"""Subword tokenization: a copy of
``distributed_pipeline_tpu/data/tokenizer.py`` (the port imports nothing of
the JAX package, not even its JAX-free modules): a self-contained
byte-pair-encoding (BPE) trainer and encoder.

* :func:`train_bpe` - learn merges from an iterable of texts (greedy
  highest-frequency pair merging over whitespace words with an end-of-word
  marker, the Sennrich et al. 2016 procedure);
* :class:`BPEVocab` - encode through the learned merges; symbols map to
  stable ids, out-of-alphabet symbols hash stably (:func:`stable_hash_id`).
  The merge loop runs in C++ (``native/bpe_encoder.cpp``, the same ids)
  when the native library builds, in Python otherwise;
* CLI: ``python -m distributed_pipeline_tpu_torch.data.tokenizer --data_dir
  DIR --vocab_size N`` reads ``DIR/train.jsonl`` and writes
  ``DIR/bpe.json``, which ``JsonlSeq2SeqDataset`` picks up (it prefers
  ``bpe.json`` over a word-level ``vocab.json``).

The artifact is the JAX package's plain JSON, ``{"type": "bpe", "merges":
[[a, b], ...], "vocab": {symbol: id}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import warnings
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["train_bpe", "BPEVocab", "EOW", "stable_hash_id", "N_RESERVED",
           "main"]

N_RESERVED = 4  # PAD/BOS/EOS/SEP, data/dataset.py

EOW = "</w>"  # end-of-word marker symbol


def stable_hash_id(token: str, vocab_size: int,
                   n_reserved: int = N_RESERVED) -> int:
    """The stable out-of-vocabulary hash: blake2s-64 little-endian into
    ``[n_reserved, vocab_size)``, the same on every host, run and Python
    hash seed, and the same as the JAX package's. Every OOV fallback
    (word-level, BPE, the native encoder's sentinels) goes through it."""
    h = int.from_bytes(
        hashlib.blake2s(token.encode(), digest_size=8).digest(), "little")
    return n_reserved + h % (vocab_size - n_reserved)


def train_bpe(texts: Iterable[str], vocab_size: int,
              n_reserved: int = N_RESERVED) -> Dict:
    """Learn a BPE vocabulary of at most ``vocab_size - n_reserved`` symbols
    and return the JSON-serializable artifact. Greedy: repeatedly merge
    the most frequent adjacent symbol pair across the word-frequency table
    until the symbol budget is reached or no pair repeats."""
    budget = vocab_size - n_reserved
    if budget <= 0:
        raise ValueError(f"vocab_size {vocab_size} <= reserved {n_reserved}")
    word_freq = Counter(w for t in texts for w in t.split())
    words: Dict[Tuple[str, ...], int] = {
        tuple(w) + (EOW,): f for w, f in word_freq.items()}
    symbols = sorted({s for seq in words for s in seq})
    merges: List[Tuple[str, str]] = []
    while len(symbols) < budget:
        pairs: Counter = Counter()
        for seq, f in words.items():
            for a, b in zip(seq, seq[1:]):
                pairs[(a, b)] += f
        if not pairs:
            break
        (a, b), freq = pairs.most_common(1)[0]
        if freq < 2:
            break  # merging singletons only pads the vocab
        merges.append((a, b))
        merged = a + b
        symbols.append(merged)
        new_words: Dict[Tuple[str, ...], int] = {}
        for seq, f in words.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + f
        words = new_words
    vocab = {s: n_reserved + i for i, s in enumerate(symbols)}
    return {"type": "bpe", "merges": [list(m) for m in merges],
            "vocab": vocab}


class BPEVocab:
    """Encoder over a trained BPE artifact: ``encode(text) -> List[int]``
    with ids in ``[N_RESERVED, vocab_size)``, symbols outside the learned
    alphabet hashed by :func:`stable_hash_id`; the same ids through the
    native encoder (``_native``) or the Python merge loop."""

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
        # the merge loop is the input pipeline's host-side hot spot: the C++
        # encoder (the same contract) when the library loads, this Python
        # path otherwise (load_library warns once when it cannot build)
        self._native = None
        from ..native import NativeBPE, load_library
        if load_library() is not None:
            try:
                self._native = NativeBPE(
                    [list(m) for m in artifact["merges"]], self.token_to_id,
                    vocab_size, N_RESERVED)
            except RuntimeError as e:
                warnings.warn(f"native BPE library loaded but encoder init "
                              f"failed ({e!r}); tokenizing in pure Python")

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
        words = text.split()
        if self._native is not None:
            try:
                return self._native.encode_words(words)
            except (RuntimeError, UnicodeDecodeError) as e:
                warnings.warn(f"native BPE encode failed ({e!r}); "
                              f"tokenizing in pure Python for the rest of "
                              f"the process")
                self._native = None
        out: List[int] = []
        for word in words:
            out.extend(self._id(s) for s in self._bpe_word(word))
        return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train a BPE vocabulary on ``DATA_DIR/{split}.jsonl`` (its ``src``
    and ``trg``/``tgt`` texts) and write ``DATA_DIR/bpe.json``; prints and
    returns ``{"written", "merges", "symbols"}``."""
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_dir", required=True,
                   help="directory holding train.jsonl; bpe.json is written "
                        "here")
    p.add_argument("--vocab_size", type=int, default=8192)
    p.add_argument("--split", default="train")
    ns = p.parse_args(argv)

    path = os.path.join(ns.data_dir, f"{ns.split}.jsonl")
    texts = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            texts.append(str(obj.get("src", "")))
            texts.append(str(obj.get("trg", obj.get("tgt", ""))))
    artifact = train_bpe(texts, ns.vocab_size)
    out = os.path.join(ns.data_dir, "bpe.json")
    with open(out, "w") as f:
        json.dump(artifact, f)
    result = {"written": out, "merges": len(artifact["merges"]),
              "symbols": len(artifact["vocab"])}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
