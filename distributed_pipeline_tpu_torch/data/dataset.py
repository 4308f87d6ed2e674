"""Datasets: copies of ``SyntheticSeq2SeqDataset``, ``SyntheticLMDataset``,
``WordVocab``, ``JsonlSeq2SeqDataset`` and the reserved token ids of
``distributed_pipeline_tpu/data/dataset.py`` (copied, not imported: the
port imports nothing of the JAX package). Item i of each dataset equals the
JAX package's item i, bit for bit.

Batch contract, shared with the JAX package::

    batch = {
        "input_ids":  int32 [B, L]   source ++ target token ids
        "input_mask": int32 [B, L]   1 on the TARGET span (the diffused
                                     span for DiffuSeq; the loss span for
                                     the causal LM, all of it there)
        "pad_mask":   int32 [B, L]   1 for real tokens, 0 for padding
    }
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .tokenizer import N_RESERVED, BPEVocab, stable_hash_id

__all__ = ["SyntheticSeq2SeqDataset", "SyntheticLMDataset",
           "JsonlSeq2SeqDataset", "WordVocab", "PAD_ID", "BOS_ID", "EOS_ID",
           "SEP_ID", "N_RESERVED"]

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
SEP_ID = 3


def _frame(src, tgt, seq_len: int) -> Dict[str, np.ndarray]:
    """``[BOS] src [SEP] tgt [EOS]`` padded to ``seq_len``; the target span
    includes EOS (the model must learn to stop)."""
    ids = np.full(seq_len, PAD_ID, dtype=np.int32)
    tmask = np.zeros(seq_len, dtype=np.int32)
    pmask = np.zeros(seq_len, dtype=np.int32)
    pos = 0
    ids[pos] = BOS_ID
    pos += 1
    ids[pos:pos + len(src)] = src
    pos += len(src)
    ids[pos] = SEP_ID
    pos += 1
    t0 = pos
    ids[pos:pos + len(tgt)] = tgt
    pos += len(tgt)
    ids[pos] = EOS_ID
    pos += 1
    tmask[t0:pos] = 1
    pmask[:pos] = 1
    return {"input_ids": ids, "input_mask": tmask, "pad_mask": pmask}


class SyntheticSeq2SeqDataset:
    """A synthetic seq2seq task: the target is the source reversed, with a
    fixed cyclic offset in id space. The source length varies per item, so
    rows are padded. Item i is drawn from ``seed`` and i alone, with the JAX
    package's generator and order."""

    def __init__(self, seq_len: int = 128, vocab_size: int = 8192,
                 size: int = 100_000, seed: int = 0):
        if seq_len < 8 or seq_len % 2:
            raise ValueError(f"seq_len must be even and >= 8, got {seq_len}")
        if vocab_size <= N_RESERVED + 8:
            raise ValueError(f"vocab_size must exceed {N_RESERVED + 8}, got "
                             f"{vocab_size}")
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.size = size
        self.seed = seed
        # source and target get half the sequence each, less the framing
        self.src_len = seq_len // 2 - 1             # [BOS] src... [SEP]
        self.tgt_len = seq_len - self.src_len - 3   # ... tgt [EOS]

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 0x9E3779B9 + idx) & 0xFFFFFFFFFFFFFFFF)
        n_src = int(rng.integers(self.src_len // 2, self.src_len + 1))
        lo, hi = N_RESERVED, self.vocab_size
        src = rng.integers(lo, hi, size=n_src, dtype=np.int64)
        tgt = ((src[::-1] - lo + 7) % (hi - lo)) + lo
        tgt = tgt[:min(len(tgt), self.tgt_len)]
        return _frame(src, tgt, self.seq_len)


class SyntheticLMDataset:
    """A noisy cyclic-successor chain: 85% of positions follow an order-2
    rule (advance by +7 or +13 in id space by the parity of the token two
    back), 15% are fresh random draws, so next-token loss has a known floor
    and a model that learns the rule generalizes. Item i is drawn from
    ``seed`` and i alone, with the JAX package's generator and order."""

    def __init__(self, seq_len: int = 128, vocab_size: int = 8192,
                 size: int = 100_000, seed: int = 0):
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 0x9E3779B9 + idx) & 0xFFFFFFFFFFFFFFFF)
        lo, hi = N_RESERVED, self.vocab_size
        span = hi - lo
        noisy = rng.random(self.seq_len) < 0.15
        noise_tok = rng.integers(lo, hi, size=self.seq_len)
        ids = np.empty(self.seq_len, dtype=np.int32)
        ids[0] = BOS_ID
        ids[1] = noise_tok[1]
        for t in range(2, self.seq_len):
            if noisy[t]:
                ids[t] = noise_tok[t]
            else:  # deterministic order-2 successor: hop 7 or 13 by parity
                hop = 7 if (int(ids[t - 2]) - lo) % 2 == 0 else 13
                ids[t] = lo + (int(ids[t - 1]) - lo + hop) % span
        ones = np.ones(self.seq_len, dtype=np.int32)
        return {"input_ids": ids,
                "input_mask": ones.copy(),  # whole sequence is loss span
                "pad_mask": ones}


class WordVocab:
    """Whitespace-token vocabulary in three modes, picked from the file it
    is given: a BPE artifact (``{"type": "bpe", ...}``) -> subword ids; a
    plain ``{token: id}`` map -> word ids (unknown words -> ``N_RESERVED``);
    no file -> each token's :func:`stable_hash_id`."""

    def __init__(self, vocab_size: int, vocab_file: Optional[str] = None):
        self.vocab_size = vocab_size
        self.token_to_id: Optional[Dict[str, int]] = None
        self._bpe: Optional[BPEVocab] = None
        if vocab_file and os.path.exists(vocab_file):
            with open(vocab_file) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and loaded.get("type") == "bpe":
                self._bpe = BPEVocab(loaded, vocab_size)
                self.token_to_id = self._bpe.token_to_id
            else:
                self.token_to_id = loaded

    def encode(self, text: str) -> List[int]:
        if self._bpe is not None:
            return self._bpe.encode(text)
        if self.token_to_id is not None:
            return [self.token_to_id.get(tok, N_RESERVED)
                    for tok in text.split()]
        return [stable_hash_id(tok, self.vocab_size) for tok in text.split()]


class JsonlSeq2SeqDataset:
    """A DiffuSeq-format jsonl corpus: one ``{"src": ..., "trg": ...}``
    object a line in ``{split}.jsonl`` under ``data_dir`` (``"tgt"`` is
    read where ``"trg"`` is missing). Lines are read in Python and blank
    lines (``str.strip()`` empty) skipped, as the JAX package's fallback
    path does; each item is tokenized when it is read. The vocabulary is
    ``data_dir/bpe.json`` when it exists, else ``data_dir/vocab.json``, else
    the stable hash."""

    def __init__(self, data_dir: str, split: str, seq_len: int = 128,
                 vocab_size: int = 8192, vocab_file: Optional[str] = None):
        path = os.path.join(data_dir, f"{split}.jsonl")
        with open(path) as f:
            self.lines = [ln for ln in f if ln.strip()]
        if vocab_file is None:
            bpe = os.path.join(data_dir, "bpe.json")
            vocab_file = bpe if os.path.exists(bpe) else os.path.join(
                data_dir, "vocab.json")
        self.vocab = WordVocab(vocab_size, vocab_file)
        self.seq_len = seq_len
        self.vocab_size = vocab_size

    def __len__(self) -> int:
        return len(self.lines)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        obj = json.loads(self.lines[idx])
        src = self.vocab.encode(str(obj.get("src", "")))
        tgt = self.vocab.encode(str(obj.get("trg", obj.get("tgt", ""))))
        L = self.seq_len
        # truncate the source from the left and the target from the right,
        # so the freshest context survives
        max_src = max(1, (L - 3) // 2)
        src = src[-max_src:]
        tgt = tgt[:L - 3 - len(src)]
        return _frame(src, tgt, L)
