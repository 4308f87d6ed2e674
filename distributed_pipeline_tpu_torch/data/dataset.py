"""The synthetic causal-LM dataset: a copy of ``SyntheticLMDataset`` and
the reserved token ids of ``distributed_pipeline_tpu/data/dataset.py``
(copied, not imported: the port imports nothing of the JAX package).

Batch contract, shared with the JAX package::

    batch = {
        "input_ids":  int32 [B, L]   token ids
        "input_mask": int32 [B, L]   1 on the loss span (all of it here)
        "pad_mask":   int32 [B, L]   1 for real tokens
    }
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["SyntheticLMDataset", "PAD_ID", "BOS_ID", "EOS_ID", "SEP_ID",
           "N_RESERVED"]

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
SEP_ID = 3
N_RESERVED = 4


class SyntheticLMDataset:
    """A noisy cyclic-successor chain: 85% of positions follow an order-2
    rule (advance by +7 or +13 in id space by the parity of the token two
    back), 15% are fresh random draws, so next-token loss has a known floor
    and a model that learns the rule generalizes. Item i is drawn from
    ``seed`` and i alone, with the JAX package's generator and order, so
    both packages give the same items."""

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
