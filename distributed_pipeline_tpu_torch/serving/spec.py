"""Speculative-decode drafting: the port of
``distributed_pipeline_tpu/serving/spec.py``.

The target model verifies a K-token draft in ONE forward over the chain
``[current, d_1..d_K]`` (``serving/engine.py`` ``verify``); the draft side
lives here, in two kinds:

* ``ngram`` — prompt-lookup decoding on the host, no model work: propose
  the continuation that followed the most recent earlier occurrence of the
  current suffix in ``prompt + generated``;
* ``model`` — a truncated-layer draft: the target's FIRST ``draft_layers``
  blocks with its embeddings, final LayerNorm and tied head, run as a
  second (smaller) ``DecodeEngine``; its parameters are the target's own
  tensors, not copies.

Acceptance lives in the scheduler: token ``g_0`` is always kept (the
non-speculative step's output), ``g_j`` while every earlier draft token
matched (``d_m == g_{m-1}``). Greedy decoding is therefore token-identical
to the non-speculative path, and with temperature the picks are keyed per
(slot, position) as ``decode`` keys them, so the sampled stream is too.
"""

from __future__ import annotations

import numpy as np

from ..models.gpt2 import GPT2Model

__all__ = ["ngram_propose", "truncated_draft", "DRAFT_KINDS"]

DRAFT_KINDS = ("ngram", "model")


def ngram_propose(history: np.ndarray, k: int, max_ngram: int = 2
                  ) -> np.ndarray:
    """Prompt-lookup draft: K tokens, from the continuation after the most
    recent EARLIER occurrence of the current suffix (longest ngram first,
    down to the bare current token). No match -> repeat the current token
    (a free guess; wrong costs nothing, greedy loops make it right)."""
    h = np.asarray(history, np.int64).ravel()
    n = h.shape[0]
    out = np.full(k, h[-1] if n else 0, np.int32)
    for ng in range(min(max_ngram, n), 0, -1):
        suffix = h[n - ng:]
        # candidate start positions of an earlier occurrence, latest first
        starts = np.flatnonzero(h[:n - 1] == suffix[0])
        for s in starts[::-1]:
            if s + ng >= n:  # the "earlier" occurrence IS the suffix itself
                continue
            if np.array_equal(h[s:s + ng], suffix):
                cont = h[s + ng:s + ng + k]
                out[:cont.shape[0]] = cont.astype(np.int32)
                if cont.shape[0] < k and cont.shape[0] > 0:
                    out[cont.shape[0]:] = int(cont[-1])
                return out
        # no occurrence at this ngram width: relax to a shorter suffix
    return out


def truncated_draft(model: GPT2Model, draft_layers: int) -> GPT2Model:
    """Early-exit draft model: a :class:`GPT2Model` of the target's first
    ``draft_layers`` blocks with the target's embeddings, final LayerNorm
    and tied head. Its modules ARE the target's (every parameter is one of
    the target's tensors), so it follows the target's weights with no
    copy."""
    if getattr(model, "family", None) != "gpt2":
        raise ValueError(f"truncated_draft needs the gpt2 family, got "
                         f"{getattr(model, 'family', None)!r}")
    n = int(draft_layers)
    if not 1 <= n < model.num_layers:
        raise ValueError(f"draft_layers must be in [1, {model.num_layers}),"
                         f" got {n}")
    draft = GPT2Model(model.vocab_size, model.seq_len, model.hidden_size,
                      n, model.num_heads, model.dtype, device="meta",
                      attention_impl=model.attention_impl)
    draft.word_emb = model.word_emb
    draft.pos_emb = model.pos_emb
    for i in range(n):
        setattr(draft.backbone, f"block_{i}",
                getattr(model.backbone, f"block_{i}"))
    draft.backbone.ln_f = model.backbone.ln_f
    return draft.train(model.training)
