"""GPT-2-style causal language model: the port of
``distributed_pipeline_tpu/models/gpt2.py``: the forward and the training
loss ``gpt2_losses``.

Parameter names follow the flax tree (``word_emb.embedding``, ``pos_emb``,
``backbone.block_i...``), so ``state_dict()`` keys are the flax paths.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..ops.xent import token_cross_entropy
from .backbone import Embed, LayerKV, TransformerBackbone

__all__ = ["GPT2Model", "gpt2_losses"]


class GPT2Model(nn.Module):
    """Decoder-only causal LM with a weight-tied output head.

    ``forward(ids)`` is the full causal forward. With ``kv_cache`` (one
    ``(pages_k, pages_v)`` pair per layer, or with ``kv_quant="int8"`` one
    ``(pages_k, pages_v, scales_k, scales_v)`` entry over an int8 pool) and
    ``block_table`` it is the paged serving path: a prefill over the prompt
    batch when ``cache_index`` is None, one decode step when ``ids`` is
    [B, 1] and ``cache_index`` holds each slot's position, and a
    speculative-verify span when ``ids`` is [B, L] with ``cache_index``. Parameters start
    at zero; load weights with ``load_state_dict``."""

    family = "gpt2"

    def __init__(self, vocab_size: int, seq_len: int, hidden_size: int = 1024,
                 num_layers: int = 24, num_heads: int = 16,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 attention_impl: str = "auto") -> None:
        super().__init__()
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.word_emb = Embed(vocab_size, hidden_size, device)
        self.pos_emb = nn.Parameter(torch.zeros(
            (seq_len, hidden_size), dtype=torch.float32, device=device))
        self.backbone = TransformerBackbone(num_layers, hidden_size,
                                            num_heads, dtype, device,
                                            attention_impl, causal=True)

    def forward(self, ids: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                cache_index: Optional[torch.Tensor] = None,
                block_table: Optional[torch.Tensor] = None,
                kv_cache: Optional[List[LayerKV]] = None,
                decode_impl: str = "auto",
                kv_quant: str = "fp") -> torch.Tensor:
        B, L = ids.shape
        if cache_index is not None:
            # per-slot positions (continuous-batching decode): each slot
            # sits at its own depth, so the embedding is a gather; a
            # speculative-verify span's link j sits at cache_index + j. A
            # slot whose budget ends mid-span is fed positions past its
            # last token, which can pass the table's end when prompt +
            # budget == seq_len; clamp to the edge (those picks are
            # discarded by the host)
            span = cache_index.long()[:, None] + torch.arange(
                L, device=ids.device)[None, :]
            pos = self.pos_emb[torch.clamp(span, max=self.seq_len - 1)]
        else:
            pos = self.pos_emb[None, :L]
        h = (self.word_emb.embedding[ids.long()] + pos).to(self.dtype)
        if pad_mask is None:
            pad_mask = torch.ones_like(ids)
        h = self.backbone(h, pad_mask, cache_index, block_table, kv_cache,
                          decode_impl, kv_quant)
        # tied LM head in the compute dtype
        return torch.einsum("bld,vd->blv", h,
                            self.word_emb.embedding.to(self.dtype))


def gpt2_losses(model: GPT2Model, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """Next-token cross-entropy over the loss span, as the JAX package's
    ``gpt2_losses``: ``loss`` (= ``nll``), teacher-forced ``acc`` and
    ``ppl``, each a 0-d f32 tensor. ``batch`` holds ``input_ids``,
    ``input_mask`` and ``pad_mask`` [B, L]. Pipeline (1F1B) and MoE
    training are ROADMAP A.9 and A.8."""
    ids = batch["input_ids"]
    pad_mask = batch["pad_mask"]
    loss_mask = (batch["input_mask"] * pad_mask)[:, 1:].float()
    logits = model(ids, pad_mask)[:, :-1]        # predict ids[:, 1:]
    targets = ids[:, 1:]
    nll = token_cross_entropy(logits, targets)
    denom = torch.clamp(loss_mask.sum(), min=1.0)
    loss = (nll * loss_mask).sum() / denom
    hit = (torch.argmax(logits, dim=-1) == targets).float()
    acc = (hit * loss_mask).sum() / denom
    return {"loss": loss, "nll": loss, "acc": acc,
            "ppl": torch.exp(torch.clamp(loss, max=20.0))}
