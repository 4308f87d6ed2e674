"""GPT-2-style causal language model: the port of
``distributed_pipeline_tpu/models/gpt2.py``: the forward and the training
loss ``gpt2_losses``.

Parameter names follow the flax tree (``word_emb.embedding``, ``pos_emb``,
``backbone.block_i...``, an MoE block's ``backbone.block_i.moe.{router,wi,
wo}``), so ``state_dict()`` keys are the flax paths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops.xent import token_cross_entropy
from ..parallel.ring import sequence_offset
from .backbone import Embed, LayerKV, TransformerBackbone
from .moe import MOE_AUX_WEIGHT, GlobalMoEStats, MoEStats, moe_aux
from .pipeline import current_pipe

__all__ = ["GPT2Model", "gpt2_losses", "gpt2_loss_count", "gpt2_ppl",
           "gpt2_sequence_slice"]


class GPT2Model(nn.Module):
    """Decoder-only causal LM with a weight-tied output head.

    ``forward(ids)`` is the full causal forward. With ``kv_cache`` (one
    ``(pages_k, pages_v)`` pair per layer, or with ``kv_quant="int8"`` one
    ``(pages_k, pages_v, scales_k, scales_v)`` entry over an int8 pool) and
    ``block_table`` it is the paged serving path: a prefill over the prompt
    batch when ``cache_index`` is None, one decode step when ``ids`` is
    [B, 1] and ``cache_index`` holds each slot's position, and a
    speculative-verify span when ``ids`` is [B, L] with ``cache_index``.
    With ``kv_cache`` a list of :class:`DenseKV` (one a layer) it is the
    dense decode: a prefill over the full length, then one token at a time
    at the 0-d position ``cache_index``. ``moe_experts`` > 0 puts a routed
    mixture of experts in every ``moe_every``-th block; ``forward``'s
    ``moe_no_drop`` routes without capacity (inference) and ``moe_stats``
    (a list) collects the MoE blocks' load-balance sums. ``remat``
    recomputes each block in the backward. ``scan_layers`` stacks the
    blocks (``backbone.blocks``, ``models/pipeline.py``); ``pp_chunks``,
    ``pp_schedule`` and ``pp_virtual`` are the pipe schedule's, read
    under a pipe group, and ``scan_unroll`` the JAX scan's unroll knob
    (perf-only there; nothing to unroll here). Parameters start at zero;
    load weights with ``load_state_dict``."""

    family = "gpt2"

    def __init__(self, vocab_size: int, seq_len: int, hidden_size: int = 1024,
                 num_layers: int = 24, num_heads: int = 16,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 attention_impl: str = "auto", moe_experts: int = 0,
                 moe_top_k: int = 2, moe_every: int = 2,
                 moe_capacity_factor: float = 1.25,
                 remat: bool = False, scan_layers: bool = False,
                 pp_chunks: int = 4, pp_schedule: str = "1f1b",
                 pp_virtual: int = 2, scan_unroll: int = 0) -> None:
        super().__init__()
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.moe_every = moe_every
        self.moe_capacity_factor = moe_capacity_factor
        self.remat = remat
        self.scan_layers = scan_layers
        self.pp_chunks = pp_chunks
        self.pp_schedule = pp_schedule
        self.pp_virtual = pp_virtual
        self.scan_unroll = scan_unroll
        self.word_emb = Embed(vocab_size, hidden_size, device)
        self.pos_emb = nn.Parameter(torch.zeros(
            (seq_len, hidden_size), dtype=torch.float32, device=device))
        self.backbone = TransformerBackbone(
            num_layers, hidden_size, num_heads, dtype, device,
            attention_impl, causal=True, moe_experts=moe_experts,
            moe_top_k=moe_top_k, moe_every=moe_every,
            moe_capacity_factor=moe_capacity_factor, remat=remat,
            scan_layers=scan_layers)

    def forward(self, ids: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                cache_index: Optional[torch.Tensor] = None,
                block_table: Optional[torch.Tensor] = None,
                kv_cache: Optional[List[LayerKV]] = None,
                decode_impl: str = "auto",
                kv_quant: str = "fp", moe_no_drop: bool = False,
                moe_stats: Optional[List[MoEStats]] = None
                ) -> torch.Tensor:
        h = self.embed_tokens(ids, cache_index)
        if pad_mask is None:
            pad_mask = torch.ones_like(ids)
        h = self.backbone(h, pad_mask, cache_index, block_table, kv_cache,
                          decode_impl, kv_quant, moe_no_drop, moe_stats)
        return self.lm_head(h)

    def embed_tokens(self, ids: torch.Tensor,
                     cache_index: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Token plus position embeddings in the compute dtype [B, L, D]
        (positions from ``cache_index`` when given, else from 0, or from
        a sequence slice's offset)."""
        B, L = ids.shape
        if cache_index is not None:
            # per-slot positions (continuous-batching decode): each slot
            # sits at its own depth, so the embedding is a gather; a
            # speculative-verify span's link j sits at cache_index + j. A
            # slot whose budget ends mid-span is fed positions past its
            # last token, which can pass the table's end when prompt +
            # budget == seq_len; clamp to the edge (those picks are
            # discarded by the host). A 0-d cache_index is the dense
            # decode's one position for every row
            idx = cache_index.long()
            start = idx.reshape(1, 1) if idx.dim() == 0 else idx[:, None]
            span = start + torch.arange(L, device=ids.device)[None, :]
            pos = self.pos_emb[torch.clamp(span, max=self.seq_len - 1)]
        else:
            # a sequence-parallel rank holds the slice at its offset
            off = sequence_offset(L)
            pos = self.pos_emb[None, off:off + L]
        return (self.word_emb.embedding[ids.long()] + pos).to(self.dtype)

    def lm_head(self, h: torch.Tensor) -> torch.Tensor:
        """The tied LM head in the compute dtype: [B, L, D] -> logits."""
        return torch.einsum("bld,vd->blv", h,
                            self.word_emb.embedding.to(self.dtype))


def _targets(batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(targets, loss mask)`` [B, L - 1], or [B, L] for a sequence
    slice: a slice's last position predicts the next slice's first token,
    which ``next_ids`` / ``next_mask`` [B, 1] carry (mask 0 on the last
    slice, whose final position predicts nothing)."""
    ids = batch["input_ids"]
    mask = batch["input_mask"] * batch["pad_mask"]
    if "next_ids" in batch:
        return (torch.cat([ids[:, 1:], batch["next_ids"]], dim=1),
                torch.cat([mask[:, 1:], batch["next_mask"]], dim=1).float())
    return ids[:, 1:], mask[:, 1:].float()


def _loss_mask(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return _targets(batch)[1]


def gpt2_sequence_slice(batch: Dict[str, torch.Tensor], index: int,
                        size: int) -> Dict[str, torch.Tensor]:
    """Sequence slice ``index`` of ``size`` of a [B, L] batch: every key's
    columns ``[index * L/size, (index + 1) * L/size)``, and ``next_ids`` /
    ``next_mask``, the token after the slice and its loss mask (zeros
    past the end), so the targets come from the global row."""
    L = batch["input_ids"].shape[1]
    n = L // size
    lo, hi = index * n, (index + 1) * n
    out = {k: v[:, lo:hi] for k, v in batch.items()}
    ids = batch["input_ids"]
    if hi < L:
        out["next_ids"] = ids[:, hi:hi + 1]
        out["next_mask"] = (batch["input_mask"]
                            * batch["pad_mask"])[:, hi:hi + 1]
    else:
        out["next_ids"] = torch.zeros_like(ids[:, :1])
        out["next_mask"] = torch.zeros_like(ids[:, :1])
    return out


def gpt2_loss_count(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The predicted positions the loss averages over, f32 0-d: what a
    rank contributes to a global denominator."""
    return _loss_mask(batch).sum()


def gpt2_ppl(loss: torch.Tensor) -> torch.Tensor:
    """Perplexity from a mean NLL (clamped at 20, as the JAX package)."""
    return torch.exp(torch.clamp(loss, max=20.0))


def gpt2_losses(model: GPT2Model, batch: Dict[str, torch.Tensor],
                denom: Optional[torch.Tensor] = None,
                moe_global: Optional[GlobalMoEStats] = None
                ) -> Dict[str, torch.Tensor]:
    """Next-token cross-entropy over the loss span, as the JAX package's
    ``gpt2_losses``: ``loss`` (= ``nll``), teacher-forced ``acc`` and
    ``ppl``, each a 0-d f32 tensor. ``batch`` holds ``input_ids``,
    ``input_mask`` and ``pad_mask`` [B, L], and for a sequence slice
    (``gpt2_sequence_slice``) ``next_ids`` / ``next_mask``. ``denom`` (a global
    microbatch's count, clamped to >= 1) replaces the batch's own: the
    result is then a rank's share, ``loss``, ``nll`` and ``acc`` only,
    which sum over the ranks to the global means (``gpt2_ppl`` of the
    summed loss gives ``ppl``). An MoE model adds ``moe_aux`` (summed
    over its MoE blocks) and ``MOE_AUX_WEIGHT * moe_aux`` to ``loss``;
    ``moe_global`` forms the aux from the global microbatch's counts
    (this rank's share, ``moe.moe_aux``). Under a pipe group
    (``pipeline.pipe_parallel``) the loss runs the pipe schedule
    (``schedule_1f1b.gpt2_1f1b_losses``, the JAX routing): with gradients
    on it also runs the backward, and it returns this rank's shares."""
    ctx = current_pipe()
    if ctx is not None:
        from .schedule_1f1b import gpt2_1f1b_losses
        return gpt2_1f1b_losses(model, batch, denom, ctx, moe_global)
    ids = batch["input_ids"]
    pad_mask = batch["pad_mask"]
    targets, loss_mask = _targets(batch)
    stats: List[MoEStats] = []
    # position j predicts token j + 1: a sequence slice's last position
    # predicts the next slice's first token, the row's last nothing
    logits = model(ids, pad_mask, moe_stats=stats)[:, :targets.shape[1]]
    nll = token_cross_entropy(logits, targets)
    share = denom is not None
    if not share:
        denom = torch.clamp(loss_mask.sum(), min=1.0)
    loss = (nll * loss_mask).sum() / denom
    hit = (torch.argmax(logits, dim=-1) == targets).float()
    acc = (hit * loss_mask).sum() / denom
    out = {"loss": loss, "nll": loss, "acc": acc}
    if not share:
        out["ppl"] = gpt2_ppl(loss)
    if stats:  # an MoE model
        aux = moe_aux(stats, model.moe_experts, moe_global)
        out["moe_aux"] = aux
        out["loss"] = loss + MOE_AUX_WEIGHT * aux
    return out
