"""Sampling helpers: the port of the truncation step of
``distributed_pipeline_tpu/models/sampling.py``. The batch decoders there
(``gpt2_decode``, the DiffuSeq samplers) come with ROADMAP A.7."""

from __future__ import annotations

import torch

__all__ = ["_truncate_logits"]


def _truncate_logits(l: torch.Tensor, top_k: int,
                     top_p: float) -> torch.Tensor:
    """Top-k / nucleus truncation of f32 logits [..., V]: cut entries become
    ``-inf``. Same rule as the JAX package: top-k keeps every entry >= the
    k-th largest, and nucleus keeps the smallest sorted prefix whose mass
    reaches ``top_p`` (the crossing token stays in)."""
    if top_k > 0:
        k = min(top_k, l.shape[-1])  # top_k >= vocab means no truncation
        kth = torch.topk(l, k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, torch.full_like(l, float("-inf")), l)
    if 0.0 < top_p < 1.0:
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, sorted_l,
                             torch.full_like(sorted_l, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        l = torch.where(l < cutoff, torch.full_like(l, float("-inf")), l)
    return l
