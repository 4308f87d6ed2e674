"""Token-level cross-entropy: the port of
``distributed_pipeline_tpu/ops/xent.py`` (its single-device branch; the
vocab-parallel decomposition comes with tensor parallelism, ROADMAP A.8g).

``nll = logsumexp(logits) - logits[target]``, with the softmax statistics
in f32 whatever the logits' dtype, and the target logit gathered in the
logits' dtype before the cast, as the JAX package does.
"""

from __future__ import annotations

import torch

__all__ = ["token_cross_entropy"]


def token_cross_entropy(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Per-token ``-log p(target)`` (f32) for ``logits [..., V]`` and
    integer ``targets [...]``."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse - tgt.float()
