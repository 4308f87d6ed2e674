"""Dense attention: the port of ``distributed_pipeline_tpu/ops/attention.py``.

One entry point, ``dot_product_attention``, with the semantics of the JAX
package's dense arm ``_xla_attention``: logits in the activation dtype scaled
by ``dh**-0.5``, the additive ``NEG_INF`` pad/causal bias, an f32 softmax
cast back. ``impl="auto"`` means dense, because the flash forward kernel is
not ported yet (ROADMAP A.6); ``"pallas"`` and ``"ring"`` name JAX arms that
have no counterpart here yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dot_product_attention", "make_attention_bias", "causal_bias",
           "NEG_INF"]

NEG_INF = -1e9  # large-negative in bf16-safe range; -inf would NaN the softmax
# on fully-masked rows


def causal_bias(L: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))
    zero = torch.zeros((), dtype=dtype, device=device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=device)
    return torch.where(tri, zero, neg)[None, None]


def make_attention_bias(pad_mask: torch.Tensor, causal: bool = False,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Expand a [B, L] validity mask (optionally + causal triangle) into an
    additive [B, 1, Lq, Lk] bias."""
    b = (1 - pad_mask[:, None, None, :]).to(dtype) * NEG_INF
    if causal:
        b = b + causal_bias(pad_mask.shape[-1], dtype, pad_mask.device)
    return b


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pad_mask: Optional[torch.Tensor],
                     causal: bool) -> torch.Tensor:
    dh = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * torch.tensor(
        dh ** -0.5, dtype=q.dtype, device=q.device)
    if pad_mask is not None:
        logits = logits + make_attention_bias(pad_mask, causal, logits.dtype)
    elif causal:
        logits = logits + causal_bias(q.shape[-2], logits.dtype, q.device)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pad_mask: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          impl: str = "auto") -> torch.Tensor:
    """Multi-head attention on [B, H, L, Dh] tensors; ``pad_mask`` is [B, L]
    (1 = real token)."""
    if impl == "auto":
        return _dense_attention(q, k, v, pad_mask, causal)
    if impl in ("pallas", "ring"):
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported yet: the flash forward "
            f"kernel and ring attention are ROADMAP A.6 and A.8")
    raise ValueError(f"unknown attention impl: {impl!r}")
