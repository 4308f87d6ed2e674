"""Attention: the port of ``distributed_pipeline_tpu/ops/attention.py``.

One entry point, ``dot_product_attention``, over four arms:

* ``impl="xla"``  - dense einsum attention with the semantics of the JAX
  package's ``_xla_attention``: logits in the activation dtype scaled by
  ``dh**-0.5``, the additive ``NEG_INF`` pad/causal bias, an f32 softmax
  cast back. It keeps the JAX name so configs carry over;
* ``impl="cuda"`` - the flash kernels (``ops/flash_attention.py``), forward
  and backward; CUDA tensors only. ``"pallas"`` is accepted as the JAX name
  of this arm;
* ``impl="torch"`` - the flash kernels' plain version, with gradients;
* ``impl="ring"`` - ring attention over the ``sequence_parallel`` context's
  group (``parallel/ring.py``): q, k, v and the mask are this rank's L
  slices. Outside a context it raises, as the JAX ring does without a
  mesh; inside a context of more than one rank every other arm raises
  (it would see this rank's slice alone, where the JAX arms see global
  arrays).

``impl="auto"`` is the JAX rule with the TPU read as the card: the ring
inside a sequence context of more than one rank (the JAX rule under a
mesh whose sequence axis is larger than 1), else the flash kernel for
CUDA tensors with ``L >= 1024``, dense otherwise.
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
    # the scale rounded to q's dtype, as a 0-d host tensor: a scalar
    # operand, so no host-to-device copy (which a CUDA graph cannot
    # capture and the sanitizer refuses)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * torch.tensor(
        dh ** -0.5, dtype=q.dtype)
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
    from ..parallel.ring import current_sequence
    seq = current_sequence()
    split = seq is not None and seq.size > 1
    if impl == "auto":
        if split:
            impl = "ring"  # sequence-parallel ranks: attention must ring
        else:
            # flash from ~1k context up, where the JAX package measured it
            # ahead of dense and its memory is O(L) in both directions
            impl = ("cuda" if q.device.type == "cuda"
                    and q.shape[-2] >= 1024 else "xla")
    if split and impl != "ring":
        # the other arms would attend to this rank's L slice alone
        raise ValueError(f"attention impl {impl!r} inside a sequence "
                         f"context of {seq.size} ranks: only the ring "
                         f"attends across the L slices")
    if impl == "xla":
        return _dense_attention(q, k, v, pad_mask, causal)
    if impl in ("cuda", "pallas", "torch"):
        from .flash_attention import flash_attention
        return flash_attention(q, k, v, pad_mask, causal,
                               impl="torch" if impl == "torch" else "cuda")
    if impl == "ring":
        from ..parallel.ring import ring_attention
        return ring_attention(q, k, v, pad_mask, causal)
    raise ValueError(f"unknown attention impl: {impl!r}")
