"""Mixture-of-experts MLP with top-k routing: the port of
``distributed_pipeline_tpu/models/moe.py``.

The JAX formulation (GShard / Switch Transformer), written with torch ops:

* **Dense dispatch**: routing is one-hot dispatch and combine tensors
  ``[B, L, E, C]`` contracted with einsums; no ragged shape, no gather
  loop, no host sync (the serving engine captures the no-drop path in a
  CUDA graph, and a training step never waits on the host for it).
* **Capacity with residual overflow**: each expert takes at most
  ``C = max(1, ceil(L/E * capacity_factor * k))`` tokens a sequence;
  overflow tokens fall through on the residual path. Slots are claimed in
  strict positional priority (position j's k-th choice outranks every
  claim at positions > j), so routing is causal.
* **Load-balance aux loss** (Switch eq. 4): ``E * sum_e f_e * p_e`` over
  the first choice, masked to live tokens. The module returns its raw
  statistics ``(F [E], P [E], n)`` beside its output; the losses form the
  aux from them (:func:`moe_aux`), from the GLOBAL batch's counts under a
  process group, and add ``MOE_AUX_WEIGHT * aux`` to the objective.

**Under sequence parallelism** (a ``parallel/ring.py`` sequence context
of S ranks, each holding an L/S slice) the routing is the JAX function's
over the GLOBAL sequence: the capacity takes the global ``L`` (the slice
length times S), and the position-major cumsum of a row's claims starts
from the claims of the slices before this rank, per batch row and
expert: one ``[B, E]`` all-gather of the slices' claim counts over the
sequence group a block (no gradient), which every rank of the group
issues, a slice with no live token too. The load-balance statistics are
summed over all ranks by the trainer (``GlobalMoEStats``).

``no_drop=True`` (inference: ``models/sampling.py`` and the serving
engine pass it) computes the exact per-token top-k mixture over all
experts, which makes cached and uncached decoding give the same tokens.
The expert products stay ``torch.einsum``: the JAX package computes them
outside any Pallas kernel too. Expert parallelism is ROADMAP A.8g.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist
from ..parallel.ring import current_sequence

__all__ = ["MoEMlp", "moe_mlp_fwd", "moe_aux", "moe_live_count",
           "GlobalMoEStats", "MOE_AUX_WEIGHT", "MoEStats"]

MOE_AUX_WEIGHT = 0.01  # Switch Transformer's load-balance loss coefficient

# one MoE block's raw load-balance sums: top-1 dispatch counts F [E], router
# probability sums P [E] over live tokens, the live-token count n (0-d)
MoEStats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes, by comparison (no
    bounds check, so no host sync on a CUDA tensor)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_mlp_fwd(mp: Dict[str, torch.Tensor], x: torch.Tensor,
                pad_mask: Optional[torch.Tensor], *, top_k: int,
                capacity_factor: float, dtype: torch.dtype,
                no_drop: bool = False, return_stats: bool = False):
    """The MoE MLP as a function of ``{"router": [D, E] f32, "wi":
    [E, D, M], "wo": [E, M, D]}``, as the JAX ``moe_mlp_fwd``: returns
    ``(y, aux, dispatch-or-None)``. ``return_stats=True`` returns the raw
    sums ``(F [E], P [E], n)`` in place of the finished aux, so a caller
    can sum them over ranks before forming ``E * sum_e (F/n)(P/n)``; only
    ``P`` is differentiable. ``dispatch`` is the ``[B, L, E, C]`` one-hot
    routing plan in ``x``'s dtype (None under ``no_drop``); in a sequence
    context, this rank's L slice of the global plan."""
    B, L, D = x.shape
    E = mp["wi"].shape[0]
    K = min(top_k, E)
    seq = None if no_drop else current_sequence()
    S = seq.size if seq is not None else 1
    # the capacity is the global sequence's
    C = max(1, math.ceil(L * S / E * capacity_factor * K))
    router_w, wi, wo = mp["router"], mp["wi"], mp["wo"]

    # router in f32 (a small op; the softmax statistics want the precision)
    logits = torch.einsum("bld,de->ble", x.float(), router_w)
    probs = torch.softmax(logits, dim=-1)                # [B, L, E]

    # pads neither claim capacity nor steer the load-balance statistics
    live = (torch.ones((B, L), dtype=torch.float32, device=x.device)
            if pad_mask is None else pad_mask.float())

    # iterative top-k: pick (the first maximal index, as jnp.argmax), mask
    # out, repeat
    remaining = probs
    gates: List[torch.Tensor] = []
    masks: List[torch.Tensor] = []
    for _ in range(K):
        mask = _one_hot(torch.argmax(remaining, dim=-1), E)  # [B, L, E]
        remaining = remaining * (1.0 - mask)
        mask = mask * live[..., None]
        gates.append((probs * mask).sum(-1))             # [B, L]
        masks.append(mask)

    # Switch load balance over the first choice, masked to live tokens; the
    # stats carry the raw live count (the clamp belongs to moe_aux, once)
    n_live = torch.clamp(live.sum(), min=1.0)
    F_sum = masks[0].sum(dim=(0, 1))                     # [E]
    P_sum = (probs * live[..., None]).sum(dim=(0, 1))    # [E]
    aux = ((F_sum, P_sum, live.sum()) if return_stats
           else E * torch.sum(F_sum / n_live * (P_sum / n_live)))

    if no_drop:
        # every expert for every token, combined by the normalized top-k
        # gates: E x the MLP FLOPs, inference only
        gate_mat = sum(g[..., None] * m for g, m in zip(gates, masks))
        denom_all = torch.clamp(sum(gates), min=1e-9)    # [B, L]
        w = gate_mat / denom_all[..., None]              # [B, L, E]
        h = torch.einsum("bld,edm->belm", x.to(dtype), wi.to(dtype))
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("belm,emd->beld", h, wo.to(dtype))
        y = torch.einsum("ble,beld->bld", w.to(dtype), out)
        return y.to(x.dtype), aux, None

    # capacity: interleave the K claim streams position-major, [B, L*K, E],
    # so slot occupancy at position j counts only claims from positions <= j
    claims = torch.stack(masks, dim=2).reshape(B, L * K, E)
    pos = torch.cumsum(claims, dim=1) - claims           # [B, L*K, E]
    if S > 1:
        # the slices before this rank's claim first: each row's claims
        # per expert from every slice ([S, B, E]), summed over the
        # earlier ones
        counts = dist.sequence_all_gather(claims.sum(dim=1), seq)
        pos = pos + counts[:seq.index].sum(dim=0)[:, None, :]
    keep_flat = claims * (pos < C)
    slot_idx = (pos * keep_flat).sum(-1).long()
    slot_flat = _one_hot(slot_idx, C)
    keep = keep_flat.reshape(B, L, K, E)
    slot = slot_flat.reshape(B, L, K, C)

    # normalize the kept gates so the combine weights sum to <= 1
    kept_gate = [g * keep[:, :, k].sum(-1) for k, g in enumerate(gates)]
    denom = torch.clamp(sum(kept_gate), min=1e-9)
    combine = torch.zeros((B, L, E, C), dtype=torch.float32,
                          device=x.device)
    for k, g in enumerate(gates):
        w = (g / denom)[..., None] * keep[:, :, k]       # [B, L, E]
        combine = combine + w[..., None] * slot[:, :, k][:, :, None, :]
    dispatch = (combine > 0).to(x.dtype)

    xin = torch.einsum("blec,bld->ebcd", dispatch, x.to(dtype))
    h = torch.einsum("ebcd,edm->ebcm", xin, wi.to(dtype))
    h = F.gelu(h, approximate="tanh")
    out = torch.einsum("ebcm,emd->ebcd", h, wo.to(dtype))
    y = torch.einsum("blec,ebcd->bld", combine.to(dtype), out)
    return y.to(x.dtype), aux, dispatch


class MoEMlp(nn.Module):
    """Top-k routed mixture of tanh-GELU MLP experts, the drop-in for
    ``backbone.Mlp``: parameters ``router`` [D, E], ``wi`` [E, D, 4D] and
    ``wo`` [E, 4D, D] (f32), the flax tree's ``block_i/moe/{router,wi,wo}``.
    ``forward`` returns ``(y, stats)``, ``stats`` the block's raw
    load-balance sums (:data:`MoEStats`)."""

    def __init__(self, hidden: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16, expand: int = 4,
                 device=None) -> None:
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        # zeros, not random: weights come from a checkpoint (convert.py)
        self.router = nn.Parameter(torch.zeros((hidden, num_experts), **f32))
        self.wi = nn.Parameter(torch.zeros(
            (num_experts, hidden, expand * hidden), **f32))
        self.wo = nn.Parameter(torch.zeros(
            (num_experts, expand * hidden, hidden), **f32))

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                no_drop: bool = False) -> Tuple[torch.Tensor, MoEStats]:
        y, stats, _ = moe_mlp_fwd(
            {"router": self.router, "wi": self.wi, "wo": self.wo}, x,
            pad_mask, top_k=self.top_k, capacity_factor=self.capacity_factor,
            dtype=self.dtype, no_drop=no_drop, return_stats=True)
        return y, stats


@dataclasses.dataclass(frozen=True)
class GlobalMoEStats:
    """What a rank needs to form its share of the aux from the global
    microbatch's statistics: ``n`` the global live-token count (0-d f32)
    and ``all_reduce`` the sum of a ``[blocks, E]`` count tensor over the
    ranks."""

    n: torch.Tensor
    all_reduce: Callable[[torch.Tensor], torch.Tensor]


def moe_live_count(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The live (non-pad) tokens the routers see in ``batch``, f32 0-d: a
    rank's part of the global count ``n``."""
    return batch["pad_mask"].float().sum()


def moe_aux(stats: Sequence[MoEStats], num_experts: int,
            global_stats: Optional[GlobalMoEStats] = None) -> torch.Tensor:
    """The load-balance aux summed over the MoE blocks (the JAX
    ``moe_aux_from`` sums the sowed terms), each ``E * sum_e (F_e/n)(P_e/n)``
    with ``n`` clamped to >= 1. With ``global_stats`` the counts are the
    global microbatch's (``F`` all-reduced, the global ``n``) and ``P``
    stays this rank's: the result is this rank's share, the ranks' shares
    sum to the global aux, and its gradient in ``P`` is the global one."""
    F_blocks = torch.stack([s[0] for s in stats])        # [blocks, E]
    n = stats[0][2]
    if global_stats is not None:
        F_blocks = global_stats.all_reduce(F_blocks)
        n = global_stats.n
    n = torch.clamp(n, min=1.0)
    terms = [num_experts * torch.sum(f / n * (s[1] / n))
             for f, s in zip(F_blocks.unbind(0), stats)]
    return sum(terms[1:], terms[0])
