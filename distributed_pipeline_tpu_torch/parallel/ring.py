"""Ring attention over a sequence process group: the port of
``distributed_pipeline_tpu/parallel/ring.py``.

Sequence (context) parallelism: each rank of a sequence group holds an
L/n slice of every activation, ``[B, H, L/n, Dh]`` for q, k and v, and
attention runs as a ring. Each rank keeps its query slice while the key
and value slices (with their pad mask) go round the group
(``parallel/dist.py`` ``ring_shift``, the JAX ``ppermute``). On every hop
a rank attends its queries to the visiting block through
``ops.flash_attention.flash_attention_lse`` (the kernels on a CUDA
tensor, their plain versions on a CPU one) and folds the block's
normalized output into a running online softmax with the block's
log-sum-exp, in f32, so the result is exactly softmax attention over the
whole sequence. The fold's weights are functions of the lse, so the
gradient reaches each hop's lse too, and the hop's backward folds that
cotangent into its delta (``g_lse``).

Under a causal mask the block from this rank's own slice (the diagonal
hop) runs the causal kernel, a block from an earlier slice the full
kernel, and a block from a later slice contributes nothing: zero output
and lse ``NEG_INF``, weight 0 in the fold, and no launch.

Collective order. Every rank must issue the same sends and receives in
the same order, forward and backward:

* K, V and the mask move in ONE autograd op a hop (``_RingShift``), so a
  rank issues one batch of point-to-point operations a hop; its backward
  sends the K and V cotangents the other way round (the transpose of
  ``ppermute``). The hops chain, so their backwards run in reverse hop
  order on every rank;
* a later slice's hop (``_Skipped``) still takes that hop's K and V as
  inputs, so the shift that delivered them stays on every rank's autograd
  graph and its backward runs everywhere (a rank whose graph dropped it
  would leave its partner waiting);
* the last hop's shift is skipped: its result would be unused.

``sequence_parallel(seq)`` stands in for the JAX ambient mesh
(``current_mesh``): inside it, ``ops.attention.dot_product_attention``
with ``impl="auto"`` rings when the group has more than one rank, and
the models offset their position embeddings by ``sequence_offset``. The
context is process-wide, not thread-local: the autograd engine runs a
CUDA backward (and a rematerialized block's forward) on a thread of its
own.

``ring_attention`` takes this rank's slices; ``_dense_block_attn`` is the
plain per-hop version (``use_flash=False``), kept for the tests. The
ring's shifts, forward and backward, are timed into the context's
``shift_timer`` when it has one (``utils.perf.EventTimer``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch

from ..ops.flash_attention import flash_attention_lse
from ..utils.perf import EventTimer
from . import dist

NEG_INF = -1e9

__all__ = ["ring_attention", "sequence_parallel", "current_sequence",
           "sequence_offset", "NEG_INF"]

_active: List[Tuple[dist.SequenceGroups, Optional[EventTimer]]] = []


@contextlib.contextmanager
def sequence_parallel(seq: dist.SequenceGroups,
                      shift_timer: Optional[EventTimer] = None
                      ) -> Iterator[dist.SequenceGroups]:
    """Inside the block, attention and position embeddings run as this
    rank's slice of ``seq`` (its group, sequence index and size); the
    ring's shifts are timed into ``shift_timer``."""
    _active.append((seq, shift_timer))
    try:
        yield seq
    finally:
        _active.pop()


def current_sequence() -> Optional[dist.SequenceGroups]:
    """The innermost ``sequence_parallel`` context's groups, or None."""
    return _active[-1][0] if _active else None


def sequence_offset(local_len: int) -> int:
    """The global position of this rank's first token: ``index *
    local_len`` in a sequence context, else 0."""
    seq = current_sequence()
    return 0 if seq is None else seq.index * local_len


def _timed_shift(tensors, seq: dist.SequenceGroups,
                 timer: Optional[EventTimer], reverse: bool = False
                 ) -> List[torch.Tensor]:
    if timer is None:
        return dist.ring_shift(tensors, seq, reverse)
    with timer.measure(tensors[0].device):
        return dist.ring_shift(tensors, seq, reverse)


class _RingShift(torch.autograd.Function):
    """K, V (and the mask, when there is one) one step round the ring;
    the backward turns K's and V's cotangents the other way."""

    @staticmethod
    def forward(ctx, seq, timer, *tensors):
        ctx.seq, ctx.timer = seq, timer
        out = _timed_shift(tensors, seq, timer)
        if len(out) > 2:
            ctx.mark_non_differentiable(out[2])
        return tuple(out)

    @staticmethod
    def backward(ctx, g_k, g_v, *g_mask):
        g_k, g_v = _timed_shift([g_k, g_v], ctx.seq, ctx.timer,
                                reverse=True)
        return (None, None, g_k, g_v) + (None,) * len(g_mask)


class _Skipped(torch.autograd.Function):
    """A later slice's hop under a causal mask: zero output and lse
    ``NEG_INF``, no launch. K and V are inputs (with no cotangent) only
    to keep the shift that delivered them on the graph."""

    @staticmethod
    def forward(ctx, q, k, v):
        B, H, L, _ = q.shape
        return (torch.zeros_like(q),
                torch.full((B, H, L), NEG_INF, dtype=torch.float32,
                           device=q.device))

    @staticmethod
    def backward(ctx, g_out, g_lse):
        return None, None, None


def _dense_block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kmask: Optional[torch.Tensor], causal: bool,
                      q_off: int, k_off: int, sm_scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop in dense einsums: ``(normalized out, lse)`` with f32
    statistics, as the JAX ``_dense_block_attn``; materializes the
    ``[Lq, Lk]`` scores (tests only)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kmask is not None:
        s = s + (1.0 - kmask.float())[:, None, None, :] * NEG_INF
    if causal:
        Lq, Lk = q.shape[-2], k.shape[-2]
        rows = q_off + torch.arange(Lq, device=q.device)[:, None]
        cols = k_off + torch.arange(Lk, device=q.device)[None, :]
        s = torch.where((rows >= cols)[None, None], s,
                        torch.full((), NEG_INF, device=q.device))
    live = s > NEG_INF / 2
    m = s.amax(dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = pv / torch.clamp(l, min=1e-20)[..., None]
    lse = m + torch.log(torch.clamp(l, min=1e-20))
    return out, lse


def _flash_block_attn(q, k, v, kmask, causal: bool, my: int, src: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop through ``flash_attention_lse``: the kernels on a CUDA
    tensor, the plain versions on a CPU one; under a causal mask the
    diagonal, an earlier or a later slice (see the module doc)."""
    impl = "cuda" if q.device.type == "cuda" else "torch"
    if causal and src > my:
        return _Skipped.apply(q, k, v)
    return flash_attention_lse(q, k, v, kmask, causal and src == my, impl)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pad_mask: Optional[torch.Tensor] = None,
                   causal: bool = False, use_flash: bool = True
                   ) -> torch.Tensor:
    """Exact attention over this rank's slices ``[B, H, L/n, Dh]`` (and
    ``pad_mask`` [B, L/n]) of a sequence split over the
    ``sequence_parallel`` context's group (raises outside one). Each hop
    yields a normalized block output and its lse; the fold re-weights by
    ``exp(lse - m_run)``, in f32. ``use_flash=False`` runs the dense
    per-hop version."""
    if not _active:
        raise ValueError("ring attention needs a sequence group: run inside "
                         "parallel.ring.sequence_parallel(...)")
    seq, timer = _active[-1]
    n, my = seq.size, seq.index
    L_local = q.shape[-2]
    sm_scale = q.shape[-1] ** -0.5
    B, H, _, D = q.shape
    acc = torch.zeros((B, H, L_local, D), dtype=torch.float32,
                      device=q.device)
    m_run = torch.full((B, H, L_local), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, H, L_local), dtype=torch.float32,
                        device=q.device)
    k_blk, v_blk, mask_blk = k, v, pad_mask
    for i in range(n):
        src = (my - i) % n           # the slice this K/V block came from
        if use_flash:
            out_blk, lse_blk = _flash_block_attn(q, k_blk, v_blk, mask_blk,
                                                 causal, my, src)
        else:
            out_blk, lse_blk = _dense_block_attn(
                q, k_blk, v_blk, mask_blk, causal, my * L_local,
                src * L_local, sm_scale)
        m_new = torch.maximum(m_run, lse_blk)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(lse_blk - m_new)
        acc = acc * alpha[..., None] + out_blk.float() * beta[..., None]
        l_run = l_run * alpha + beta
        m_run = m_new
        if i < n - 1:
            moved = _RingShift.apply(
                seq, timer, k_blk, v_blk,
                *(() if mask_blk is None else (mask_blk,)))
            k_blk, v_blk = moved[0], moved[1]
            mask_blk = moved[2] if mask_blk is not None else None
    return (acc / torch.clamp(l_run, min=1e-20)[..., None]).to(q.dtype)
