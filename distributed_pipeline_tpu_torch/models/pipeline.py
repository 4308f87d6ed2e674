"""Stacked layer weights and the GPipe schedule: the port of
``distributed_pipeline_tpu/models/pipeline.py``.

* **Stacked weights** (``scan_layers``): :class:`PipelinedBlocks` holds
  every block weight once with a leading ``[num_layers]`` dim (the JAX
  ``STACKED_AXES`` layout: ``qkv [L, D, 3, H, Dh]``, ``out [L, H, Dh, D]``,
  ``wi [L, D, 4D]``, ``wo [L, 4D, D]``, the LayerNorms ``[L, D]``) and
  applies them in a Python loop over that dim (:func:`stage_apply`, the
  JAX ``lax.scan``). :func:`block_fwd` is the math of ``backbone.Block``
  as a function of one layer's slice, op for op, so a stacked model and
  a named-block model on the same weights agree bitwise. ``remat`` runs
  each layer under ``torch.utils.checkpoint`` when gradients are on.
  Stacked blocks decode through the dense cache (``DenseKV`` a layer).
* **Stages**: under a pipe group of S ranks (``--pipe S``) a rank's
  ``PipelinedBlocks`` holds only its stage's rows of each weight
  (``parallel/partition.ShardLayout`` binds them: stage s holds layers
  ``[s*L/S, (s+1)*L/S)``, or under the interleaved schedule the V slices
  of virtual stages ``j*S + s``). :class:`PipeContext` is a rank's pipe
  group, schedule and counters, made current by :func:`pipe_parallel`;
  the family losses read it (``models/schedule_1f1b.py``).
* **GPipe** (:func:`gpipe_stream`, ``--pp_schedule gpipe``): the
  microbatch splits into ``pp_chunks`` chunks; stage 0 embeds each chunk,
  every stage applies its layers and hands the result to the next stage
  (``dist.pipe_exchange``), and the last stage runs the loss head. Then
  autograd goes back through the stream: the last stage's backward gives
  each chunk's input cotangent, handed to the stage before, and so on.
  Every chunk's autograd residuals live until the backward, so activation
  memory grows with ``pp_chunks`` (the JAX GPipe contract); the 1F1B
  schedule is the one whose memory stays flat.

* **MoE groups** (:class:`MoEScanBlocks`, ``scan_layers`` with
  ``moe_experts`` > 0): the JAX layout of ``G = num_layers / moe_every``
  groups, ``dense_*`` ``[G, moe_every - 1, ...]`` and ``moe_*``
  ``[G, ...]`` (``moe_router [G, D, E]``, ``moe_wi [G, E, D, 4D]``,
  ``moe_wo [G, E, 4D, D]``); :func:`moe_stage_apply` runs a group's dense
  layers and its MoE block in order and returns each group's raw
  load-balance sums. Under a pipe group a stage holds ``G/S`` groups and
  runs the GPipe stream; its groups' sums accumulate over every chunk and
  the aux is formed from them once a microbatch (the JAX
  ``MoEScanBlocks._moe_schedule``). There is no KV-cache decode: the
  samplers recompute the full forward.
* **fsdp inside a stage**: the stage's cut weights are gathered once a
  microbatch and held across its ticks (``parallel/fsdp.py``); with
  ``remat`` each layer gathers its own weights inside its checkpointed
  body (``PipelinedBlocks.gather``), the JAX ``stage_apply`` placement.

Attention inside a stage keeps the model's ``attention_impl`` (``auto``:
the flash kernels for CUDA tensors from L >= 1024, the ring inside a
sequence context), the arm the JAX pipe-1 path takes; JAX clamps
``auto`` to dense attention inside its ``shard_map`` stages, and takes
its in-shard ring under a sequence axis (ROADMAP C.18a).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import dot_product_attention
from ..parallel import dist
from .backbone import STACKED_PAGED_REFUSAL, DenseKV, dense_cached_attention
from .moe import MoEStats, moe_mlp_fwd

__all__ = ["LAYERS", "STACKED_AXES", "PipelinedBlocks", "block_fwd",
           "block_attn", "stage_apply", "scan_unroll_for", "stage_layers",
           "PipeContext", "pipe_parallel", "current_pipe", "gpipe_stream",
           "StageFns", "MoEScanBlocks", "moe_stage_apply", "moe_block_fwd",
           "MOE_SCAN_NO_CACHE"]

LAYERS = "layers"
EMBED, HEADS, KV, MLP = "embed", "heads", "kv", "mlp"

# the logical axes of every stacked block weight (the JAX table; the pipe
# axis shards LAYERS, parallel/partition.py's stacked rules)
STACKED_AXES = {
    "ln1_scale": (LAYERS, None),
    "ln1_bias": (LAYERS, None),
    "qkv": (LAYERS, EMBED, None, HEADS, KV),
    "out": (LAYERS, HEADS, KV, EMBED),
    "ln2_scale": (LAYERS, None),
    "ln2_bias": (LAYERS, None),
    "wi": (LAYERS, EMBED, MLP),
    "wo": (LAYERS, MLP, EMBED),
}


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """f32 layernorm, ``backbone.LayerNorm``'s."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps=eps)


def _block_mlp(lp: Dict[str, torch.Tensor], x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    h = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"]).to(dtype)
    h = torch.einsum("bld,dm->blm", h, lp["wi"].to(dtype))
    h = F.gelu(h, approximate="tanh")
    return x + torch.einsum("blm,md->bld", h, lp["wo"].to(dtype))


def block_attn(lp: Dict[str, torch.Tensor], x: torch.Tensor,
               pad_mask: Optional[torch.Tensor], *, dtype: torch.dtype,
               causal: bool, attention_impl: str = "auto",
               kv: Optional[DenseKV] = None,
               cache_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pre-LN attention half of a block (ln1, self-attention through
    the seam, residual); ``kv`` attends through a dense decode cache."""
    h = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"]).to(dtype)
    qkv = torch.einsum("bld,dthk->tbhlk", h, lp["qkv"].to(dtype))
    q, k, v = qkv[0], qkv[1], qkv[2]
    if kv is not None:
        o = dense_cached_attention(q, k, v, pad_mask, cache_index, kv,
                                   attention_impl)
    else:
        o = dot_product_attention(q, k, v, pad_mask, causal=causal,
                                  impl=attention_impl)
    return x + torch.einsum("bhlk,hkd->bld", o, lp["out"].to(dtype))


def block_fwd(lp: Dict[str, torch.Tensor], x: torch.Tensor,
              pad_mask: Optional[torch.Tensor], *, dtype: torch.dtype,
              causal: bool, attention_impl: str = "auto",
              kv: Optional[DenseKV] = None,
              cache_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pre-LN block as a function of one layer's weights (a row of the
    stacked weights): ``backbone.Block``'s math."""
    x = block_attn(lp, x, pad_mask, dtype=dtype, causal=causal,
                   attention_impl=attention_impl, kv=kv,
                   cache_index=cache_index)
    return _block_mlp(lp, x, dtype)


def moe_block_fwd(lp: Dict[str, torch.Tensor], x: torch.Tensor,
                  pad_mask: Optional[torch.Tensor], *, dtype: torch.dtype,
                  causal: bool, attention_impl: str, top_k: int,
                  capacity_factor: float, no_drop: bool = False
                  ) -> Tuple[torch.Tensor, MoEStats]:
    """One MoE block as a function of one group's ``moe_*`` row (names
    without the prefix): the attention half, then ln2 and the routed
    experts (``models/moe.moe_mlp_fwd``); returns the block's output and
    its raw load-balance sums. The named ``backbone.Block``'s math."""
    x = block_attn(lp, x, pad_mask, dtype=dtype, causal=causal,
                   attention_impl=attention_impl)
    h = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"]).to(dtype)
    y, stats, _ = moe_mlp_fwd(
        {"router": lp["router"], "wi": lp["wi"], "wo": lp["wo"]}, h,
        pad_mask, top_k=top_k, capacity_factor=capacity_factor,
        dtype=dtype, no_drop=no_drop, return_stats=True)
    return x + y, stats


def scan_unroll_for(n_steps: int, knob: int = 0,
                    total: Optional[int] = None) -> int:
    """The JAX unroll factor of a stacked-layer scan of ``n_steps`` (0 =
    auto: unroll stacks of <= 16 layers fully, keep longer ones a true
    scan; else ``min(knob, n_steps)``). Eager PyTorch has no scan to
    unroll: the layer loop runs the same either way, so the factor only
    validates ``--scan_unroll`` as the JAX entry point reads it."""
    if knob <= 0:
        return n_steps if (total if total is not None else n_steps) <= 16 \
            else 1
    return min(knob, n_steps)


def _gathered_block(gather: Callable[[int], Dict[str, torch.Tensor]],
                    row: int, one: Dict[str, torch.Tensor], h: torch.Tensor,
                    mask: Optional[torch.Tensor], **kw) -> torch.Tensor:
    return block_fwd({**one, **gather(row)}, h, mask, **kw)


def stage_apply(lp: Dict[str, torch.Tensor], h: torch.Tensor,
                mask: Optional[torch.Tensor], *, dtype: torch.dtype,
                causal: bool, attention_impl: str = "auto",
                remat: bool = False,
                kv_cache: Optional[Sequence[DenseKV]] = None,
                cache_index: Optional[torch.Tensor] = None,
                gather: Optional[Callable[[int], Dict[str, torch.Tensor]]]
                = None, row0: int = 0) -> torch.Tensor:
    """Apply the stacked layers ``lp`` (each ``[n, ...]``) to ``h`` in
    order: the JAX stage scan. Each weight is unbound once (one stacked
    gradient in the backward, not one full-size gradient a layer);
    ``remat`` checkpoints each layer when gradients are on; ``kv_cache``
    (a ``DenseKV`` a row) decodes through the dense cache. ``gather(r)``
    (fsdp under remat) gives the cut weights of the rank's row ``r``
    whole, called inside each layer's body (so the checkpoint regathers
    them in the backward); ``lp`` then holds the other weights, and its
    row i is the rank's row ``row0 + i``."""
    rows = {k: torch.unbind(v, 0) for k, v in lp.items()}
    n = len(next(iter(rows.values())))
    remat = remat and torch.is_grad_enabled() and kv_cache is None
    for i in range(n):
        one = {k: r[i] for k, r in rows.items()}
        kv = None if kv_cache is None else kv_cache[i]
        if gather is not None:
            fn = functools.partial(_gathered_block, gather, row0 + i)
            kw = dict(dtype=dtype, causal=causal,
                      attention_impl=attention_impl)
            h = (torch.utils.checkpoint.checkpoint(
                fn, one, h, mask, use_reentrant=False,
                preserve_rng_state=False, **kw) if remat
                else fn(one, h, mask, **kw))
        elif remat:
            # the blocks draw no random numbers: no RNG state to keep
            h = torch.utils.checkpoint.checkpoint(
                block_fwd, one, h, mask, use_reentrant=False,
                preserve_rng_state=False, dtype=dtype, causal=causal,
                attention_impl=attention_impl)
        else:
            h = block_fwd(one, h, mask, dtype=dtype, causal=causal,
                          attention_impl=attention_impl, kv=kv,
                          cache_index=cache_index)
    return h


def stage_layers(num_layers: int, stages: int, index: int,
                 virtual: int = 1) -> Tuple[int, ...]:
    """The layers stage ``index`` of ``stages`` holds, in the order of its
    rows: ``[index*L/S, (index+1)*L/S)``, or with ``virtual`` V > 1 the V
    slices of virtual stages ``j*S + index`` (j = 0..V-1), each
    ``L/(S*V)`` layers: the JAX ``_interleave_stack`` order, a static
    assignment here (no weight permute a step)."""
    SV = stages * virtual
    if num_layers % SV:
        raise ValueError(
            f"num_layers {num_layers} not divisible by pipe axis "
            f"{stages}" + (f" x pp_virtual {virtual}" if virtual > 1
                           else ""))
    per = num_layers // SV
    return tuple(layer for j in range(virtual)
                 for layer in range((j * stages + index) * per,
                                    (j * stages + index + 1) * per))


def _ones(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=torch.float32,
                                   device=device))


def _zeros(shape, device) -> nn.Parameter:
    # zeros, not random: weights come from a checkpoint (convert.py)
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device))


class PipelinedBlocks(nn.Module):
    """``num_layers`` pre-LN blocks with stacked weights (the JAX module's
    parameters and shapes, names ``ln1_scale`` .. ``wo``), applied in
    order over the leading dim. A pipe rank's rows are its stage's layers
    (the trainer rebinds the parameters to them); the module applies
    whatever rows it holds."""

    def __init__(self, num_layers: int, hidden: int, num_heads: int,
                 dtype: torch.dtype, device=None,
                 attention_impl: str = "auto", causal: bool = False,
                 remat: bool = False) -> None:
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by heads "
                             f"{num_heads}")
        L, D, H = num_layers, hidden, num_heads
        dh = D // H
        self.num_layers = num_layers
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.causal = causal
        self.remat = remat
        # fsdp inside a stage under remat: the rank's row -> its cut
        # weights whole (``parallel/fsdp.FsdpUnits.layer``), or None
        self.gather: Optional[Any] = None
        self.ln1_scale = _ones((L, D), device)
        self.ln1_bias = _zeros((L, D), device)
        self.qkv = _zeros((L, D, 3, H, dh), device)
        self.out = _zeros((L, H, dh, D), device)
        self.ln2_scale = _ones((L, D), device)
        self.ln2_bias = _zeros((L, D), device)
        self.wi = _zeros((L, D, 4 * D), device)
        self.wo = _zeros((L, 4 * D, D), device)

    def stacked(self) -> Dict[str, torch.Tensor]:
        """The weights this module holds, by their JAX names."""
        return {name: getattr(self, name) for name in STACKED_AXES}

    def virtual_slice(self, virtual: int, j: int) -> Dict[str, torch.Tensor]:
        """Rows ``[j*n/V, (j+1)*n/V)`` of every weight: virtual slice j of
        a pipe rank's rows (all of them at V = 1)."""
        out = {}
        gather = self.gather
        skip = gather.names if gather is not None and gather.active else ()
        for name, w in self.stacked().items():
            if name in skip:
                continue    # gathered a layer at a time (apply_rows)
            per = w.shape[0] // virtual
            out[name] = w.narrow(0, j * per, per)
        return out

    def apply_rows(self, lp: Dict[str, torch.Tensor], x: torch.Tensor,
                   pad_mask: Optional[torch.Tensor], row0: int = 0
                   ) -> torch.Tensor:
        """:func:`stage_apply` of ``lp`` (the rank's rows from ``row0``)
        with this module's fields; under an active ``gather`` the cut
        weights come from it, layer by layer."""
        gather = self.gather
        if gather is not None and gather.active:
            lp = {k: v for k, v in lp.items() if k not in gather.names}
        else:
            gather = None
        return stage_apply(lp, x, pad_mask, dtype=self.dtype,
                           causal=self.causal,
                           attention_impl=self.attention_impl,
                           remat=self.remat, gather=gather, row0=row0)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                cache_index: Optional[torch.Tensor] = None,
                kv_cache: Optional[Sequence[Any]] = None) -> torch.Tensor:
        if kv_cache is None:
            return self.apply_rows(self.stacked(), x, pad_mask)
        # the dense decode (the JAX ``_decode``): one DenseKV a layer, a
        # full-length call the prefill, a one-token call a step
        n = self.qkv.shape[0]
        if len(kv_cache) != n or not all(isinstance(c, DenseKV)
                                         for c in kv_cache):
            raise NotImplementedError(STACKED_PAGED_REFUSAL)
        return stage_apply(self.stacked(), x, pad_mask, dtype=self.dtype,
                           causal=True, attention_impl=self.attention_impl,
                           kv_cache=kv_cache, cache_index=cache_index)


# the JAX MoEScanBlocks' refusal of a cache (the samplers recompute)
MOE_SCAN_NO_CACHE = ("MoE scan blocks have no KV-cache decode path; sample "
                     "with use_cache=False")
# a stacked block's per-layer weights (the MoE groups' dense_* and moe_*
# rows carry them beside the expert weights)
_PER_LAYER = ("ln1_scale", "ln1_bias", "qkv", "out", "ln2_scale",
              "ln2_bias")


def moe_stage_apply(lp: Dict[str, torch.Tensor], h: torch.Tensor,
                    mask: Optional[torch.Tensor], *, dtype: torch.dtype,
                    causal: bool, attention_impl: str, remat: bool,
                    top_k: int, capacity_factor: float,
                    no_drop: bool = False
                    ) -> Tuple[torch.Tensor, List[MoEStats]]:
    """Apply MoE groups to ``h``: ``lp`` holds ``dense_*`` ``[Gl, nd, ...]``
    and ``moe_*`` ``[Gl, ...]`` (the :class:`MoEScanBlocks` layout, or a
    pipe stage's groups). Each group runs its ``nd`` dense layers, then its
    MoE block; returns ``(h, stats)``, one group's raw load-balance sums
    ``(F [E], P [E], n)`` a list entry (the JAX ``moe_stage_apply``).
    ``remat`` checkpoints each dense layer and each MoE block when
    gradients are on."""
    dense = {k[len("dense_"):]: v for k, v in lp.items()
             if k.startswith("dense_")}
    moe = {k[len("moe_"):]: torch.unbind(v, 0) for k, v in lp.items()
           if k.startswith("moe_")}
    G = len(moe["qkv"])
    nd = dense["qkv"].shape[1] if dense else 0
    # one unbind a weight over the groups' layers (rows g*nd .. g*nd+nd-1)
    drows = {k: torch.unbind(v.reshape((G * nd,) + v.shape[2:]), 0)
             for k, v in dense.items()}
    remat = remat and torch.is_grad_enabled()
    kw = dict(dtype=dtype, causal=causal, attention_impl=attention_impl)
    stats: List[MoEStats] = []
    for g in range(G):
        for j in range(nd):
            one = {k: r[g * nd + j] for k, r in drows.items()}
            h = (torch.utils.checkpoint.checkpoint(
                block_fwd, one, h, mask, use_reentrant=False,
                preserve_rng_state=False, **kw) if remat
                else block_fwd(one, h, mask, **kw))
        one = {k: r[g] for k, r in moe.items()}
        fn = functools.partial(moe_block_fwd, top_k=top_k,
                               capacity_factor=capacity_factor,
                               no_drop=no_drop, **kw)
        if remat:
            h, st = torch.utils.checkpoint.checkpoint(
                fn, one, h, mask, use_reentrant=False,
                preserve_rng_state=False)
        else:
            h, st = fn(one, h, mask)
        stats.append(st)
    return h, stats


class MoEScanBlocks(nn.Module):
    """Stacked blocks where every ``moe_every``-th block's MLP is a routed
    mixture of experts (the JAX module of that name, ``params/backbone/
    blocks``): ``G = num_layers / moe_every`` groups, each ``moe_every -
    1`` dense layers (``dense_<name>`` ``[G, moe_every - 1, ...]``, absent
    at ``moe_every`` 1) and one MoE block (``moe_<name>`` ``[G, ...]``
    with ``moe_router``, ``moe_wi``, ``moe_wo``). ``forward`` appends each
    group's raw load-balance sums to ``moe_stats``; it has no KV-cache
    decode. A pipe rank's rows are its stage's groups."""

    def __init__(self, num_layers: int, hidden: int, num_heads: int,
                 dtype: torch.dtype, device=None,
                 attention_impl: str = "auto", causal: bool = False,
                 remat: bool = False, moe_experts: int = 4,
                 moe_top_k: int = 2, moe_every: int = 2,
                 moe_capacity_factor: float = 1.25) -> None:
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by heads "
                             f"{num_heads}")
        if num_layers % moe_every:
            raise ValueError(f"num_layers {num_layers} not divisible by "
                             f"moe_every {moe_every} (scan groups must be "
                             f"uniform)")
        D, H, E = hidden, num_heads, moe_experts
        G, nd = num_layers // moe_every, moe_every - 1
        self.num_layers = num_layers
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.causal = causal
        self.remat = remat
        self.top_k = moe_top_k
        self.capacity_factor = moe_capacity_factor
        shapes = {"ln1_scale": (D,), "ln1_bias": (D,),
                  "qkv": (D, 3, H, D // H), "out": (H, D // H, D),
                  "ln2_scale": (D,), "ln2_bias": (D,)}
        for name, shape in ({**shapes, "wi": (D, 4 * D),
                             "wo": (4 * D, D)}.items() if nd else ()):
            init = _ones if name.endswith("_scale") else _zeros
            setattr(self, f"dense_{name}", init((G, nd) + shape, device))
        for name, shape in {**shapes, "router": (D, E),
                            "wi": (E, D, 4 * D),
                            "wo": (E, 4 * D, D)}.items():
            init = _ones if name.endswith("_scale") else _zeros
            setattr(self, f"moe_{name}", init((G,) + shape, device))

    def stacked(self) -> Dict[str, torch.Tensor]:
        """The weights this module holds, by their JAX names."""
        return dict(self.named_parameters())

    def apply_rows(self, lp: Dict[str, torch.Tensor], x: torch.Tensor,
                   pad_mask: Optional[torch.Tensor],
                   no_drop: bool = False
                   ) -> Tuple[torch.Tensor, List[MoEStats]]:
        """:func:`moe_stage_apply` of ``lp`` with this module's fields."""
        return moe_stage_apply(lp, x, pad_mask, dtype=self.dtype,
                               causal=self.causal,
                               attention_impl=self.attention_impl,
                               remat=self.remat, top_k=self.top_k,
                               capacity_factor=self.capacity_factor,
                               no_drop=no_drop)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                cache_index: Optional[torch.Tensor] = None,
                kv_cache: Optional[Sequence[Any]] = None,
                moe_no_drop: bool = False,
                moe_stats: Optional[List[MoEStats]] = None) -> torch.Tensor:
        if cache_index is not None or kv_cache is not None:
            raise ValueError(MOE_SCAN_NO_CACHE)
        x, stats = self.apply_rows(self.stacked(), x, pad_mask, moe_no_drop)
        if moe_stats is not None:
            moe_stats.extend(stats)
        return x


# ------------------------------------------------------------- the stages

@dataclasses.dataclass
class PipeContext:
    """A rank's pipe group and schedule for one run: ``group``
    (``dist.PipeGroup``), ``schedule`` (gpipe, 1f1b or interleaved),
    ``chunks`` (``pp_chunks``: chunks a microbatch), ``virtual`` (V, 1
    but under interleaved), the exchange's timer (an ``EventTimer`` or
    None), and counters: the most stage inputs the 1F1B stash held at
    once, the F and B slots run."""

    group: dist.PipeGroup
    schedule: str = "1f1b"
    chunks: int = 4
    virtual: int = 1
    timer: Any = None
    stash_peak: int = 0
    f_slots: int = 0
    b_slots: int = 0

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def index(self) -> int:
        return self.group.index

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int, int]],
                 recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, int,
                                       int]],
                 device: torch.device) -> List[torch.Tensor]:
        """``dist.pipe_exchange``, timed into ``timer``."""
        if not sends and not recvs:
            return []
        if self.timer is None:
            return dist.pipe_exchange(self.group, sends, recvs, device)
        with self.timer.measure(device):
            return dist.pipe_exchange(self.group, sends, recvs, device)


_active: List[PipeContext] = []


@contextlib.contextmanager
def pipe_parallel(ctx: Optional[PipeContext]) -> Iterator[None]:
    """Inside the block the family losses run as this rank's stage of
    ``ctx``'s schedule (nothing changes for None or a pipe of one)."""
    if ctx is None or ctx.size <= 1:
        yield
        return
    _active.append(ctx)
    try:
        yield
    finally:
        _active.pop()


def current_pipe() -> Optional[PipeContext]:
    """The innermost ``pipe_parallel`` context, or None."""
    return _active[-1] if _active else None


@dataclasses.dataclass
class StageFns:
    """One microbatch's stage functions, chunk by chunk (the JAX engine's
    ``pre_fn``/``stage_fn``/``mask_fn``/``head_fn``): ``pre(c)`` embeds
    chunk c (stage 0), ``stage(j, h, mask)`` applies virtual slice j of
    this rank's rows, ``mask(c)`` is chunk c's pad mask, ``head(h, c)``
    gives chunk c's loss contribution and metrics (last stage);
    ``shape``/``dtype`` are a chunk activation's, ``device`` the
    rank's."""

    pre: Callable[[int], torch.Tensor]
    stage: Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor]
    mask: Callable[[int], torch.Tensor]
    head: Callable[[torch.Tensor, int],
                   Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    # after the forward stream: this rank's extra loss term (joins the
    # backward; an MoE stage's weighted aux share) and its metrics
    aux: Optional[Callable[[], Tuple[Optional[torch.Tensor],
                                     Dict[str, torch.Tensor]]]] = None


def _add(acc: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]
         ) -> Dict[str, torch.Tensor]:
    for k, v in new.items():
        v = v.detach()
        acc[k] = v if k not in acc else acc[k] + v
    return acc


def gpipe_stream(ctx: PipeContext, fns: StageFns
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The GPipe schedule with its backward (module doc): returns this
    rank's loss contribution and metrics (the last stage's chunk sums,
    zeros elsewhere); the gradients accumulate into the parameters'
    ``.grad`` (and into any leaves ``fns`` closes over)."""
    S, s, M = ctx.size, ctx.index, ctx.chunks
    first, last = s == 0, s == S - 1
    dev = fns.device
    ins: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    losses: List[torch.Tensor] = []
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    metrics: Dict[str, torch.Tensor] = {}
    for c in range(M):
        if first:
            h_in = fns.pre(c)
        else:
            h_in = ctx.exchange([], [(fns.shape, fns.dtype, -1, c)], dev)[0]
            h_in.requires_grad_()
        ctx.f_slots += 1
        h_out = fns.stage(0, h_in, fns.mask(c))
        if last:
            lc, mc = fns.head(h_out, c)
            losses.append(lc)
            # chunk by chunk, the 1F1B engine's (and JAX's) order
            loss = loss + lc.detach()
            _add(metrics, mc)
        else:
            ctx.exchange([(h_out, 1, c)], [], dev)
        ins.append(h_in)
        outs.append(h_out)
    extra = None
    if fns.aux is not None:
        extra, mx = fns.aux()
        _add(metrics, mx)
    # autograd back through the stream, the last stage first
    ctx.b_slots += M
    if last:
        torch.autograd.backward(losses + ([extra] if extra is not None
                                          else []))
    else:
        cots = ctx.exchange([], [(fns.shape, fns.dtype, 1, c)
                                 for c in range(M)], dev)
        if extra is not None:
            outs, cots = outs + [extra], cots + [None]
        torch.autograd.backward(outs, cots)
    if not first:
        ctx.exchange([(h.grad, -1, c) for c, h in enumerate(ins)], [], dev)
    return loss, metrics
