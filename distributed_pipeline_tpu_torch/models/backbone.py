"""Shared transformer backbone: the port of
``distributed_pipeline_tpu/models/backbone.py``.

Same layout and numerics as the flax modules, so a flax parameter tree loads
key for key (``convert.py``): fused ``qkv`` ``[D, 3, H, Dh]``, ``out``
``[H, Dh, D]``, pre-LN blocks with LayerNorm in f32 at eps 1e-6 (flax's
default), a tanh-GELU MLP with 4x expansion, compute in ``dtype`` over f32
parameters, a final ``ln_f``.

Attention runs one of three branches:

* the full forward (``kv_cache is None``): the attention seam
  (``ops.attention.dot_product_attention``) with the model's
  ``attention_impl``, which takes the flash kernels from L >= 1024 on CUDA,
  causal or bidirectional by the module's ``causal`` field (the JAX field
  of that name: GPT-2 sets it, the DiffuSeq denoiser does not);
* paged prefill (``kv_cache`` given, L > 1, no ``cache_index``): write the
  prompt's K/V into the pool, then causal attention on the local k/v
  through the same seam;
* paged single-token decode (``cache_index`` [B] per-slot positions, L == 1):
  write the token's K/V, then the decode seam
  (``ops.flash_decode.paged_decode_attention``);
* paged speculative-verify span (``cache_index`` [B], L > 1): each slot's L
  chain links sit at positions ``idx .. idx + L - 1``; every link's K/V is
  written first, then one span dispatch
  (``ops.flash_decode.paged_span_attention``) attends link j at ``idx + j``
  over the live prefix plus the earlier links;
* the dense decode cache (a layer's ``kv`` is a :class:`DenseKV`): a
  full-length call is the prefill, which keeps every position's K/V and
  runs causal attention through the seam (so the flash forward from
  L >= 1024 on CUDA); a single-token call with a 0-d ``cache_index`` i
  writes position i and attends densely over ``cache[0..i]``.

``kv_quant`` names the pool's storage, as the JAX module attribute of that
name does: ``"fp"`` pools hold the compute dtype and a layer's KV entry is
``(pages_k, pages_v)``; ``"int8"`` pools hold int8 pages and the entry is
``(pages_k, pages_v, scales_k, scales_v)`` with ``[P]`` f32 scales, written
by the ``_q8`` writers and dequantized by both decode arms. The prefill's own
attention runs on the local fp k/v either way.

A block whose ``moe_experts`` > 0 swaps its MLP for a top-k routed
mixture of experts (``models/moe.py``, submodule ``moe``): the backbone
puts one in every ``moe_every``-th block (``i % moe_every == moe_every -
1``, as the JAX backbone). A block returns ``(x, stats)``, ``stats`` its
MoE load-balance sums or None, and the backbone appends each MoE block's
to the caller's ``moe_stats`` list: the statistics are outputs, never
state kept on a module, so a block recomputed under ``remat`` cannot
overwrite or double them. ``moe_no_drop=True`` routes every token to its
exact top-k experts (inference), in place of the JAX
``clone(moe_no_drop=True)``: one module serves both routings.

``remat=True`` runs each block under ``torch.utils.checkpoint`` (the JAX
``nn.remat(Block)``) when gradients are enabled: only the block's input
is kept, and the block runs again in the backward. Without gradients
(sampling, serving, eval) it runs plainly.

``scan_layers=True`` holds the blocks as one stacked module
(``models/pipeline.py`` ``PipelinedBlocks``, submodule ``blocks``: each
weight once with a leading ``[num_layers]`` dim, the JAX layout) and runs
them in a loop over that dim, as the JAX backbone routes to
``PipelinedBlocks``; with ``moe_experts`` > 0 the submodule is the JAX
``MoEScanBlocks`` (groups of ``moe_every - 1`` dense layers and one MoE
block). A pipe group cuts the leading dim into stages
(``models/schedule_1f1b.py``). Stacked blocks decode through the dense
cache only, and stacked MoE blocks not at all (the samplers recompute):
a paged cache raises the JAX refusal.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.flash_decode import paged_decode_attention, paged_span_attention
from ..serving.paged_kv import (write_prompt_kv, write_prompt_kv_q8,
                                write_span_kv, write_span_kv_q8,
                                write_token_kv, write_token_kv_q8)
from .moe import MoEMlp, MoEStats

__all__ = ["TransformerBackbone", "Block", "Mlp", "SelfAttention",
           "LayerNorm", "Embed", "DenseKV", "dense_cached_attention",
           "STACKED_PAGED_REFUSAL"]


class DenseKV:
    """One layer's dense decode cache, the JAX ``decode=True`` "cache"
    collection: K and V ``[B, H, Lmax, Dh]`` in the compute dtype, sized
    and filled by the first (full-length, prefill) call and updated in
    place by each single-token call."""

    def __init__(self) -> None:
        self.k: Optional[torch.Tensor] = None
        self.v: Optional[torch.Tensor] = None


# one layer's (pages_k, pages_v), or (pages_k, pages_v, scales_k, scales_v)
# for an int8 pool, or a dense decode cache
LayerKV = Union[Tuple[torch.Tensor, ...], DenseKV]
KV_QUANTS = ("fp", "int8")
# the JAX backbone's refusal of a paged cache for stacked weights
STACKED_PAGED_REFUSAL = ("paged decode needs per-layer named blocks; stacked "
                         "(scan_layers) models use the dense cache path")


def dense_cached_attention(q, k, v, pad_mask, cache_index, cache: DenseKV,
                           attention_impl: str = "auto") -> torch.Tensor:
    """Attention of one layer through its dense decode cache (the JAX
    ``decode=True`` contract): a full-length call (or the first, which
    sizes the cache) is the prefill, keeping every position's K/V and
    attending causally through the seam; a single-token call writes
    position ``cache_index`` (0-d) and attends densely over
    ``cache[0..cache_index]``. Named blocks and the stacked blocks
    (``models/pipeline.py``) both attend through it."""
    B, H, L, Dh = q.shape
    if cache.k is None or L == cache.k.shape[2]:
        # prefill (the first call sizes the cache): keep every
        # position's K/V, attend causally through the seam
        cache.k = k.clone(memory_format=torch.contiguous_format)
        cache.v = v.clone(memory_format=torch.contiguous_format)
        return dot_product_attention(q, k, v, pad_mask, causal=True,
                                     impl=attention_impl)
    Lmax = cache.k.shape[2]
    if L != 1:
        raise ValueError(
            f"decode calls take the full length ({Lmax}, prefill) or a "
            f"single token, got {L}")
    if cache_index is None:
        raise ValueError("single-token decode needs cache_index")
    # the position as a device tensor (no host sync), clamped to the
    # cache as JAX's dynamic_update_slice clamps it
    idx = torch.clamp(cache_index.reshape(1).long(), 0, Lmax - 1)
    cache.k.index_copy_(2, idx, k)
    cache.v.index_copy_(2, idx, v)
    # positions beyond idx hold stale or unwritten rows: masked
    # (causality IS this mask for one query row)
    live = (torch.arange(Lmax, device=q.device)[None, :]
            <= idx).to(torch.int32).expand(B, Lmax)
    if pad_mask is not None:
        live = live * pad_mask
    return dot_product_attention(q, cache.k, cache.v, live,
                                 causal=False, impl="xla")


def _param(shape, device) -> nn.Parameter:
    # zeros, not random: weights come from a checkpoint (convert.py)
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device))


class Embed(nn.Module):
    """flax ``nn.Embed``: one f32 ``embedding`` table [vocab, dim]."""

    def __init__(self, vocab_size: int, dim: int, device=None) -> None:
        super().__init__()
        self.embedding = _param((vocab_size, dim), device)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: statistics and output in f32,
    eps 1e-6, parameters ``scale`` and ``bias``."""

    def __init__(self, dim: int, device=None) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            eps=1e-6)


class SelfAttention(nn.Module):
    """Multi-head self-attention with QKV fused into one [D, 3, H, Dh]
    product."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 device=None, attention_impl: str = "auto",
                 causal: bool = False) -> None:
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by heads "
                             f"{num_heads}")
        dh = hidden // num_heads
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.causal = causal
        self.qkv = _param((hidden, 3, num_heads, dh), device)
        self.out = _param((num_heads, dh, hidden), device)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                cache_index: Optional[torch.Tensor] = None,
                block_table: Optional[torch.Tensor] = None,
                kv: Optional[LayerKV] = None,
                decode_impl: str = "auto",
                kv_quant: str = "fp") -> torch.Tensor:
        qkv = torch.einsum("bld,dthk->tbhlk", x, self.qkv.to(self.dtype))
        q, k, v = qkv[0], qkv[1], qkv[2]
        if isinstance(kv, DenseKV):
            if block_table is not None:
                raise ValueError("block_table is only meaningful with a "
                                 "paged KV cache")
            o = dense_cached_attention(q, k, v, pad_mask, cache_index, kv,
                                       self.attention_impl)
        elif kv is not None:
            if block_table is None:
                raise ValueError("paged attention needs a block_table")
            o = self._paged_attention(q, k, v, pad_mask, cache_index,
                                      block_table, kv, decode_impl, kv_quant)
        else:
            if block_table is not None:
                raise ValueError("block_table is only meaningful with a "
                                 "paged KV cache")
            o = dot_product_attention(q, k, v, pad_mask, causal=self.causal,
                                      impl=self.attention_impl)
        return torch.einsum("bhlk,hkd->bld", o, self.out.to(self.dtype))

    def _paged_attention(self, q, k, v, pad_mask, cache_index, block_table,
                         kv, decode_impl, kv_quant):
        if kv_quant not in KV_QUANTS:
            raise ValueError(f"kv_quant must be fp|int8, got {kv_quant!r}")
        quant = kv_quant == "int8"
        if len(kv) != (4 if quant else 2):
            raise ValueError(f"a kv_quant={kv_quant!r} layer's KV entry "
                             f"holds {4 if quant else 2} tensors, got "
                             f"{len(kv)}")
        pages_k, pages_v = kv[:2]
        sk, sv = kv[2:] if quant else (None, None)
        B, H, L, Dh = q.shape
        if L > 1 and cache_index is None:
            # prefill: write the prompt's K/V into its slots' pages; the
            # attention itself runs on the local (contiguous) k/v, exactly
            # the dense prefill computation (int8 included: quantization
            # touches only the pool's copy)
            valid = pad_mask if pad_mask is not None else torch.ones(
                (B, L), dtype=torch.int32, device=q.device)
            if quant:
                write_prompt_kv_q8(pages_k, sk, block_table, k, valid)
                write_prompt_kv_q8(pages_v, sv, block_table, v, valid)
            else:
                write_prompt_kv(pages_k, block_table, k, valid)
                write_prompt_kv(pages_v, block_table, v, valid)
            return dot_product_attention(q, k, v, pad_mask, causal=True,
                                         impl=self.attention_impl)
        if cache_index is None or cache_index.dim() != 1:
            raise ValueError("paged decode needs a per-slot cache_index "
                             "vector [B]")
        idx = cache_index.to(torch.int32)
        if L > 1:
            # speculative-verify span: write every link's K/V (overshoot
            # past the table's reach clamps to its last cell), then one
            # span dispatch; link j reads the live prefix plus links < j,
            # the rows a sequential L-step replay would read
            if quant:
                write_span_kv_q8(pages_k, sk, block_table, k, idx)
                write_span_kv_q8(pages_v, sv, block_table, v, idx)
            else:
                write_span_kv(pages_k, block_table, k, idx)
                write_span_kv(pages_v, block_table, v, idx)
            addr = block_table.shape[1] * pages_k.shape[1]
            pos = torch.clamp(idx[:, None] + torch.arange(
                L, dtype=torch.int32, device=idx.device)[None, :],
                max=addr - 1)
            return paged_span_attention(q, pages_k, pages_v, block_table,
                                        pos, impl=decode_impl, scales_k=sk,
                                        scales_v=sv)
        if quant:
            write_token_kv_q8(pages_k, sk, block_table, k[:, :, 0], idx)
            write_token_kv_q8(pages_v, sv, block_table, v[:, :, 0], idx)
        else:
            write_token_kv(pages_k, block_table, k[:, :, 0], idx)
            write_token_kv(pages_v, block_table, v[:, :, 0], idx)
        # positions beyond each slot's depth hold trash/stale rows and are
        # masked (causality IS this mask for one query row)
        o = paged_decode_attention(q[:, :, 0].contiguous(), pages_k, pages_v,
                                   block_table, idx, impl=decode_impl,
                                   scales_k=sk, scales_v=sv)
        return o[:, :, None]


class Mlp(nn.Module):
    """tanh-GELU MLP, expansion 4x."""

    def __init__(self, hidden: int, dtype: torch.dtype, expand: int = 4,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.wi = _param((hidden, expand * hidden), device)
        self.wo = _param((expand * hidden, hidden), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.einsum("bld,dm->blm", x, self.wi.to(self.dtype))
        h = F.gelu(h, approximate="tanh")
        return torch.einsum("blm,md->bld", h, self.wo.to(self.dtype))


class Block(nn.Module):
    """Pre-LN transformer block (LN in f32); ``moe_experts`` > 0 swaps the
    dense MLP for a routed mixture of experts (submodule ``moe``).
    ``forward`` returns ``(x, stats)``: the MoE block's load-balance sums,
    or None for a dense block."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 device=None, attention_impl: str = "auto",
                 causal: bool = False, moe_experts: int = 0,
                 moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25) -> None:
        super().__init__()
        self.dtype = dtype
        self.moe_experts = moe_experts
        self.ln1 = LayerNorm(hidden, device)
        self.attn = SelfAttention(hidden, num_heads, dtype, device,
                                  attention_impl, causal)
        self.ln2 = LayerNorm(hidden, device)
        if moe_experts > 0:
            self.moe = MoEMlp(hidden, moe_experts, moe_top_k,
                              moe_capacity_factor, dtype, device=device)
        else:
            self.mlp = Mlp(hidden, dtype, device=device)

    def forward(self, x, pad_mask, cache_index=None, block_table=None,
                kv=None, decode_impl="auto", kv_quant="fp",
                moe_no_drop=False
                ) -> Tuple[torch.Tensor, Optional[MoEStats]]:
        h = self.ln1(x).to(self.dtype)
        x = x + self.attn(h, pad_mask, cache_index, block_table, kv,
                          decode_impl, kv_quant)
        h = self.ln2(x).to(self.dtype)
        if self.moe_experts > 0:
            y, stats = self.moe(h, pad_mask, no_drop=moe_no_drop)
            return x + y, stats
        return x + self.mlp(h), None


class TransformerBackbone(nn.Module):
    """Stack of pre-LN blocks over embedded inputs [B, L, D], then ``ln_f``.
    Blocks are named ``block_0 .. block_{n-1}`` as in flax; with
    ``moe_experts`` > 0 every ``moe_every``-th block is an MoE block;
    ``scan_layers`` stacks them into ``blocks``."""

    def __init__(self, num_layers: int, hidden: int, num_heads: int,
                 dtype: torch.dtype, device=None,
                 attention_impl: str = "auto", causal: bool = False,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_every: int = 2, moe_capacity_factor: float = 1.25,
                 remat: bool = False, scan_layers: bool = False) -> None:
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.remat = remat
        self.scan_layers = scan_layers
        self.moe_experts = moe_experts
        if scan_layers and moe_experts > 0:
            from .pipeline import MoEScanBlocks
            self.blocks = MoEScanBlocks(num_layers, hidden, num_heads,
                                        dtype, device, attention_impl,
                                        causal, remat, moe_experts,
                                        moe_top_k, moe_every,
                                        moe_capacity_factor)
        elif scan_layers:
            from .pipeline import PipelinedBlocks
            self.blocks = PipelinedBlocks(num_layers, hidden, num_heads,
                                          dtype, device, attention_impl,
                                          causal, remat)
        for i in range(0 if scan_layers else num_layers):
            is_moe = moe_experts > 0 and i % moe_every == moe_every - 1
            self.add_module(f"block_{i}",
                            Block(hidden, num_heads, dtype, device,
                                  attention_impl, causal,
                                  moe_experts if is_moe else 0, moe_top_k,
                                  moe_capacity_factor))
        self.ln_f = LayerNorm(hidden, device)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                cache_index: Optional[torch.Tensor] = None,
                block_table: Optional[torch.Tensor] = None,
                kv_cache: Optional[List[LayerKV]] = None,
                decode_impl: str = "auto",
                kv_quant: str = "fp", moe_no_drop: bool = False,
                moe_stats: Optional[List[MoEStats]] = None
                ) -> torch.Tensor:
        if self.scan_layers:
            if block_table is not None:
                raise NotImplementedError(STACKED_PAGED_REFUSAL)
            if self.moe_experts > 0:
                x = self.blocks(x, pad_mask, cache_index, kv_cache,
                                moe_no_drop, moe_stats)
            else:
                x = self.blocks(x, pad_mask, cache_index, kv_cache)
            return self.ln_f(x).to(self.dtype)
        remat = self.remat and torch.is_grad_enabled() and kv_cache is None
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            args = (x, pad_mask, cache_index, block_table,
                    None if kv_cache is None else kv_cache[i], decode_impl,
                    kv_quant, moe_no_drop)
            if remat:
                # the blocks draw no random numbers: no RNG state to keep
                x, stats = torch.utils.checkpoint.checkpoint(
                    block, *args, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, stats = block(*args)
            if stats is not None and moe_stats is not None:
                moe_stats.append(stats)
        return self.ln_f(x).to(self.dtype)
