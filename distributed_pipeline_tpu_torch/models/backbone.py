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
  over the live prefix plus the earlier links.

``kv_quant`` names the pool's storage, as the JAX module attribute of that
name does: ``"fp"`` pools hold the compute dtype and a layer's KV entry is
``(pages_k, pages_v)``; ``"int8"`` pools hold int8 pages and the entry is
``(pages_k, pages_v, scales_k, scales_v)`` with ``[P]`` f32 scales, written
by the ``_q8`` writers and dequantized by both decode arms. The prefill's own
attention runs on the local fp k/v either way.

The dense-cache decode, MoE and stacked (``scan_layers``) weights are later
work (ROADMAP A.7b, A.8).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.flash_decode import paged_decode_attention, paged_span_attention
from ..serving.paged_kv import (write_prompt_kv, write_prompt_kv_q8,
                                write_span_kv, write_span_kv_q8,
                                write_token_kv, write_token_kv_q8)

__all__ = ["TransformerBackbone", "Block", "Mlp", "SelfAttention",
           "LayerNorm", "Embed"]

# one layer's (pages_k, pages_v), or (pages_k, pages_v, scales_k, scales_v)
# for an int8 pool
LayerKV = Tuple[torch.Tensor, ...]
KV_QUANTS = ("fp", "int8")


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
        if kv is not None:
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
    """Pre-LN transformer block (LN in f32)."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 device=None, attention_impl: str = "auto",
                 causal: bool = False) -> None:
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(hidden, device)
        self.attn = SelfAttention(hidden, num_heads, dtype, device,
                                  attention_impl, causal)
        self.ln2 = LayerNorm(hidden, device)
        self.mlp = Mlp(hidden, dtype, device=device)

    def forward(self, x, pad_mask, cache_index=None, block_table=None,
                kv=None, decode_impl="auto", kv_quant="fp"):
        h = self.ln1(x).to(self.dtype)
        x = x + self.attn(h, pad_mask, cache_index, block_table, kv,
                          decode_impl, kv_quant)
        h = self.ln2(x).to(self.dtype)
        return x + self.mlp(h)


class TransformerBackbone(nn.Module):
    """Stack of pre-LN blocks over embedded inputs [B, L, D], then ``ln_f``.
    Blocks are named ``block_0 .. block_{n-1}`` as in flax."""

    def __init__(self, num_layers: int, hidden: int, num_heads: int,
                 dtype: torch.dtype, device=None,
                 attention_impl: str = "auto", causal: bool = False) -> None:
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block_{i}",
                            Block(hidden, num_heads, dtype, device,
                                  attention_impl, causal))
        self.ln_f = LayerNorm(hidden, device)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                cache_index: Optional[torch.Tensor] = None,
                block_table: Optional[torch.Tensor] = None,
                kv_cache: Optional[List[LayerKV]] = None,
                decode_impl: str = "auto",
                kv_quant: str = "fp") -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(
                x, pad_mask, cache_index, block_table,
                None if kv_cache is None else kv_cache[i], decode_impl,
                kv_quant)
        return self.ln_f(x).to(self.dtype)
