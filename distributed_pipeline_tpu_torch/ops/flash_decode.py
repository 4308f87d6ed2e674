"""Flash-decode: single-query attention straight out of the paged KV pool.

The port of ``distributed_pipeline_tpu/ops/flash_decode.py``. The serving
decode step attends one new token per slot over that slot's live prefix,
which lives in pages of the pool ``[P, page_size, H, Dh]`` listed by the
slot's block-table row. Two arms compute it:

* :func:`flash_decode` wraps the hand-written CUDA kernel
  (``ops/csrc/flash_decode.cu``): one thread block per (head, slot) reads the
  slot's live pages through the block table and folds them into an online
  softmax; no dense copy of the reservation is ever made. It takes CUDA
  tensors only and raises on any other: the seam below routes.
* :func:`torch_paged_decode` is the plain version and copies the JAX
  package's ``xla_paged_decode``: gather a dense view of every slot's pages,
  mask positions ``> pos``, dense attention.

The page-layout contract is the JAX package's: page 0 is the trash page,
block-table entries past a slot's live prefix may hold anything, and the
caller writes the current token's K/V before attending. ``positions[b] < 0``
marks a slot with no live key, whose output is zeros.

Dispatch (:func:`resolve_decode_impl`): ``auto`` takes the kernel for CUDA
tensors and the plain version for CPU tensors; ``cuda`` forces the kernel and
raises on CPU tensors; ``torch`` forces the plain version. The TPU arm's
layout rule (``(H, Dh)`` must tile ``(8, 128)``) belongs to the TPU and is
not carried over: the kernel takes Dh 64 and 128 in f32 and bf16, which
covers every GPT-2 preset.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flash_decode", "torch_paged_decode", "paged_decode_attention",
           "resolve_decode_impl", "decode_hbm_bytes", "launch_count",
           "reset_launch_count"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_SMEM = 48 * 1024  # the kernel's dynamic shared memory, without opt-in

# Launches of the CUDA kernel since the last reset: one per call.
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def resolve_decode_impl(impl: str, device: torch.device) -> str:
    """``auto`` -> "cuda" for CUDA tensors, "torch" otherwise; ``cuda``
    raises for tensors that are not on a CUDA device."""
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"decode impl must be auto|cuda|torch, got {impl!r}")
    on_cuda = torch.device(device).type == "cuda"
    if impl == "auto":
        return "cuda" if on_cuda else "torch"
    if impl == "cuda" and not on_cuda:
        raise ValueError(f"decode_impl='cuda' needs CUDA tensors, got "
                         f"tensors on {device}")
    return impl


def torch_paged_decode(q: torch.Tensor, pages_k: torch.Tensor,
                       pages_v: torch.Tensor, block_table: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """The plain version ([B, H, Dh] in and out): gather, live mask
    ``arange <= pos``, dense attention — ``xla_paged_decode`` line for
    line, plus one rule of the kernels: a slot with no live key
    (``pos < 0``) gives zeros, where the all-masked softmax would average
    whatever its pages hold."""
    from ..serving.paged_kv import gather_kv
    from .attention import dot_product_attention
    ks = gather_kv(pages_k, block_table)        # [B, H, n*page_size, Dh]
    vs = gather_kv(pages_v, block_table)
    live = (torch.arange(ks.shape[2], device=ks.device)[None, :]
            <= positions[:, None]).to(torch.int32)
    o = dot_product_attention(q[:, :, None], ks, vs, live, causal=False)
    return torch.where((positions >= 0)[:, None, None], o[:, :, 0],
                       torch.zeros((), dtype=o.dtype, device=o.device))


def _check_kernel_args(q, pages_k, pages_v, block_table, positions) -> None:
    if q.dim() != 3 or pages_k.dim() != 4:
        raise ValueError(f"flash_decode takes q [B, H, Dh] and pools "
                         f"[P, page_size, H, Dh], got {tuple(q.shape)} and "
                         f"{tuple(pages_k.shape)}")
    B, H, Dh = q.shape
    if pages_k.shape != pages_v.shape or tuple(pages_k.shape[2:]) != (H, Dh):
        raise ValueError(f"pool shapes {tuple(pages_k.shape)} / "
                         f"{tuple(pages_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not (q.dtype == pages_k.dtype == pages_v.dtype) \
            or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_decode takes float32 or bfloat16 q and "
                         f"pools of one dtype, got {q.dtype}, "
                         f"{pages_k.dtype}, {pages_v.dtype}")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"flash_decode supports head_dim {_HEAD_DIMS}, "
                         f"got {Dh}")
    if block_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("block_table and positions must be int32")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(positions.shape) != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / "
                         f"positions {tuple(positions.shape)} do not match "
                         f"{B} slots")
    tensors = (q, pages_k, pages_v, block_table, positions)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode inputs must be contiguous")
    page_size = pages_k.shape[1]
    smem = (page_size + (128 // Dh) * Dh) * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"page_size {page_size} needs {smem} bytes of "
                         f"shared memory per block, above {_MAX_SMEM}")


def flash_decode(q: torch.Tensor, pages_k: torch.Tensor,
                 pages_v: torch.Tensor, block_table: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Paged single-query attention: ``q`` [B, H, Dh], pools
    ``[P, page_size, H, Dh]``, ``block_table`` [B, n_pages] int32,
    ``positions`` [B] int32 -> [B, H, Dh] in q's dtype, on CUDA tensors
    only (the kernel has no CPU mode)."""
    global _launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode is the CUDA kernel and takes CUDA "
                         f"tensors, got {q.device}; the plain version is "
                         f"torch_paged_decode")
    _check_kernel_args(q, pages_k, pages_v, block_table, positions)
    from ._build import check, load_library
    lib = load_library()
    B, H, Dh = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.dpt_flash_decode(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            block_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
            B, H, Dh, pages_k.shape[1], block_table.shape[1],
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    check(lib, err, "flash_decode")
    _launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, pages_k: torch.Tensor,
                           pages_v: torch.Tensor, block_table: torch.Tensor,
                           positions: torch.Tensor,
                           impl: str = "auto") -> torch.Tensor:
    """The decode-step seam: one generated token's attention, ``q``
    [B, H, Dh] -> [B, H, Dh]. The caller has already written the token's K/V
    into the pool."""
    if resolve_decode_impl(impl, q.device) == "cuda":
        return flash_decode(q, pages_k, pages_v, block_table, positions)
    return torch_paged_decode(q, pages_k, pages_v, block_table, positions)


def decode_hbm_bytes(block_table: np.ndarray, positions: np.ndarray,
                     page_size: int, n_heads: int, head_dim: int,
                     dtype_bytes: int = 4, step_table: bool = True) -> int:
    """Device-memory bytes one decode-attention call must move: each
    DISTINCT live page's K and V blocks once (a page shared by several
    slots counts once), one q read and one output write per slot, and the
    index bytes of the schedule.

    ``step_table=True`` is the JAX package's census (fp pages), copied so
    that both packages price the same work: the TPU schedule reads a step
    table of 7 int32 columns per block-table entry. ``step_table=False``
    prices the CUDA kernel, which has no step table: it reads each live
    block-table entry and each slot's position once. The kernel's bound is
    that number over the card's memory rate."""
    bt = np.asarray(block_table)
    pos = np.asarray(positions)
    B, n = bt.shape
    page_bytes = page_size * n_heads * head_dim * dtype_bytes
    qo_bytes = n_heads * head_dim * dtype_bytes
    n_live = np.clip(pos // page_size + 1, 0, n)
    total = 0
    seen: set = set()
    for b in range(B):
        for j in range(int(n_live[b])):
            page = int(bt[b, j])
            if page not in seen:
                total += 2 * page_bytes            # K and V blocks
                seen.add(page)
        total += 2 * qo_bytes                      # q read + out write
    if step_table:
        total += (B * n) * 7 * 4                   # TPU step table
    else:
        total += (int(n_live.sum()) + B) * 4       # live entries + positions
    return int(total)
