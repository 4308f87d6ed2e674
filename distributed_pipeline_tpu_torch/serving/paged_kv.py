"""Paged KV cache: the page ops and the host-side page allocator.

The port of ``distributed_pipeline_tpu/serving/paged_kv.py`` (its fp subset).
K/V of every layer live in a pool of fixed-size pages
``[num_pages, page_size, H, Dh]`` indirected through a per-slot block table,
so a slot holds pages for the tokens it has, not for ``max_len``.

Device side, plain tensor functions:

* :func:`write_prompt_kv` — scatter a prefill's [B, H, L, Dh] K/V rows into
  the slots' pages (padded rows -> the trash page);
* :func:`write_token_kv`  — scatter one decode step's [B, H, Dh] row at each
  slot's own position;
* :func:`write_span_kv`   — scatter a speculative-verify span's [B, H, L, Dh]
  rows at positions ``start .. start + L - 1``, clamping overshoot past the
  block table's reach to its last cell;
* :func:`gather_kv`       — a dense ``[B, H, Lmax, Dh]`` view of each slot's
  pages (the plain decode attention reads it; the CUDA kernel does not).

int8 pools (``--kv_quant int8``) hold symmetric int8 pages with one f32
scale per page in a ``[P]`` sidecar (value = q * scale, q in [-127, 127]):

* :func:`write_prompt_kv_q8` — quantize a prefill's rows and SET each touched
  page's scale (the trash page's scale is left alone);
* :func:`write_token_kv_q8`  — one decode step's row, growing the page's
  scale when the row needs it and re-expressing the page's int8 content
  under the new scale;
* :func:`write_span_kv_q8`   — a span's rows: scales grow by a scatter-max
  over every row landing in a page, and the whole pool is re-expressed
  under the grown scales (pages whose scale did not grow keep their bits);
* :func:`dequant_gathered`   — dequantize a :func:`gather_kv` view.

The JAX writers return a new pool; these write the pool (and the scales)
IN PLACE and return them, which keeps one copy of the largest tensor of the
server. Page 0 is the TRASH page: every write that must land nowhere goes
there, and no read ever sees it.

Host side: :class:`PageManager` owns the free list as plain Python; the
scheduler reserves a request's worst-case pages at admission. The prefix
cache is ROADMAP A.4.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["TRASH_PAGE", "Q8_MAX", "gather_kv", "write_prompt_kv",
           "write_token_kv", "write_span_kv", "write_prompt_kv_q8",
           "write_token_kv_q8", "write_span_kv_q8", "dequant_gathered",
           "PageManager"]

TRASH_PAGE = 0  # reserved: masked/invalid writes land here, reads never do

Q8_MAX = 127.0  # symmetric int8: value = q * scale, q in [-127, 127]


def gather_kv(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """``pages`` [P, page_size, H, Dh], ``block_table`` [B, n_pages] ->
    [B, H, n_pages * page_size, Dh]. Entries past a slot's live length are
    whatever the pages hold; the caller masks them."""
    g = pages[block_table]                        # [B, n, page_size, H, Dh]
    b, n, ps, h, dh = g.shape
    return g.reshape(b, n * ps, h, dh).transpose(1, 2)


def write_prompt_kv(pages: torch.Tensor, block_table: torch.Tensor,
                    kv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Scatter a prefill's K (or V) rows into the slots' pages, in place.

    ``kv`` [B, H, L, Dh] holds positions 0..L-1 of each slot's prompt;
    ``valid`` [B, L] (1 = real prompt token) routes padded positions to the
    trash page. Returns ``pages``."""
    b, h, l, dh = kv.shape
    ps = pages.shape[1]
    pos = torch.arange(l, device=kv.device)
    page_idx = torch.clamp(pos // ps, max=block_table.shape[1] - 1)
    phys = block_table[:, page_idx]               # [B, L]
    phys = phys.masked_fill(valid <= 0, TRASH_PAGE)
    rows = kv.transpose(1, 2).reshape(b * l, h, dh)
    off = (pos % ps).expand(b, l).reshape(-1)
    pages[phys.reshape(-1).long(), off] = rows.to(pages.dtype)
    return pages


def write_token_kv(pages: torch.Tensor, block_table: torch.Tensor,
                   kv: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Scatter one decode step's K (or V) row at each slot's own position,
    in place. ``kv`` [B, H, Dh]; ``positions`` [B] is the index being
    written. Inactive slots (all-trash table rows) write to the trash page;
    positions past the table width clamp into the row. Returns ``pages``."""
    ps = pages.shape[1]
    page_idx = torch.clamp(positions // ps, max=block_table.shape[1] - 1)
    phys = torch.gather(block_table, 1, page_idx[:, None].long())[:, 0]
    pages[phys.long(), (positions % ps).long()] = kv.to(pages.dtype)
    return pages


def _span_cells(block_table: torch.Tensor, start: torch.Tensor, L: int,
                page_size: int) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """A span's cells and rows: ``(phys, offset, src)`` [B*L] each. Link j
    of slot b sits at ``start[b] + j``, clamped to the block table's last
    addressable cell instead of wrapping (``pos // ps`` would clamp to the
    last column while ``pos % ps`` re-entered a live lower cell). Every
    link that lands on that last cell takes the slot's LAST link's row
    (``src``): the JAX writers' last-write-wins, made deterministic, since
    rows written to one cell are then equal. Clamped links are always past
    a slot's budget, so their picks are discarded by the host."""
    B = start.shape[0]
    addr = block_table.shape[1] * page_size
    j = torch.arange(L, device=start.device)
    pos = start.long()[:, None] + j[None, :]                  # [B, L]
    src = torch.where(pos >= addr - 1, L - 1, j[None, :])
    src = src + L * torch.arange(B, device=start.device)[:, None]
    pos = torch.clamp(pos, max=addr - 1)
    phys = torch.gather(block_table.long(), 1, pos // page_size)
    return phys.reshape(-1), (pos % page_size).reshape(-1), src.reshape(-1)


def write_span_kv(pages: torch.Tensor, block_table: torch.Tensor,
                  kv: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Scatter a speculative-verify span's K (or V) rows, in place: ``kv``
    [B, H, L, Dh] holds each slot's chain links at positions
    ``start[b] .. start[b] + L - 1`` (overshoot clamps, see
    :func:`_span_cells`). Without overshoot it is bitwise the L
    :func:`write_token_kv` calls it replaces. Returns ``pages``."""
    b, h, l, dh = kv.shape
    phys, off, src = _span_cells(block_table, start, l, pages.shape[1])
    rows = kv.transpose(1, 2).reshape(b * l, h, dh)
    pages[phys, off] = rows[src].to(pages.dtype)
    return pages


def _q8(rows: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize fp rows to int8 under a per-row ``scale`` (broadcastable).
    ``scale == 0`` (all-zero content) maps everything to 0. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(rows.float() / s)
    return torch.clamp(q, -Q8_MAX, Q8_MAX).to(torch.int8)


def write_prompt_kv_q8(pages: torch.Tensor, scales: torch.Tensor,
                       block_table: torch.Tensor, kv: torch.Tensor,
                       valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 twin of :func:`write_prompt_kv`, in place: quantize a prefill's
    K (or V) rows at page granularity and SET each touched page's scale to
    ``absmax(its prompt rows) / 127``. SET, not max-accumulated against the
    leftover scale of the page's previous request, so quantization is a
    pure function of the prompt. The trash page, which padded rows
    scribble on, keeps its scale (no read ever maps it). ``pages`` is the
    int8 pool, ``scales`` its [P] f32 sidecar. Returns both."""
    b, h, l, dh = kv.shape
    ps = pages.shape[1]
    pos = torch.arange(l, device=kv.device)
    page_idx = torch.clamp(pos // ps, max=block_table.shape[1] - 1)
    phys = block_table[:, page_idx]               # [B, L]
    phys = phys.masked_fill(valid <= 0, TRASH_PAGE).reshape(-1).long()
    rows = kv.transpose(1, 2).reshape(b * l, h, dh)
    row_amax = rows.float().abs().amax(dim=(1, 2))
    fresh = torch.zeros_like(scales).scatter_reduce(
        0, phys, row_amax / Q8_MAX, reduce="amax")
    touched = torch.zeros_like(scales, dtype=torch.bool)
    touched[phys] = True
    touched[TRASH_PAGE] = False
    scales.copy_(torch.where(touched, fresh, scales))
    off = (pos % ps).expand(b, l).reshape(-1)
    pages[phys, off] = _q8(rows, scales[phys][:, None, None])
    return pages, scales


def write_token_kv_q8(pages: torch.Tensor, scales: torch.Tensor,
                      block_table: torch.Tensor, kv: torch.Tensor,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 twin of :func:`write_token_kv` with rescale-on-grow, in place.
    A row beyond its page's current scale grows the scale to
    ``max(old, absmax(row) / 127)`` and the page's existing int8 content is
    re-expressed under it (``round(q * old / new)``), instead of clipping
    the row. Several inactive slots may write the trash page at once; which
    of them lands there does not matter, nothing reads it. Returns
    ``(pages, scales)``."""
    ps = pages.shape[1]
    page_idx = torch.clamp(positions // ps, max=block_table.shape[1] - 1)
    phys = torch.gather(block_table, 1, page_idx[:, None].long())[:, 0].long()
    row_amax = kv.float().abs().amax(dim=(1, 2))  # [B]
    old = scales[phys]
    new = torch.maximum(old, row_amax / Q8_MAX)
    grown = new > 0
    ratio = torch.where(grown, old / torch.where(grown, new,
                                                 torch.ones_like(new)),
                        torch.zeros_like(new))
    page = torch.clamp(torch.round(pages[phys].float()
                                   * ratio[:, None, None, None]),
                       -Q8_MAX, Q8_MAX).to(torch.int8)  # [B, ps, H, Dh]
    page[torch.arange(phys.shape[0], device=phys.device),
         (positions % ps).long()] = _q8(kv, new[:, None, None])
    pages[phys] = page
    scales[phys] = new
    return pages, scales


def write_span_kv_q8(pages: torch.Tensor, scales: torch.Tensor,
                     block_table: torch.Tensor, kv: torch.Tensor,
                     start: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 twin of :func:`write_span_kv` with rescale-on-grow, in place.
    Span rows may straddle a page boundary, so several rows can land in
    one page: each touched page's scale grows to ``max(old, absmax(row) /
    127)`` over every row landing in it (a scatter-max, which does not
    depend on the order of the rows), and the WHOLE pool is re-expressed
    under the grown scales (``round(q * old / new)``; a page whose scale
    did not grow sees ratio 1.0 and keeps its bits). That is the JAX
    writer's O(pool) pass, one per verify per layer, K and V. Returns
    ``(pages, scales)``."""
    b, h, l, dh = kv.shape
    phys, off, src = _span_cells(block_table, start, l, pages.shape[1])
    rows = kv.transpose(1, 2).reshape(b * l, h, dh)
    row_amax = rows.float().abs().amax(dim=(1, 2))
    new = scales.scatter_reduce(0, phys, row_amax / Q8_MAX, reduce="amax")
    grown = new > 0
    ratio = torch.where(grown, scales / torch.where(grown, new,
                                                    torch.ones_like(new)),
                        torch.zeros_like(new))
    pages.copy_(torch.clamp(torch.round(pages.float()
                                        * ratio[:, None, None, None]),
                            -Q8_MAX, Q8_MAX).to(torch.int8))
    scales.copy_(new)
    pages[phys, off] = _q8(rows[src], new[phys][:, None, None])
    return pages, scales


def dequant_gathered(dense: torch.Tensor, scales: torch.Tensor,
                     block_table: torch.Tensor, page_size: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """Dequantize a :func:`gather_kv` result: ``dense`` [B, H, n*ps, Dh]
    int8 -> ``dtype``, each position scaled by its source page's scale."""
    per_page = scales[block_table.long()]         # [B, n]
    per_pos = torch.repeat_interleave(per_page, page_size, dim=1)
    return (dense.float() * per_pos[:, None, :, None]).to(dtype)


class PageManager:
    """Host-side page allocator: a LIFO free list of page ids.

    Page 0 (TRASH_PAGE) is never handed out. ``alloc`` is all-or-nothing
    (None when the pool cannot cover the request), so the scheduler's
    reserve-at-admission policy stays atomic."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 is the reserved trash "
                             f"page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: recently-freed (still-warm) pages are reused first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._allocated: set = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        """Max pages a single allocation can ever get (pool minus trash)."""
        return self.num_pages - 1

    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` tokens (>= 1)."""
        return max(1, -(-int(length) // self.page_size))

    def alloc(self, n: int) -> Optional[np.ndarray]:
        """``n`` page ids as int32, or None if the pool can't cover them."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._allocated.update(ids)
        return np.asarray(ids, np.int32)

    def free(self, ids: np.ndarray) -> None:
        for i in map(int, np.asarray(ids).ravel()):
            if i not in self._allocated:
                raise ValueError(f"double free / foreign page id {i}")
            self._allocated.discard(i)
            self._free.append(i)
