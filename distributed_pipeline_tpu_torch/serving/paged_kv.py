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
scheduler reserves a request's worst-case pages at admission.
:class:`PrefixCache` (a copy of the JAX class) lets requests whose prompts
open with the same full pages share them, refcounted.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["TRASH_PAGE", "Q8_MAX", "gather_kv", "write_prompt_kv",
           "write_token_kv", "write_span_kv", "write_prompt_kv_q8",
           "write_token_kv_q8", "write_span_kv_q8", "dequant_gathered",
           "PageManager", "PrefixCache"]

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
    # fills, not ``touched[phys] = True``: a scalar assigned through an
    # index is copied from the host first, which a CUDA graph cannot
    # capture
    touched = torch.zeros_like(scales, dtype=torch.bool).index_fill_(
        0, phys, True)
    touched[TRASH_PAGE].fill_(False)
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


class PrefixCache:
    """Shared read-only block-table entries: requests whose prompts open
    with the same token run reuse the pages holding that prefix's K/V.

    WHY THIS IS SOUND: a GPT-2 K/V row at position ``p`` is a pure
    function of tokens ``0..p`` — identical prefix tokens produce
    bit-identical K/V. Sharing is restricted to FULL pages strictly
    inside the prompt (``prompt_len // page_size`` pages), so a sharer's
    own writes — the rest of its prompt and every generated token — land
    at positions past the shared region, in its private pages. In the
    port a sharing prefill does not write the pages it acquired (the
    scheduler routes them to the trash page): a GEMM over another batch
    need not give bitwise-equal rows on the card, so readers keep exactly
    the values of the cold prefill that published them.

    LIFETIME is refcounted, because replay/eviction must never free a
    page a live slot still reads:

    * ``slot refs`` — how many in-flight requests hold the page in their
      block table. Incremented by :meth:`acquire`, decremented by
      :meth:`release`.
    * ``entry refs`` — how many cache entries contain the page. A page is
      returned to the :class:`PageManager` only when BOTH hit zero
      (release frees private pages immediately; shared pages persist in
      the cache — that is the feature — until eviction drops their
      entries under pool pressure, LRU-first). Eviction never frees a
      page a live slot still reads: dropping the entry merely orphans
      it, and :meth:`release` frees it with the last slot ref. Entries
      are always droppable — eviction that waited for slot refs to
      clear would deadlock admission on shared-prefix workloads, where
      every entry's head pages are pinned by the very request being
      admitted.

    Entries are keyed by the raw bytes of the page-aligned token prefix,
    one entry per full-page depth, so nested prefixes share page ids and
    a lookup takes the LONGEST cached match.
    """

    def __init__(self, mgr: PageManager, max_entries: int = 512) -> None:
        self.mgr = mgr
        self.page_size = mgr.page_size
        self.max_entries = max_entries
        self._entries: "collections.OrderedDict[bytes, List[int]]" = \
            collections.OrderedDict()
        self._slot_refs: Dict[int, int] = collections.defaultdict(int)
        self._entry_refs: Dict[int, int] = collections.defaultdict(int)
        self.hits = 0
        self.misses = 0
        self.pages_reused = 0
        self.evicted_entries = 0

    # ------------------------------------------------------------- internal

    def _key(self, prompt: np.ndarray, n_pages: int) -> bytes:
        return np.ascontiguousarray(
            prompt[:n_pages * self.page_size], np.int32).tobytes()

    def _full_pages(self, prompt_len: int) -> int:
        return int(prompt_len) // self.page_size

    @property
    def resident_pages(self) -> int:
        """Pages held alive by cache entries (shared capital; an upper
        bound on what :meth:`evict` could hand back under pressure)."""
        return len(self._entry_refs)

    # -------------------------------------------------------------- acquire

    def acquire(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached full-page prefix of ``prompt``: slot-refs its
        pages for the caller and returns ``(page_ids, covered_tokens)``.
        ``([], 0)`` on a miss — the caller allocates everything fresh."""
        for j in range(self._full_pages(len(prompt)), 0, -1):
            pages = self._entries.get(self._key(prompt, j))
            if pages is not None:
                self._entries.move_to_end(self._key(prompt, j))
                for p in pages:
                    self._slot_refs[p] += 1
                self.hits += 1
                self.pages_reused += len(pages)
                return list(pages), j * self.page_size
        self.misses += 1
        return [], 0

    def publish(self, prompt: np.ndarray, pages: np.ndarray,
                n_acquired: int = 0) -> None:
        """Register every full-page prefix of an admitted prompt, making
        its pages shared-capable. ``pages`` is the slot's full reserved
        page list (shared head + fresh); only the prompt-covering full
        pages are published — the tail (partial prompt page + generation
        budget) stays private to the slot.

        INVARIANT: after admission, the slot holds ONE slot-ref on every
        page of its full-page head — :meth:`acquire` ref'd the first
        ``n_acquired`` (the cached share), and publish refs the freshly
        allocated remainder here. Without the publisher's own refs, a
        sharer could still be reading the pages when the publisher
        completes, drops the count to zero, and pool-pressure eviction
        hands them to a new request mid-read (caught by test)."""
        ids = [int(p) for p in np.asarray(pages).ravel()]
        k = self._full_pages(len(prompt))
        for p in ids[n_acquired:k]:
            self._slot_refs[p] += 1
        for j in range(1, k + 1):
            key = self._key(prompt, j)
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            entry = ids[:j]
            self._entries[key] = entry
            for p in entry:
                self._entry_refs[p] += 1
        while len(self._entries) > self.max_entries:
            if not self._evict_one():
                break

    # -------------------------------------------------------------- release

    def release(self, prompt: np.ndarray, pages: np.ndarray) -> np.ndarray:
        """A slot finished (completion OR replay-abandonment): drop its
        slot refs on the prefix pages and return the pages now safe to
        free — the PRIVATE tail, plus any prefix page ORPHANED by an
        eviction that ran while this slot still read it (entry refs
        already zero; this was its last slot ref). Shared pages still in
        the cache stay resident for the next sharer."""
        ids = [int(p) for p in np.asarray(pages).ravel()]
        k = min(self._full_pages(len(prompt)), len(ids))
        freeable = ids[k:]
        for p in ids[:k]:
            if self._slot_refs[p] > 0:
                self._slot_refs[p] -= 1
            if self._slot_refs[p] == 0:
                del self._slot_refs[p]
                if self._entry_refs.get(p, 0) == 0:
                    freeable.append(p)
        return np.asarray(freeable, np.int32)

    # --------------------------------------------------------------- evict

    def _evict_one(self) -> bool:
        """Drop one cache entry, LRU-first, and free every page that
        leaves BOTH its last entry and its last slot ref. Pages a live
        slot still reads are never freed here — dropping the entry only
        orphans them, and :meth:`release` frees them when the last slot
        ref goes. Prefers the oldest entry whose eviction frees a page
        RIGHT NOW; with nothing immediately freeable it still drops the
        LRU head (progress under pool pressure must not depend on the
        eviction freeing synchronously — a shared-prefix workload keeps
        slot refs on every entry's head pages, and skipping all of them
        deadlocked admission: nothing evictable, pool exhausted, the
        scheduler's head-of-line wait spinning forever). Returns whether
        an entry was dropped."""
        def drop(key: bytes) -> None:
            entry = self._entries.pop(key)
            self.evicted_entries += 1
            freed = []
            for p in entry:
                self._entry_refs[p] -= 1
                if self._entry_refs[p] == 0:
                    del self._entry_refs[p]
                    if self._slot_refs.get(p, 0) == 0:
                        freed.append(p)
            if freed:
                self.mgr.free(np.asarray(freed, np.int32))

        if not self._entries:
            return False
        for key in list(self._entries):
            entry = self._entries[key]
            if any(self._entry_refs[p] == 1
                   and self._slot_refs.get(p, 0) == 0 for p in entry):
                drop(key)
                return True
        drop(next(iter(self._entries)))
        return True

    def evict_for(self, n_pages: int) -> int:
        """Free cache-resident pages until the pool can cover ``n_pages``
        (or nothing evictable remains). Returns pages freed."""
        freed0 = self.mgr.free_pages
        while self.mgr.free_pages < n_pages and self._evict_one():
            pass
        return self.mgr.free_pages - freed0

    def stats(self) -> Dict[str, int]:
        return {"prefix_hits": self.hits, "prefix_misses": self.misses,
                "prefix_pages_reused": self.pages_reused,
                "prefix_entries": len(self._entries),
                "prefix_resident_pages": self.resident_pages,
                "prefix_evicted_entries": self.evicted_entries}
