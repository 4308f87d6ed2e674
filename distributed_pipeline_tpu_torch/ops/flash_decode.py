"""Flash-decode: single-query attention straight out of the paged KV pool.

The port of ``distributed_pipeline_tpu/ops/flash_decode.py``. The serving
decode step attends one new token per slot over that slot's live prefix,
which lives in pages of the pool ``[P, page_size, H, Dh]`` listed by the
slot's block-table row. The pool holds q's dtype, or int8 with one f32 scale
per page for K and one for V (``[P]`` sidecars, the ``--kv_quant int8``
pool), dequantized as ``page.float() * scale``. Two arms compute it:

* :func:`flash_decode` wraps the hand-written CUDA kernel
  (``ops/csrc/flash_decode.cu``): split-K over each slot's live pages in a
  static grid, whole pages fetched by bulk copies into a multi-stage ring,
  chunks merged in split order (deterministic). No dense copy of the
  reservation is ever made, and the wrapper never reads the positions on
  the host. It takes CUDA tensors only and raises on any other: the seam
  below routes.
* :func:`torch_paged_decode` is the plain version and copies the JAX
  package's ``xla_paged_decode``: gather a dense view of every slot's pages,
  dequantize int8 pages to q's dtype, mask positions ``> pos``, dense
  attention.

The page-layout contract is the JAX package's: page 0 is the trash page,
block-table entries past a slot's live prefix may hold anything, and the
caller writes the current token's K/V before attending. ``positions[b] < 0``
marks a slot with no live key, whose output is zeros.

Speculative verify attends a whole draft chain at once: ``q`` [B, H, L, Dh]
holds each slot's L links, link j at position ``positions[b, j]``, over the
live prefix plus the earlier links (the caller has written every link's
K/V). :func:`paged_span_attention` is its seam, and routes CUDA tensors by
q's dtype:

* bf16 q: :func:`flash_span`, the span kernel (``ops/csrc/flash_span.cu``):
  one CTA reads each of a slot's live pages once for up to 16 links and
  folds them on tensor cores (``mma.sync`` bf16, P rounded to bf16);
* f32 q (the strict 1e-5 bar, the f32 spec identity): tensor cores have no
  f32 path that holds that bar, so :func:`pseudo_slot_span` runs
  :func:`flash_decode` over B*L pseudo-slots (link j of slot b is a slot of
  its own with b's block-table row and position ``positions[b, j]``).

Either way one kernel builds and launches or the call raises; the launch
counters tell the two routes apart. :func:`torch_paged_span_decode`, the
plain twin of the JAX package's ``xla_paged_span_decode``, gathers each
slot's pages once and attends link by link with the single-token plain
version's own arithmetic, so a link's output is bitwise that version's
output at the same position.

Dispatch (:func:`resolve_decode_impl`): ``auto`` takes the kernel for CUDA
tensors and the plain version for CPU tensors; ``cuda`` forces the kernel and
raises on CPU tensors; ``torch`` forces the plain version. The TPU arm's
layout rule (``(H, Dh)`` must tile ``(8, 128)``) belongs to the TPU and is
not carried over: the kernel takes Dh 64 and 128 in f32 and bf16, which
covers every GPT-2 preset.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["flash_decode", "torch_paged_decode", "paged_decode_attention",
           "flash_span", "pseudo_slot_span", "torch_paged_span_decode",
           "paged_span_attention", "resolve_decode_impl", "decode_hbm_bytes",
           "span_hbm_bytes", "decode_plan", "span_plan", "device_limits",
           "DecodePlan", "SpanPlan", "launch_count", "span_launch_count",
           "span_kernel_launch_count", "reset_launch_count",
           "launch_counters", "add_launches", "plain_call_count"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# the kernel's shape (ops/csrc/flash_decode.cu): one consumer warp a head, up
# to 12 a CTA (two CTAs share an SM)
_MAX_GROUP_HEADS = 12
# A ring of two stages; three or four measured no faster at the serving
# shapes (scripts/profile_torch_decode.py).
_STAGES = 2
_CTAS_PER_SM = 4  # the static grid aims at this many CTAs per SM

# the span kernel's shape (ops/csrc/flash_span.cu): 16 links a CTA (the
# MMA's M rows), 16 keys a P V step, 16 bytes of padding after each row of
# a warp's scratch; one CTA an SM, so its grid aims at two
_LINK_TILE = 16
_KEY_BLOCK = 16
_ROW_PAD = 16
_SPAN_CTAS_PER_SM = 2

# Launches since the last reset, one per call, by page type ("fp" pools of
# q's dtype, "int8" pools): of the decode kernel (the f32 span route's
# pseudo-slot launches included) and of the span kernel; and the calls of
# the speculative-verify seam, whichever kernel they took.
_launches = {"fp": 0, "int8": 0}
_span_kernel_launches = {"fp": 0, "int8": 0}
_span_launches = [0]
# calls the two seams routed to their plain versions (a CPU run's only
# route; on the card a process that serves must keep it at 0)
_plain_calls = [0]
# per CUDA device: (SM count, opt-in shared memory per block)
_device_limits: Dict[int, Tuple[int, int]] = {}
# per CUDA device: the zeroed int32 tickets of the multi-chunk combine (the
# slot's last chunk resets its ticket, so they stay zero between calls on
# one stream). A buffer outgrown by a larger call is kept alive in
# _retired_tickets: a CUDA graph captured over it goes on using it.
_tickets: Dict[int, torch.Tensor] = {}
_retired_tickets: list = []


def launch_count(pages: Optional[str] = None) -> int:
    """Kernel launches since the last reset: all of them, or those over
    ``pages`` = "fp" or "int8" pools."""
    return sum(_launches.values()) if pages is None else _launches[pages]


def span_launch_count() -> int:
    """Kernel launches made by :func:`paged_span_attention` since the last
    reset, on either route (each is also one of
    :func:`span_kernel_launch_count`'s or of :func:`launch_count`'s)."""
    return _span_launches[0]


def span_kernel_launch_count(pages: Optional[str] = None) -> int:
    """Launches of the span kernel (:func:`flash_span`) since the last
    reset: all of them, or those over ``pages`` = "fp" or "int8" pools."""
    return (sum(_span_kernel_launches.values()) if pages is None
            else _span_kernel_launches[pages])


def plain_call_count() -> int:
    """Calls that :func:`paged_decode_attention` and
    :func:`paged_span_attention` routed to their plain versions since the
    last reset (counted where the seam picks the route, eager calls only:
    a CUDA graph captured over a plain call replays it uncounted, and its
    capture's eager first call has counted it)."""
    return _plain_calls[0]


def reset_launch_count() -> None:
    for counts in (_launches, _span_kernel_launches):
        for key in counts:
            counts[key] = 0
    _span_launches[0] = 0
    _plain_calls[0] = 0


def launch_counters() -> Dict[str, int]:
    """Every counter as one flat dict: ``decode_fp``, ``decode_int8``,
    ``span_fp``, ``span_int8`` (the span kernel) and ``seam`` (the span
    seam's calls). A CUDA graph takes a snapshot before and after its
    capture: the difference is what one replay launches."""
    out = {f"decode_{k}": v for k, v in _launches.items()}
    out.update({f"span_{k}": v for k, v in _span_kernel_launches.items()})
    out["seam"] = _span_launches[0]
    return out


def add_launches(delta: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`launch_counters` difference) to
    the counters: a graph replay's launches, which run no Python wrapper,
    or (``times=-1``) a capture's, which launched nothing."""
    for key, n in delta.items():
        if key == "seam":
            _span_launches[0] += times * n
        elif key.startswith("decode_"):
            _launches[key[len("decode_"):]] += times * n
        else:
            _span_kernel_launches[key[len("span_"):]] += times * n


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
                       positions: torch.Tensor,
                       scales_k: Optional[torch.Tensor] = None,
                       scales_v: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The plain version ([B, H, Dh] in and out): gather, dequantize int8
    pools right after the gather (``scales_*`` given), live mask
    ``arange <= pos``, dense attention — ``xla_paged_decode`` line for
    line, plus one rule of the kernels: a slot with no live key
    (``pos < 0``) gives zeros, where the all-masked softmax would average
    whatever its pages hold."""
    ks, vs = _gather_dense(q, pages_k, pages_v, block_table, scales_k,
                           scales_v)
    return _attend_dense(q, ks, vs, positions)


def _gather_dense(q, pages_k, pages_v, block_table, scales_k, scales_v
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's pages as dense [B, H, n*page_size, Dh] K and V, int8
    pools dequantized to q's dtype right after the gather."""
    from ..serving.paged_kv import dequant_gathered, gather_kv
    ks = gather_kv(pages_k, block_table)
    vs = gather_kv(pages_v, block_table)
    if scales_k is not None:
        ps = pages_k.shape[1]
        ks = dequant_gathered(ks, scales_k, block_table, ps, q.dtype)
        vs = dequant_gathered(vs, scales_v, block_table, ps, q.dtype)
    return ks, vs


def _attend_dense(q: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """One query row a slot ([B, H, Dh]) over gathered K/V, live mask
    ``arange <= pos``; a slot with ``pos < 0`` gives zeros."""
    from .attention import dot_product_attention
    live = (torch.arange(ks.shape[2], device=ks.device)[None, :]
            <= positions[:, None]).to(torch.int32)
    o = dot_product_attention(q[:, :, None], ks, vs, live, causal=False)
    return torch.where((positions >= 0)[:, None, None], o[:, :, 0],
                       torch.zeros((), dtype=o.dtype, device=o.device))


def torch_paged_span_decode(q: torch.Tensor, pages_k: torch.Tensor,
                            pages_v: torch.Tensor, block_table: torch.Tensor,
                            positions: torch.Tensor,
                            scales_k: Optional[torch.Tensor] = None,
                            scales_v: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The span's plain version, the twin of the JAX package's
    ``xla_paged_span_decode``: ``q`` [B, H, L, Dh], ``positions`` [B, L]
    -> [B, H, L, Dh]. Each slot's pages are gathered (and dequantized)
    once; each link then attends with :func:`torch_paged_decode`'s own
    arithmetic at its own position, so link j's output is bitwise the
    single-token plain output for ``q[:, :, j]`` at ``positions[:, j]``
    (one product a link: on the CPU a batched product's rows are not
    bitwise those of a one-row product)."""
    ks, vs = _gather_dense(q, pages_k, pages_v, block_table, scales_k,
                           scales_v)
    return torch.stack([_attend_dense(q[:, :, j], ks, vs, positions[:, j])
                        for j in range(q.shape[2])], dim=2)


class DecodePlan(NamedTuple):
    """The kernel's static launch shape for one set of tensor shapes."""
    group_heads: int      # heads a CTA folds (H, or a group of them)
    groups: int           # head groups: ceil(H / group_heads)
    stages: int           # depth of the bulk-copy ring
    pages_per_chunk: int  # split-K chunk of a slot's pages
    max_splits: int       # chunks a full reservation splits into
    smem_bytes: int       # dynamic shared memory of a CTA


def _smem_bytes(stages: int, page_size: int, heads: int, head_dim: int,
                kv_bytes: int) -> int:
    # stages x (K and V tiles), two barriers and a scale pair a stage, a
    # flag: `smem_bytes` in ops/csrc/flash_decode.cu
    return stages * (2 * page_size * heads * head_dim * kv_bytes + 24) + 16


def decode_plan(B: int, H: int, head_dim: int, page_size: int, n_pages: int,
                kv_bytes: int, sms: int, smem_optin: int) -> DecodePlan:
    """The kernel's grid and ring from shapes alone (never the positions,
    which stay on the device). Every CTA takes all H heads unless a ring of
    two stages of whole pages would not fit in ``smem_optin`` bytes (or H >
    12); then it takes a group of heads, as few groups as fit. The chunk of
    pages is sized so that a full reservation of all B slots spreads over
    about ``_CTAS_PER_SM`` CTAs per SM (and so that the combine's chunk
    weights fit in the tiles). The ring has two stages, one for a one-page
    chunk. Raises where not even one head's two stages fit."""
    groups = -(-H // _MAX_GROUP_HEADS)
    while True:
        hg = -(-H // groups)
        if _smem_bytes(2, page_size, hg, head_dim, kv_bytes) <= smem_optin:
            break
        if hg == 1:
            raise ValueError(
                f"flash_decode: pages of page_size {page_size} x Dh "
                f"{head_dim} x {kv_bytes} bytes need "
                f"{_smem_bytes(2, page_size, 1, head_dim, kv_bytes)} bytes "
                f"of shared memory for two stages of one head, above the "
                f"card's {smem_optin}")
        groups += 1
    groups = -(-H // hg)
    tile = page_size * hg * head_dim * kv_bytes
    splits = min(n_pages, max(1, -(-_CTAS_PER_SM * sms // (B * groups))))
    while True:
        ppc = -(-n_pages // splits)
        splits = -(-n_pages // ppc)
        stages = min(_STAGES, ppc)
        # the combine keeps [group_heads, max_splits] f32 weights in the
        # tiles
        if hg * splits * 4 <= stages * 2 * tile:
            break
        splits = -(-n_pages // (ppc + 1))
    return DecodePlan(hg, groups, stages, ppc, splits,
                      _smem_bytes(stages, page_size, hg, head_dim, kv_bytes))


class SpanPlan(NamedTuple):
    """The span kernel's static launch shape for one set of tensor
    shapes."""
    group_heads: int      # heads a CTA folds (H, or a group of them)
    groups: int           # head groups: ceil(H / group_heads)
    link_tiles: int       # ceil(L / 16): a CTA takes 16 links
    stages: int           # depth of the bulk-copy ring
    pages_per_chunk: int  # split-K chunk of a slot's pages
    max_splits: int       # chunks a full reservation splits into
    smem_bytes: int       # dynamic shared memory of a CTA


def _span_tile_bytes(page_size: int, heads: int, head_dim: int,
                     kv_bytes: int) -> int:
    # a K or V tile: the page's rows as they lie in the pool
    # (`span_tile_bytes` in ops/csrc/flash_span.cu)
    return page_size * heads * head_dim * kv_bytes


def _span_smem_bytes(stages: int, page_size: int, heads: int,
                     head_dim: int, kv_bytes: int) -> int:
    # stages x (K and V tiles), a bf16 scratch of 2 x 16 padded rows a
    # head, two barriers and a scale pair a stage, a flag: `span_smem_bytes`
    # in ops/csrc/flash_span.cu
    tile = _span_tile_bytes(page_size, heads, head_dim, kv_bytes)
    scratch = heads * 2 * _KEY_BLOCK * (2 * head_dim + _ROW_PAD)
    return stages * (2 * tile + 24) + scratch + 16


def span_plan(B: int, L: int, H: int, head_dim: int, page_size: int,
              n_pages: int, kv_bytes: int, sms: int,
              smem_optin: int) -> SpanPlan:
    """The span kernel's grid and ring from shapes alone (never the
    positions). A CTA takes 16 links (``ceil(L / 16)`` link tiles, so a
    page is read once per 16 links) and all H heads unless two stages of
    whole pages would not fit in ``smem_optin`` bytes (or H > 12); then a
    group of heads, as few groups as fit. The chunk of pages is sized so
    that a full reservation of all B slots' link tiles and groups spreads
    over about two CTAs per SM (the kernel runs one an SM; at the serve
    shape 8-page chunks, which measured faster than the decode step's 4:
    ``scripts/profile_torch_span.py``), and so that the combine's per-head
    [16, max_splits] weights fit in the tiles. Raises where not even one
    head's two stages fit."""
    link_tiles = -(-L // _LINK_TILE)
    groups = -(-H // _MAX_GROUP_HEADS)
    while True:
        hg = -(-H // groups)
        if _span_smem_bytes(2, page_size, hg, head_dim, kv_bytes) \
                <= smem_optin:
            break
        if hg == 1:
            raise ValueError(
                f"flash_span: pages of page_size {page_size} x Dh "
                f"{head_dim} x {kv_bytes} bytes need "
                f"{_span_smem_bytes(2, page_size, 1, head_dim, kv_bytes)} "
                f"bytes of shared memory for two stages of one head, above "
                f"the card's {smem_optin}")
        groups += 1
    groups = -(-H // hg)
    tile = _span_tile_bytes(page_size, hg, head_dim, kv_bytes)
    splits = min(n_pages, max(1, -(-_SPAN_CTAS_PER_SM * sms
                                   // (B * groups * link_tiles))))
    while True:
        ppc = -(-n_pages // splits)
        splits = -(-n_pages // ppc)
        stages = min(_STAGES, ppc)
        # the combine keeps each head's m, l ([16, max_splits] each) and 16
        # reciprocal sums in the tiles
        if hg * (2 * _LINK_TILE * splits + _LINK_TILE) * 4 \
                <= stages * 2 * tile:
            break
        splits = -(-n_pages // (ppc + 1))
    return SpanPlan(hg, groups, link_tiles, stages, ppc, splits,
                    _span_smem_bytes(stages, page_size, hg, head_dim,
                                     kv_bytes))


def device_limits(device: torch.device) -> Tuple[int, int]:
    """(SM count, opt-in shared memory per block) of a CUDA device, read
    once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _device_limits:
        props = torch.cuda.get_device_properties(index)
        _device_limits[index] = (props.multi_processor_count,
                                 props.shared_memory_per_block_optin)
    return _device_limits[index]


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    buf = _tickets.get(index)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired_tickets.append(buf)
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _tickets[index] = buf
    return buf


def _check_kernel_args(q, pages_k, pages_v, block_table, positions,
                       scales_k, scales_v, span: bool = False) -> None:
    """The kernels' argument contract: flash_decode's (q [B, H, Dh],
    positions [B], q f32 or bf16) or, with ``span``, flash_span's (q
    [B, H, L, Dh], positions [B, L], q bf16)."""
    what = "flash_span" if span else "flash_decode"
    q_shape = "[B, H, L, Dh]" if span else "[B, H, Dh]"
    if q.dim() != (4 if span else 3) or pages_k.dim() != 4:
        raise ValueError(f"{what} takes q {q_shape} and pools "
                         f"[P, page_size, H, Dh], got {tuple(q.shape)} and "
                         f"{tuple(pages_k.shape)}")
    B, H, Dh = q.shape[0], q.shape[1], q.shape[-1]
    if pages_k.shape != pages_v.shape or tuple(pages_k.shape[2:]) != (H, Dh):
        raise ValueError(f"pool shapes {tuple(pages_k.shape)} / "
                         f"{tuple(pages_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    dtypes = (torch.bfloat16,) if span else tuple(_DTYPE_CODES)
    if q.dtype not in dtypes:
        raise ValueError(f"{what} takes {' or '.join(map(str, dtypes))} q, "
                         f"got {q.dtype}")
    tensors = [q, pages_k, pages_v, block_table, positions]
    if scales_k is None and scales_v is None:
        if not q.dtype == pages_k.dtype == pages_v.dtype:
            raise ValueError(f"fp pools must have q's dtype {q.dtype}, got "
                             f"{pages_k.dtype}, {pages_v.dtype} (int8 "
                             f"pools come with scales_k and scales_v)")
    else:
        if scales_k is None or scales_v is None:
            raise ValueError("int8 pools need both scales_k and scales_v")
        if not pages_k.dtype == pages_v.dtype == torch.int8:
            raise ValueError(f"scales are given, so the pools must be int8, "
                             f"got {pages_k.dtype}, {pages_v.dtype}")
        for s in (scales_k, scales_v):
            if s.dtype != torch.float32 \
                    or tuple(s.shape) != (pages_k.shape[0],):
                raise ValueError(f"scales must be float32 [{pages_k.shape[0]}]"
                                 f", got {s.dtype} {tuple(s.shape)}")
        tensors += [scales_k, scales_v]
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"{what} supports head_dim {_HEAD_DIMS}, got {Dh}")
    if block_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("block_table and positions must be int32")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(positions.shape) != tuple(q.shape[:1] + q.shape[2:-1]):
        raise ValueError(f"block_table {tuple(block_table.shape)} / "
                         f"positions {tuple(positions.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what} inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} inputs must be contiguous")


def flash_decode(q: torch.Tensor, pages_k: torch.Tensor,
                 pages_v: torch.Tensor, block_table: torch.Tensor,
                 positions: torch.Tensor,
                 scales_k: Optional[torch.Tensor] = None,
                 scales_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged single-query attention: ``q`` [B, H, Dh], pools
    ``[P, page_size, H, Dh]`` of q's dtype, or int8 with ``scales_k`` /
    ``scales_v`` [P] f32, ``block_table`` [B, n_pages] int32, ``positions``
    [B] int32 -> [B, H, Dh] in q's dtype, on CUDA tensors only (the kernel
    has no CPU mode)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode is the CUDA kernel and takes CUDA "
                         f"tensors, got {q.device}; the plain version is "
                         f"torch_paged_decode")
    _check_kernel_args(q, pages_k, pages_v, block_table, positions,
                       scales_k, scales_v)
    from ._build import check, load_library
    lib = load_library()
    B, H, Dh = q.shape
    int8 = scales_k is not None
    out = torch.empty_like(q)
    if B == 0:
        return out
    plan = decode_plan(B, H, Dh, pages_k.shape[1], block_table.shape[1],
                       pages_k.element_size(), *device_limits(q.device))
    ws_acc = ws_ml = tickets = None
    if plan.max_splits > 1:
        ws_acc = torch.empty((B, plan.max_splits, H, Dh),
                             dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((2, B, plan.max_splits, H), dtype=torch.float32,
                            device=q.device)
        tickets = _ticket_buffer(q.device, B * plan.groups)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        err = lib.dpt_flash_decode(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            ptr(scales_k), ptr(scales_v), block_table.data_ptr(),
            positions.data_ptr(), out.data_ptr(), ptr(ws_acc), ptr(ws_ml),
            ptr(tickets), B, H, Dh, pages_k.shape[1], block_table.shape[1],
            plan.group_heads, plan.stages, plan.pages_per_chunk,
            plan.max_splits, _DTYPE_CODES[q.dtype], int(int8),
            torch.cuda.current_stream().cuda_stream)
    check(lib, err, "flash_decode")
    _launches["int8" if int8 else "fp"] += 1
    return out


def flash_span(q: torch.Tensor, pages_k: torch.Tensor,
               pages_v: torch.Tensor, block_table: torch.Tensor,
               positions: torch.Tensor,
               scales_k: Optional[torch.Tensor] = None,
               scales_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged span attention on the span kernel: ``q`` [B, H, L, Dh] bf16,
    pools ``[P, page_size, H, Dh]`` bf16, or int8 with ``scales_k`` /
    ``scales_v`` [P] f32, ``block_table`` [B, n_pages] int32,
    ``positions`` [B, L] int32 (link j attends keys <= positions[b, j]; a
    link with a negative position gets zeros) -> [B, H, L, Dh] bf16, on
    CUDA tensors only (the kernel has no CPU mode)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_span is the CUDA kernel and takes CUDA "
                         f"tensors, got {q.device}; the plain version is "
                         f"torch_paged_span_decode")
    _check_kernel_args(q, pages_k, pages_v, block_table, positions,
                       scales_k, scales_v, span=True)
    from ._build import check, load_library
    lib = load_library()
    B, H, L, Dh = q.shape
    int8 = scales_k is not None
    out = torch.empty_like(q)
    if B == 0 or L == 0:
        return out
    plan = span_plan(B, L, H, Dh, pages_k.shape[1], block_table.shape[1],
                     pages_k.element_size(), *device_limits(q.device))
    ws_acc = ws_ml = tickets = None
    if plan.max_splits > 1:
        ws_acc = torch.empty((B, plan.max_splits, L, H, Dh),
                             dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((2, B, plan.max_splits, L, H),
                            dtype=torch.float32, device=q.device)
        tickets = _ticket_buffer(q.device,
                                 B * plan.groups * plan.link_tiles)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        err = lib.dpt_flash_span(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            ptr(scales_k), ptr(scales_v), block_table.data_ptr(),
            positions.data_ptr(), out.data_ptr(), ptr(ws_acc), ptr(ws_ml),
            ptr(tickets), B, H, L, Dh, pages_k.shape[1],
            block_table.shape[1], plan.group_heads, plan.stages,
            plan.pages_per_chunk, plan.max_splits, int(int8),
            torch.cuda.current_stream().cuda_stream)
    check(lib, err, "flash_span")
    _span_kernel_launches["int8" if int8 else "fp"] += 1
    return out


def pseudo_slot_span(q: torch.Tensor, pages_k: torch.Tensor,
                     pages_v: torch.Tensor, block_table: torch.Tensor,
                     positions: torch.Tensor,
                     scales_k: Optional[torch.Tensor] = None,
                     scales_v: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The span on the decode kernel: :func:`flash_decode` over B*L
    pseudo-slots (q as [B*L, H, Dh], each slot's block-table row repeated
    L times, positions flattened) -> [B, H, L, Dh]. The f32 route of
    :func:`paged_span_attention`; CUDA tensors only."""
    B, H, L, Dh = q.shape
    qf = q.transpose(1, 2).reshape(B * L, H, Dh).contiguous()
    bt = block_table.repeat_interleave(L, dim=0).contiguous()
    pos = positions.reshape(-1).to(torch.int32).contiguous()
    o = flash_decode(qf, pages_k, pages_v, bt, pos, scales_k, scales_v)
    return o.reshape(B, L, H, Dh).transpose(1, 2)


def paged_decode_attention(q: torch.Tensor, pages_k: torch.Tensor,
                           pages_v: torch.Tensor, block_table: torch.Tensor,
                           positions: torch.Tensor, impl: str = "auto",
                           scales_k: Optional[torch.Tensor] = None,
                           scales_v: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The decode-step seam: one generated token's attention, ``q``
    [B, H, Dh] -> [B, H, Dh]. The caller has already written the token's K/V
    into the pool; for int8 pools it passes the [P] scale sidecars and both
    arms dequantize."""
    if resolve_decode_impl(impl, q.device) == "cuda":
        return flash_decode(q, pages_k, pages_v, block_table, positions,
                            scales_k, scales_v)
    _plain_calls[0] += 1
    return torch_paged_decode(q, pages_k, pages_v, block_table, positions,
                              scales_k, scales_v)


def paged_span_attention(q: torch.Tensor, pages_k: torch.Tensor,
                         pages_v: torch.Tensor, block_table: torch.Tensor,
                         positions: torch.Tensor, impl: str = "auto",
                         scales_k: Optional[torch.Tensor] = None,
                         scales_v: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The speculative-verify seam: one dispatch attends a whole draft
    chain, ``q`` [B, H, L, Dh] and ``positions`` [B, L] -> [B, H, L, Dh].
    The caller has written every link's K/V into the pool and clamped the
    positions to the block table's reach. The kernel arm routes by q's
    dtype: bf16 q takes the span kernel (:func:`flash_span`, counted by
    :func:`span_kernel_launch_count`), f32 q the decode kernel over
    pseudo-slots (:func:`pseudo_slot_span`, counted by
    :func:`launch_count`), since tensor cores have no f32 path that holds
    f32's bar. There is no fallback: on CUDA tensors the route's kernel
    builds and launches or the call raises."""
    if resolve_decode_impl(impl, q.device) == "torch":
        _plain_calls[0] += 1
        return torch_paged_span_decode(q, pages_k, pages_v, block_table,
                                       positions, scales_k, scales_v)
    if q.dtype == torch.bfloat16:
        o = flash_span(q.contiguous(), pages_k, pages_v, block_table,
                       positions.to(torch.int32).contiguous(), scales_k,
                       scales_v)
    else:
        o = pseudo_slot_span(q, pages_k, pages_v, block_table, positions,
                             scales_k, scales_v)
    _span_launches[0] += 1
    return o


def decode_hbm_bytes(block_table: np.ndarray, positions: np.ndarray,
                     page_size: int, n_heads: int, head_dim: int,
                     dtype_bytes: int = 4, quantized: bool = False,
                     step_table: bool = True) -> int:
    """Device-memory bytes one decode-attention call must move: each
    DISTINCT live page's K and V blocks once (a page shared by several
    slots counts once), one q read and one output write per slot, and the
    index bytes of the schedule. ``quantized`` prices int8 pools at 1
    byte an element (q and out keep ``dtype_bytes``).

    ``step_table=True`` is the JAX package's census, copied so that both
    packages price the same work: the TPU schedule reads a step table of 7
    int32 columns per block-table entry, 9 when ``quantized`` (the page's
    two scales ride it). ``step_table=False`` prices the CUDA kernel, which
    has no step table: it reads each live block-table entry and each slot's
    position once, and for int8 pools the 8 bytes of K and V scales of each
    live entry. The kernel's bound is that number over the card's memory
    rate."""
    bt = np.asarray(block_table)
    pos = np.asarray(positions)
    B, n = bt.shape
    page_bytes = page_size * n_heads * head_dim * (1 if quantized
                                                   else dtype_bytes)
    qo_bytes = n_heads * head_dim * dtype_bytes
    n_live = np.clip(pos // page_size + 1, 0, n)
    live_entries = bt[np.arange(n)[None, :] < n_live[:, None]]
    total = 2 * page_bytes * np.unique(live_entries).size  # K and V blocks
    total += B * 2 * qo_bytes                  # q read + out write
    if step_table:
        total += (B * n) * (9 if quantized else 7) * 4   # TPU step table
    else:
        live = int(n_live.sum())
        total += (live + B) * 4                    # live entries + positions
        if quantized:
            total += live * 8                      # K and V scales
    return int(total)


def span_hbm_bytes(block_table: np.ndarray, positions: np.ndarray,
                   page_size: int, n_heads: int, head_dim: int,
                   dtype_bytes: int = 2, quantized: bool = False) -> int:
    """Device-memory bytes one span call must move, as the span kernel
    reads them (``positions`` [B, L]): each DISTINCT live page's K and V
    blocks once (a slot's live pages reach its links' largest position; a
    page shared by several slots counts once), q read and out written once
    per link, each slot's live block-table entries once, one position per
    link, and for int8 pools (``quantized``: 1 byte an element) the 8 bytes
    of K and V scales of each live entry. The kernel's bound is that number
    over the card's memory rate."""
    bt = np.asarray(block_table)
    pos = np.asarray(positions)
    B, n = bt.shape
    L = pos.shape[1]
    page_bytes = page_size * n_heads * head_dim * (1 if quantized
                                                   else dtype_bytes)
    n_live = np.clip(pos.max(axis=1) // page_size + 1, 0, n)
    pages = np.unique(bt[np.arange(n)[None, :] < n_live[:, None]])
    live = int(n_live.sum())
    total = 2 * page_bytes * pages.size                # K and V blocks
    total += 2 * B * L * n_heads * head_dim * dtype_bytes  # q and out
    total += (live + B * L) * 4                        # entries, positions
    if quantized:
        total += live * 8                              # K and V scales
    return int(total)
