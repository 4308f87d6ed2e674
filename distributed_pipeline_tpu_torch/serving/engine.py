"""DecodeEngine: the prefill/decode phase split, the port of
``distributed_pipeline_tpu/serving/engine.py``.

* ``prefill``  — one causal forward over a fixed-shape prompt batch that
  writes the prompts' K/V into the paged pool, picks each request's first
  token, and merges it into the decode state at the requests' target slots;
* ``decode``   — ``decode_span`` tokens for every decode slot: per-slot
  positions (each slot at its own depth), paged attention over each slot's
  live prefix, sampling, state out;
* ``verify``   — speculative decoding (``spec_tokens`` K > 0): ONE forward
  over each slot's chain ``[current, d_1..d_K]`` (the backbone's span
  branch) and the target's pick at every link, keyed per (slot, position)
  as ``decode`` keys it. The host owns rollback: it declares each round's
  (token, position) state, and ``set_decode_state`` pushes it to an engine
  that then decodes (the model draft).

The JAX engine compiles each phase once (AOT executables). Here each phase
is a method over fixed-shape device buffers, and on a CUDA device it is
captured once as a ``torch.cuda.CUDAGraph`` — after one eager call, the
phase's real first dispatch — and from then on only replayed: ``prefill``
at ``[prefill_batch, max_prompt_len]``, ``decode`` with all
``decode_span`` steps in one graph, ``verify`` at ``[S, K + 1]``.
``executables()`` returns the graphs by phase, ``compile_time_s`` sums the
capture time, and a capture or a replay that fails raises; nothing falls
back to eager. ``cuda_graphs=False`` builds the eager engine, the on-card
reference; CPU tensors always run eagerly.

Every input of a phase lives in a static device buffer, filled by a
non-blocking copy from pinned host memory (``_stage``); every output is
copied out of the graph's buffers before the call returns, so the next
replay cannot overwrite what a caller holds. State (the paged KV pool,
the token/position vectors, block tables, the active mask) stays on the
device; the pool is updated in place. ``kv_quant="int8"`` keeps int8
pages with a ``[P]`` f32 scale sidecar for K and for V per layer (about
half the bytes of a bf16 pool). An MoE model routes every token to its
exact top-k experts in every phase (``moe_no_drop=True``, the JAX
engine's ``clone(moe_no_drop=True)``), with no host sync, so the phases
capture as they do for a dense model.

Sampling keys its noise on the device as a pure function of (seed, slot,
position, vocab index) (``models.sampling.keyed_gumbel``), the JAX
engine's per-(slot, position) key fold, so nothing in a phase reads the
host. The seed is a device tensor the graphs read:
:meth:`DecodeEngine.set_seed` (the JAX engine's ``set_rng``) rewrites it
in place, and the next replay draws from the new seed. Launch counters
(``ops/flash_decode.py``, and ``ops/flash_attention.py`` for a prefill at
L >= 1024 on the flash forward) tick in the kernels' Python wrappers,
which a replay does not run: each graph records the launches its capture
made and adds them on every replay.

Page migration (disaggregated serving, ``mpmd/disagg.py``):
:meth:`DecodeEngine.extract_pages` pulls pages out of every pool tensor as
host rows keyed by the JAX engine's leaf paths
(``['backbone']['block_{i}']['attn']['pages_k']``, ...), so the wire format
is the JAX package's; :meth:`DecodeEngine.ingest_pages` scatters such rows
in place at this engine's own page ids, into the pool tensors the graphs
were captured on, and :meth:`DecodeEngine.set_slot_state` seeds one slot's
token and position.

``guard=True`` (the sanitizer) runs every dispatch under
``torch.cuda.set_sync_debug_mode("error")``, the analogue of JAX's
``transfer_guard("disallow")``: an operation that synchronizes with the
host inside a dispatch raises.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.backbone import KV_QUANTS
from ..models.gpt2 import GPT2Model
from ..models.sampling import KeyedPicker
from ..ops import flash_attention as fa
from ..ops import flash_decode as fd

__all__ = ["DecodeEngine"]

# the pool tensors of one layer's kv_cache entry, in order (the int8 pools'
# scale sidecars last), named as the JAX engine's cache leaves
_POOL_NAMES = ("pages_k", "pages_v", "scales_k", "scales_v")

def _launch_counters() -> Dict[str, Dict[str, int]]:
    return {"decode": fd.launch_counters(), "flash": fa.launch_counters()}


def _add_launches(delta: Dict[str, Dict[str, int]], times: int = 1) -> None:
    fd.add_launches(delta["decode"], times)
    fa.add_launches(delta["flash"], times)


class _Phase:
    """One captured phase: its graph, the launches one replay makes (by
    module and counter), and the static output buffer it fills."""

    def __init__(self, graph, launches: Dict[str, Dict[str, int]],
                 out: torch.Tensor) -> None:
        self.graph = graph
        self.launches = launches
        self.out = out


class DecodeEngine:
    """Device half of the serving stack: paged-cache decode state plus the
    phases that advance it.

    Parameters
    ----------
    model : the GPT-2 model, already on ``device`` with its weights.
    decode_slots : decode batch size S. Decode ALWAYS runs all S slots
        (inactive slots write to the trash page and their outputs are
        ignored).
    page_size, max_pages : paged KV pool geometry, per layer.
    max_prompt_len : prefill length (prompts pad up to it).
    max_len : longest prompt+generation a slot can hold (caps the block
        table width; <= the model's seq_len for position bounds).
    prefill_batch : prefill batch size (short admissions pad with dummy
        rows).
    decode_span : tokens generated per ``decode()`` call. Slots whose
        budget ends mid-span overshoot by up to ``decode_span - 1``
        positions: writes clamp into their own reserved pages or go to the
        trash page, the position embedding clamps to the table's last row,
        and outputs past budget are discarded at fetch.
    decode_impl : decode-step attention arm (``ops/flash_decode.py``).
    kv_quant : paged KV storage, "fp" (the model's dtype) or "int8" (int8
        pages with per-page f32 scales; ``serving/paged_kv.py``).
    spec_tokens : draft length K of :meth:`verify` (0 = no speculative
        decoding).
    cuda_graphs : on a CUDA device, capture each phase once and replay it
        (default); False keeps every call eager (the on-card reference).
    guard : run every dispatch under ``set_sync_debug_mode("error")``.
    on_capture : called with (phase name, seconds) after each capture.
    """

    def __init__(self, model: GPT2Model, *, decode_slots: int,
                 page_size: int, max_pages: int, max_prompt_len: int,
                 max_len: int = 0, prefill_batch: int = 0,
                 decode_span: int = 1, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 decode_impl: str = "auto", kv_quant: str = "fp",
                 spec_tokens: int = 0, cuda_graphs: bool = True,
                 guard: bool = False,
                 on_capture: Optional[Callable[[str, float], None]] = None
                 ) -> None:
        if model.family != "gpt2":
            raise ValueError(f"the decode engine serves the gpt2 family, "
                             f"got {model.family!r}")
        if model.scan_layers:
            # the JAX engine's refusal: stacked models decode through
            # models/sampling.py::gpt2_decode (the dense cache)
            raise NotImplementedError(
                "paged decode needs per-layer named blocks; scan_layers "
                "models decode through models/sampling.py::gpt2_decode")
        max_len = max_len or model.seq_len
        if not 1 <= max_len <= model.seq_len:
            raise ValueError(f"max_len {max_len} must be in [1, seq_len="
                             f"{model.seq_len}] (position table bound)")
        if not 2 <= max_prompt_len <= max_len:
            # >= 2: a length-1 prefill is shape-ambiguous with a decode step
            raise ValueError(f"max_prompt_len {max_prompt_len} must be in "
                             f"[2, max_len={max_len}]")
        if decode_span < 1:
            raise ValueError(f"decode_span must be >= 1, got {decode_span}")
        if max_pages < 2:
            raise ValueError(f"max_pages must be >= 2 (page 0 is the trash "
                             f"page), got {max_pages}")
        if kv_quant not in KV_QUANTS:
            raise ValueError(f"kv_quant must be fp|int8, got {kv_quant!r}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        self.model = model
        self.spec_tokens = spec_tokens
        self.device = model.pos_emb.device
        self.decode_slots = decode_slots
        self.page_size = page_size
        self.max_pages = max_pages
        self.max_prompt_len = max_prompt_len
        self.max_len = max_len
        self.pages_per_slot = -(-max_len // page_size)
        self.prefill_batch = prefill_batch or min(decode_slots, 8)
        self.decode_span = decode_span
        self.decode_impl = decode_impl
        self.kv_quant = kv_quant
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self.guard = bool(guard) and self.device.type == "cuda"
        self._on_capture = on_capture
        self._pick = KeyedPicker(temperature, top_k, top_p, seed,
                                 model.vocab_size, self.device)

        s, dev = decode_slots, self.device
        H = model.num_heads
        dh = model.hidden_size // H
        shape = (max_pages, page_size, H, dh)
        pool_dtype = torch.int8 if kv_quant == "int8" else model.dtype
        # per layer (pages_k, pages_v), and (scales_k, scales_v) for an int8
        # pool
        self.kv_cache: List[tuple] = []
        for _ in range(model.num_layers):
            entry = [torch.zeros(shape, dtype=pool_dtype, device=dev)
                     for _ in range(2)]
            if kv_quant == "int8":
                entry += [torch.zeros((max_pages,), dtype=torch.float32,
                                      device=dev) for _ in range(2)]
            self.kv_cache.append(tuple(entry))

        def zeros(*shape_):
            return torch.zeros(shape_, dtype=torch.int32, device=dev)

        # decode state: row s of the token/position buffers is the scratch
        # row a prefill's dummy rows merge into
        self._tok_buf, self._pos_buf = zeros(s + 1), zeros(s + 1)
        self.tokens, self.positions = self._tok_buf[:s], self._pos_buf[:s]
        self.block_table = zeros(s, self.pages_per_slot)
        self.active = zeros(s)
        self._slot_ids = torch.arange(s, dtype=torch.int32, device=dev)
        # phase inputs and outputs
        bp, lp = self.prefill_batch, max_prompt_len
        self._pf_ids, self._pf_lens = zeros(bp, lp), zeros(bp)
        self._pf_smap, self._pf_tables = zeros(bp), zeros(bp,
                                                          self.pages_per_slot)
        self._pf_out = zeros(s)
        self._dec_out = zeros(decode_span, s)
        kp1 = spec_tokens + 1
        self._vf_chain, self._vf_pos = zeros(s, kp1), zeros(s)
        self._vf_out = zeros(kp1, s)

        self._phases: Dict[str, _Phase] = {}
        self.compile_time_s = 0.0
        self.captures: Dict[str, int] = {}
        self.dispatches: Dict[str, int] = {}
        # test hook: called inside each guarded dispatch with the phase's
        # name (the sanitizer's test injects a host sync through it)
        self._dispatch_hook: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------ plumbing

    def kv_pool_bytes(self) -> int:
        """Device bytes the paged KV pool holds: pages and scale sidecars,
        every layer. An int8 pool is at most 0.55x an fp pool of the same
        geometry (the JAX package's bar)."""
        return int(sum(t.numel() * t.element_size()
                       for entry in self.kv_cache for t in entry))

    def _pool_leaves(self) -> List[tuple]:
        """(key, tensor) for every pool tensor, keyed as the JAX engine's
        ``_pool_leaves`` keys its cache leaves: an engine built from the
        same model config in another process derives the same keys."""
        return [(f"['backbone']['block_{i}']['attn']['{name}']", t)
                for i, entry in enumerate(self.kv_cache)
                for name, t in zip(_POOL_NAMES, entry)]

    def extract_pages(self, page_ids: np.ndarray) -> Dict[str, np.ndarray]:
        """The contents of ``page_ids`` in every pool tensor as host arrays
        keyed by leaf path: the KV payload a disaggregated prefill worker
        ships to a decode server. Row i holds page ``page_ids[i]`` (the
        receiver scatters the same rows at its own ids). bf16 rows travel
        as their int16 bit pattern (numpy has no bf16);
        :meth:`ingest_pages` views them back."""
        idx = torch.as_tensor(np.ascontiguousarray(page_ids, np.int64),
                              device=self.device)
        out = {}
        for key, leaf in self._pool_leaves():
            rows = leaf.index_select(0, idx)
            if rows.dtype == torch.bfloat16:
                rows = rows.view(torch.int16)
            out[key] = rows.cpu().numpy()
        return out

    @torch.inference_mode()
    def ingest_pages(self, page_ids: np.ndarray,
                     pools: Dict[str, np.ndarray]) -> None:
        """Scatter transferred pool rows (an :meth:`extract_pages` payload)
        into this engine's pools at ``page_ids``, in place: the pool
        tensors stay the ones the graphs were captured on. Raises
        ``ValueError`` when the payload's keys or row shapes differ from
        this engine's (the prefill and decode engines were built from
        different models or geometries); nothing is written then."""
        mine = dict(self._pool_leaves())
        if set(pools) != set(mine):
            raise ValueError(
                f"pool-leaf mismatch: payload has {sorted(pools)} but this "
                f"engine has {sorted(mine)} (prefill/decode model drift?)")
        n = len(page_ids)
        for key, leaf in mine.items():
            shape = tuple(np.shape(pools[key]))
            if shape != (n, *leaf.shape[1:]):
                raise ValueError(
                    f"{key}: payload rows {shape} do not fit {n} pages of "
                    f"{tuple(leaf.shape[1:])}")
        idx = torch.as_tensor(np.ascontiguousarray(page_ids, np.int64),
                              device=self.device)
        for key, leaf in mine.items():
            src = torch.from_numpy(np.array(pools[key]))  # a writable copy
            if leaf.dtype == torch.bfloat16 and src.dtype == torch.int16:
                src = src.view(torch.bfloat16)
            leaf.index_copy_(0, idx, src.to(self.device, leaf.dtype))

    def set_slot_state(self, slot: int, token: int, position: int) -> None:
        """Seed one slot's decode state by hand: the disaggregated
        admission path's stand-in for the merge at the tail of the prefill
        phase (the transferred request arrives with its first token and
        position already picked by the prefill worker). Written in place,
        so the captured graphs read it."""
        with self._guarded():
            self._tok_buf[slot].fill_(int(token))
            self._pos_buf[slot].fill_(int(position))

    def executables(self) -> Dict[str, "torch.cuda.CUDAGraph"]:
        """The captured graphs keyed by phase name ("prefill", "decode",
        "verify"); empty on an eager engine."""
        return {name: ph.graph for name, ph in self._phases.items()}

    @contextlib.contextmanager
    def _guarded(self):
        if not self.guard:
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def _stage(self, dst: torch.Tensor, x: np.ndarray) -> None:
        """Copy a host array into a static device buffer: through a fresh
        pinned host tensor and a non-blocking copy on the card (PyTorch's
        pinned allocator does not hand the block out again before the copy
        has run), in place on the CPU."""
        src = torch.from_numpy(np.ascontiguousarray(x, np.int32)).reshape(
            dst.shape)
        if dst.is_cuda:
            pinned = torch.empty(dst.shape, dtype=torch.int32,
                                 pin_memory=True)
            pinned.copy_(src)
            dst.copy_(pinned, non_blocking=True)
        else:
            dst.copy_(src)

    def _dispatch(self, name: str, fn: Callable[[], torch.Tensor]
                  ) -> torch.Tensor:
        """Run one phase: eagerly, or (graphs) its first call eagerly, then
        a capture outside the guard, then replays only. Returns a copy of
        the phase's output buffer."""
        self.dispatches[name] = self.dispatches.get(name, 0) + 1
        if self._dispatch_hook is not None:
            self._dispatch_hook(name)
        phase = self._phases.get(name)
        if phase is not None:
            phase.graph.replay()
            _add_launches(phase.launches)
            return phase.out.clone()
        out = fn()
        if self.cuda_graphs:
            copy = out.clone()
            self._capture(name, fn)
            return copy
        return out.clone()

    def _capture(self, name: str, fn: Callable[[], torch.Tensor]) -> None:
        """Capture ``fn`` as a CUDA graph. A capture synchronizes the
        device, so the sanitizer's guard is lifted for it (as a JAX
        compile runs outside the transfer guard's reach). The launches the
        capture counted are taken back and kept for the replays."""
        prev = torch.cuda.get_sync_debug_mode() if self.guard else None
        if self.guard:
            torch.cuda.set_sync_debug_mode(0)
        try:
            t0 = time.perf_counter()
            before = _launch_counters()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn()
            after = _launch_counters()
            delta = {mod: {k: after[mod][k] - before[mod][k]
                           for k in after[mod]} for mod in after}
            _add_launches(delta, times=-1)
            torch.cuda.synchronize(self.device)
            seconds = time.perf_counter() - t0
        finally:
            if self.guard:
                torch.cuda.set_sync_debug_mode(prev)
        self._phases[name] = _Phase(graph, delta, out)
        self.captures[name] = self.captures.get(name, 0) + 1
        self.compile_time_s += seconds
        if self._on_capture is not None:
            self._on_capture(name, seconds)

    # ---------------------------------------------------------- host state

    def set_block_tables(self, table: np.ndarray) -> None:
        """Refresh the device block table (admission/free changed the host
        copy). Shape stays [S, pages_per_slot]."""
        with self._guarded():
            self._stage(self.block_table, table)

    def set_active(self, active: np.ndarray) -> None:
        with self._guarded():
            self._stage(self.active, active)

    def set_seed(self, seed: int) -> None:
        """Sample from ``seed`` from the next dispatch on (the seed is
        written in place, so the captured graphs read it)."""
        with self._guarded():
            self._pick.set_seed(seed)

    def set_decode_state(self, tokens: np.ndarray,
                         positions: np.ndarray) -> None:
        """Push the full [S] (token, position) state from the host: the
        speculative scheduler's rollback primitive, declaring the
        post-acceptance state before a round's dispatches."""
        with self._guarded():
            self._stage(self.tokens, tokens)
            self._stage(self.positions, positions)

    # --------------------------------------------------------------- phases

    def _prefill_fn(self) -> torch.Tensor:
        ids, lens, smap = self._pf_ids, self._pf_lens, self._pf_smap
        pad = (torch.arange(ids.shape[1], device=self.device)[None, :]
               < lens[:, None]).to(torch.int32)
        logits = self.model(ids, pad, block_table=self._pf_tables,
                            kv_cache=self.kv_cache,
                            decode_impl=self.decode_impl,
                            kv_quant=self.kv_quant, moe_no_drop=True)
        rows = torch.arange(ids.shape[0], device=self.device)
        last = logits[rows, torch.clamp(lens - 1, min=0).long()]  # [Bp, V]
        # the first token sits at position prompt_len of its target slot
        # (dummies fold as slot 0: picked, then merged into the scratch row)
        first = self._pick(last, lens, torch.clamp(smap, min=0))
        target = torch.where(smap >= 0, smap, self.decode_slots).long()
        self._tok_buf.scatter_(0, target, first)
        self._pos_buf.scatter_(0, target, lens)
        self._pf_out.copy_(self.tokens)
        return self._pf_out

    def _decode_fn(self) -> torch.Tensor:
        live = self.active > 0
        for i in range(self.decode_span):
            logits = self.model(self.tokens[:, None], None,
                                cache_index=self.positions,
                                block_table=self.block_table,
                                kv_cache=self.kv_cache,
                                decode_impl=self.decode_impl,
                                kv_quant=self.kv_quant, moe_no_drop=True)
            nxt = self._pick(logits[:, 0], self.positions + 1,
                             self._slot_ids)
            self.tokens.copy_(torch.where(live, nxt, self.tokens))
            self.positions.copy_(torch.where(live, self.positions + 1,
                                             self.positions))
            self._dec_out[i].copy_(self.tokens)
        return self._dec_out

    def _verify_fn(self) -> torch.Tensor:
        S, kp1 = self.decode_slots, self.spec_tokens + 1
        pos = self._vf_pos
        logits = self.model(self._vf_chain, None, cache_index=pos,
                            block_table=self.block_table,
                            kv_cache=self.kv_cache,
                            decode_impl=self.decode_impl,
                            kv_quant=self.kv_quant,
                            moe_no_drop=True)                  # [S, K+1, V]
        # one flattened pick over all S*(K+1) rows, keyed per (slot,
        # position): row j of slot s picks what decode would there
        pos_f = pos[:, None] + 1 + torch.arange(
            kp1, dtype=torch.int32, device=self.device)[None, :]
        slot_f = self._slot_ids.repeat_interleave(kp1)
        seq = self._pick(logits.reshape(S * kp1, -1), pos_f.reshape(-1),
                         slot_f)
        self._vf_out.copy_(seq.reshape(S, kp1).T)
        return self._vf_out

    @torch.inference_mode()
    def prefill(self, ids: np.ndarray, prompt_lens: np.ndarray,
                slot_map: np.ndarray, slot_tables: np.ndarray
                ) -> torch.Tensor:
        """One admission batch. ``ids`` [Bp, Lp] zero-padded prompts;
        ``slot_map`` [Bp] target decode slot (-1 = dummy padding row);
        ``slot_tables`` [Bp, pages_per_slot] the block-table rows the
        prefill writes through (all-trash for dummies). Returns the
        post-merge tokens vector (a fresh device tensor that later calls do
        not modify)."""
        with self._guarded():
            self._stage(self._pf_ids, ids)
            self._stage(self._pf_lens, prompt_lens)
            self._stage(self._pf_smap, slot_map)
            self._stage(self._pf_tables, slot_tables)
            return self._dispatch("prefill", self._prefill_fn)

    @torch.inference_mode()
    def decode(self) -> torch.Tensor:
        """Advance every slot by ``decode_span`` token(s). Each step feeds
        each slot's current token at its own position, writes its K/V page
        entry, attends over its live prefix and picks the next token (keyed
        at the position it will occupy). Inactive slots write to trash and
        keep their state frozen. Returns the picked tokens, [S] at span 1
        and [span, S] above, as a fresh device tensor."""
        with self._guarded():
            out = self._dispatch("decode", self._decode_fn)
        return out[0] if self.decode_span == 1 else out

    @torch.inference_mode()
    def verify(self, draft: np.ndarray, tokens: np.ndarray,
               positions: np.ndarray) -> torch.Tensor:
        """Speculatively verify a [K, S] draft in one forward: each slot's
        chain ``[tokens[s], draft[:, s]]`` runs as a span at positions
        ``positions[s] ..``, every link's K/V is written before the span
        attention reads the live prefix plus the earlier links, and the
        target's pick at every link comes back as a [K + 1, S] device
        tensor (row j picks the token at ``positions + 1 + j``, keyed per
        (slot, position) exactly as :meth:`decode` keys it, so accepted
        tokens are the non-speculative path's, greedy or sampled). The
        engine's own state vectors are not advanced: the host walks
        acceptance and declares the next round's state. Rejected links'
        writes sit past the live position in the slot's own pages, masked
        until overwritten; inactive slots' picks are never read."""
        if self.spec_tokens <= 0:
            raise RuntimeError("engine built with spec_tokens=0")
        S, kp1 = self.decode_slots, self.spec_tokens + 1
        draft = np.asarray(draft, np.int32)
        if draft.shape != (kp1 - 1, S):
            raise ValueError(f"draft must be [{kp1 - 1}, {S}], got "
                             f"{draft.shape}")
        chain = np.concatenate([np.asarray(tokens, np.int32)[:, None],
                                draft.T], axis=1)              # [S, K+1]
        with self._guarded():
            self._stage(self._vf_chain, chain)
            self._stage(self._vf_pos, positions)
            return self._dispatch("verify", self._verify_fn)
