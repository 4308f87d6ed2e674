"""DecodeServer: continuous batching over the prefill/decode engine, the port
of ``distributed_pipeline_tpu/serving/scheduler.py``.

Every step, queued requests are admitted into whatever slots are free
(prefill batched up to ``prefill_batch``), decode runs all slots with an
active mask, and a finished request frees its slot and pages at once.

Host/device split: the host dispatches decode step N, then fetches the
tokens of step N - ``dispatch_lag``. Each dispatch's tokens start a
non-blocking copy to pinned host memory with an event behind it; the fetch
waits on that event only, so scheduler bookkeeping overlaps device time.
Completion is COUNT-based (each request's budget is fixed at admission); an
optional ``eos_id`` finishes a request early, observed at fetch.

Invariants (tests/test_torch_port_serve.py): no slot or page leaks; pages
for a request's worst case (prompt + budget) are reserved at admission, so
an admitted request always completes; admissions touch only free slots and
pages, so in-flight requests' outputs do not change.

``spec_tokens = K > 0`` turns on speculative decoding: each round a draft
(``spec_draft``: "ngram" prompt lookup on the host, or "model", an
early-exit engine over the target's first ``draft_layers`` blocks)
proposes K tokens a slot, ONE verify forward yields the target's pick at
every link, and the host walks acceptance (``serving/spec.py``): greedy
output is token-identical to the non-speculative path. Rounds are
synchronous (the verify result is the next round's input), so
``dispatch_lag`` does not apply.

``prefix_cache=True`` shares the pages of full prompt pages between
requests whose prompts open with the same tokens (``PrefixCache``,
refcounted, LRU eviction under pool pressure); a sharing prefill writes
none of the pages it acquired. ``sanitize=True`` counts the engines' CUDA
graph captures (``recompile_count``; growth after the first fetched token
is a ``steady_recompile``) and runs every engine dispatch under
``set_sync_debug_mode("error")``; trips and steady captures go into
``sanitize_report``. ``census=True`` counts each dispatch's FLOPs and
bytes (``obs/ledger.ServeCensus``, ~0.1 ms of host time a decode
dispatch, so it is armed only for the ledger) and ``cost_ledger()`` gives
the JAX package's per-phase ledger rows.

``set_params`` is the fleet's hot swap: the new weights are copied IN
PLACE into the model's tensors, which the captured graphs read, so the
next replay serves them. ``submit_prefilled`` admits a request whose
prefill ran in another process (disaggregated serving,
``mpmd/disagg.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Deque, List, Optional

import numpy as np
import torch

from ..models.gpt2 import GPT2Model
from ..obs.ledger import (ServeCensus, device_peak_flops,
                          roofline_attribution)
from ..utils.perf import (EventStats, RecompileMonitor, SanitizeReport,
                          transformer_decode_flops_per_token)
from .engine import DecodeEngine
from .paged_kv import TRASH_PAGE, PageManager, PrefixCache
from .spec import DRAFT_KINDS, ngram_propose, truncated_draft

__all__ = ["Request", "DecodeServer", "one_shot_decode"]


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle bookkeeping."""

    id: int
    prompt: np.ndarray              # int32 [prompt_len]
    max_new_tokens: int
    g_max: int = 0                  # tokens this request WILL generate:
    # min(max_new_tokens, max_len - prompt_len), fixed at submit
    eos_id: Optional[int] = None
    submit_t: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None  # submit -> first token FETCHED
    finished: bool = False          # output collection complete

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class _SlotState:
    """Host mirror of one decode slot: dispatch-side generation count and
    position (no device fetch needed to schedule)."""

    req: Request
    pages: np.ndarray               # page ids reserved for this request
    n_shared: int = 0               # leading pages acquired from the
    # prefix cache (written by the request that published them)
    generated: int = 1              # prefill produced token #1
    position: int = 0               # index of the token currently in state


class _Fetch:
    """A dispatch's token tensor on its way to the host: a non-blocking copy
    into pinned memory plus the event that marks its end (CPU tensors are
    already there)."""

    def __init__(self, toks: torch.Tensor) -> None:
        self.event = None
        if toks.is_cuda:
            self.host = toks.to("cpu", non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = toks

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class DecodeServer:
    """Continuous-batching decode service over a :class:`DecodeEngine`.

    ``submit()`` enqueues requests; ``step()`` advances the world by one
    decode dispatch (admitting first, fetching last); ``drain()`` runs until
    everything submitted has completed. ``device`` is where the model lives
    and where the engine keeps its state (the model is moved there).
    ``cuda_graphs=False`` builds eager engines (the on-card reference of
    the graph-replayed ones; CPU engines are eager anyway)."""

    def __init__(self, model: GPT2Model, *, decode_slots: int = 8,
                 page_size: int = 16, max_pages: int = 0,
                 max_prompt_len: int = 0, max_len: int = 0,
                 prefill_batch: int = 0, decode_span: int = 1,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None, dispatch_lag: int = 1,
                 decode_impl: str = "auto", kv_quant: str = "fp",
                 spec_tokens: int = 0, spec_draft: str = "ngram",
                 draft_layers: int = 2, sanitize: bool = False,
                 prefix_cache: bool = False, cuda_graphs: bool = True,
                 census: bool = False, device=None) -> None:
        from ..utils.device import resolve_device
        if spec_tokens > 0 and spec_draft not in DRAFT_KINDS:
            raise ValueError(f"spec_draft must be one of {DRAFT_KINDS}, "
                             f"got {spec_draft!r}")
        self.spec_tokens = spec_tokens
        self.spec_draft = spec_draft
        self.device = resolve_device(device)
        self.sanitize = sanitize
        # the port's compiles are graph captures: counted always (the
        # summary's compile split), their sites kept under sanitize
        self._recompiles = RecompileMonitor(capture_sites=sanitize)
        self.sanitize_report = SanitizeReport()
        self._recompiles_at_first_token: Optional[int] = None
        self._sanitizer_reported = False
        model = model.to(self.device).eval()
        max_len = max_len or model.seq_len
        max_prompt_len = max_prompt_len or max(2, max_len // 2)
        pages_per_slot = -(-max_len // page_size)
        if max_pages <= 0:
            # full residency default: every slot can hold max_len
            max_pages = 1 + decode_slots * pages_per_slot
        self.engine = DecodeEngine(
            model, decode_slots=decode_slots, page_size=page_size,
            max_pages=max_pages, max_prompt_len=max_prompt_len,
            max_len=max_len, prefill_batch=prefill_batch,
            decode_span=decode_span, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, decode_impl=decode_impl,
            kv_quant=kv_quant, spec_tokens=spec_tokens,
            cuda_graphs=cuda_graphs, guard=sanitize,
            on_capture=self._recompiles.note)
        self._draft_engine: Optional[DecodeEngine] = None
        self._draft_fpt = 0.0
        if spec_tokens > 0 and spec_draft == "model":
            # Early-exit draft over the target's first draft_layers blocks,
            # on a static full-residency pool: slot s owns pages
            # [1 + s*pps, 1 + (s+1)*pps) for good, so the draft needs no
            # allocator, and rollback is the host's state push each round
            # (accepted draft K/V is valid by the acceptance rule)
            pps = self.engine.pages_per_slot
            draft = truncated_draft(model, draft_layers)
            self._draft_engine = DecodeEngine(
                draft, decode_slots=decode_slots, page_size=page_size,
                max_pages=1 + decode_slots * pps,
                max_prompt_len=max_prompt_len, max_len=max_len,
                prefill_batch=prefill_batch, decode_span=1, seed=seed,
                decode_impl=decode_impl, kv_quant=kv_quant,
                cuda_graphs=cuda_graphs, guard=sanitize,
                on_capture=self._recompiles.note)
            self._draft_fpt = transformer_decode_flops_per_token(
                sum(p.numel() for p in draft.parameters()))
            self._draft_tables = np.arange(
                1, 1 + decode_slots * pps,
                dtype=np.int32).reshape(decode_slots, pps)
            self._draft_engine.set_block_tables(self._draft_tables)
        self.mgr = PageManager(max_pages, page_size)
        # shared-prefix page reuse: requests whose prompts open with the
        # same full pages share them, refcounted (PrefixCache)
        self.prefix = PrefixCache(self.mgr) if prefix_cache else None
        self.model = model
        self.census = None if not census else ServeCensus(
            num_layers=model.num_layers, hidden=model.hidden_size,
            heads=model.num_heads, vocab=model.vocab_size,
            compute_bytes=torch.empty((), dtype=model.dtype).element_size(),
            kv_quant=kv_quant, page_size=page_size, max_pages=max_pages)
        s = decode_slots
        self.block_tables = np.zeros((s, self.engine.pages_per_slot),
                                     np.int32)  # all TRASH_PAGE
        self.active = np.zeros((s,), np.int32)
        self.slots: List[Optional[_SlotState]] = [None] * s
        self.queue: Deque[Request] = collections.deque()
        self.default_eos_id = eos_id
        self.dispatch_lag = max(0, dispatch_lag)
        # lagged fetch ring: (_Fetch, [(slot, Request)] whose token in that
        # vector is NEW)
        self._ring: Deque[Any] = collections.deque()
        self._dirty = False     # block tables / active changed since put
        self._needs_sweep = False  # a fetch EOS-finished a request whose
        # slot is still held (count-based completions release inline)
        self._req_counter = 0
        self.reset_stats()

    # ----------------------------------------------------------- gauges etc.

    def reset_stats(self) -> None:
        """Zero the serving gauges (a warm-up window against a timed
        one), the census included."""
        self.ttft = EventStats()
        self.decode_steps = 0
        self.prefill_steps = 0
        self.tokens_fetched = 0
        # cost-ledger occupancy and padding counters: actual vs padded
        # prompt tokens per prefill dispatch, active vs run slot-steps per
        # decode dispatch (the JAX counters)
        self.prompt_tokens_prefilled = 0
        self.prefill_token_slots = 0
        self.slot_steps_active = 0
        self.slot_steps_total = 0
        # speculative gauges: rounds, draft tokens proposed and accepted
        # (every fetched token is target-verified, so tokens_fetched is
        # the accepted-token count)
        self.spec_rounds = 0
        self.draft_proposed = 0
        self.draft_accepted = 0
        if self.census is not None:
            self.census.reset()

    @property
    def compile_time_s(self) -> float:
        """Seconds spent capturing CUDA graphs (0 on eager engines)."""
        return self.engine.compile_time_s + (
            self._draft_engine.compile_time_s
            if self._draft_engine is not None else 0.0)

    @property
    def recompile_count(self) -> int:
        """Graph captures so far, every engine of the server."""
        return self._recompiles.count

    def stop_sanitizer(self) -> int:
        """Fold the captures observed after the first fetched token into
        ``steady_recompile`` violations (once); returns the capture
        count."""
        if self.sanitize and not self._sanitizer_reported:
            self._sanitizer_reported = True
            if self._recompiles_at_first_token is not None:
                self.sanitize_report.note_recompiles(
                    self._recompiles, self._recompiles_at_first_token)
        return self._recompiles.count

    def write_sanitize_report(self, out_dir: str) -> str:
        """Finalize the evidence and write ``sanitize_report.json`` into
        ``out_dir``; "" when sanitize was off or the write failed."""
        if not self.sanitize:
            return ""
        self.stop_sanitizer()
        return self.sanitize_report.write(out_dir)

    def prefix_stats(self) -> dict:
        """Prefix-cache gauges (empty dict when the cache is off)."""
        return self.prefix.stats() if self.prefix is not None else {}

    def cost_ledger(self, *, wall_s: float, n_devices: int = 1) -> dict:
        """Per-phase cost-ledger rows (``obs/ledger.py``), the JAX rows
        with the census in place of XLA's extraction: the DECODE row
        carries the roofline MFU-gap attribution (tokens/s over ``wall_s``
        against the 2N FLOPs/token roofline, slot-occupancy waste as its
        padding term); the other phases carry their census and the
        prompt-padding waste (prefill runs at
        [prefill_batch, max_prompt_len] whatever the prompts' lengths).
        A phase that never ran has no row. Needs ``census=True``."""
        if self.census is None:
            raise RuntimeError("cost_ledger() needs a server built with "
                               "census=True")
        n_params = sum(p.numel() for p in self.model.parameters())
        fpt = transformer_decode_flops_per_token(n_params)
        device_kind = (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu")
        rows: dict = {}
        for name in ("prefill", "decode", "verify"):
            if not self.engine.dispatches.get(name):
                continue
            row = {"program": f"serve_{name}",
                   **self.census.cost(name),
                   "collective_bytes_per_step": 0.0}
            if name == "decode":
                tokens_per_s = (self.tokens_fetched / wall_s
                                if wall_s > 0 else 0.0)
                steps_per_s = (self.decode_steps / wall_s
                               if wall_s > 0 else 0.0)
                occupancy_waste = (
                    1.0 - self.slot_steps_active / self.slot_steps_total
                    if self.slot_steps_total > 0 else 0.0)
                row.update({
                    "flops_per_token": fpt,
                    "n_params": n_params,
                    "tokens_per_s": tokens_per_s,
                    "steps_per_s": steps_per_s,
                    "decode_span": self.engine.decode_span,
                    "kv_pool_bytes": self.engine.kv_pool_bytes(),
                    "kv_quant": self.engine.kv_quant,
                })
                if self.spec_tokens > 0:
                    tf = max(1, self.tokens_fetched)
                    row.update({
                        "spec_tokens": self.spec_tokens,
                        "spec_draft": self.spec_draft,
                        "accept_rate": self.accept_rate,
                        "accepted_tokens_per_s": tokens_per_s,
                        "accepted_tokens_per_s_per_chip":
                            tokens_per_s / max(1, n_devices),
                        "draft_flops_per_token": self._draft_fpt,
                        "spec_flops_per_fetched_token":
                            fpt * self.slot_steps_active / tf
                            + self._draft_fpt * self.draft_proposed / tf,
                    })
                row.update(roofline_attribution(
                    tokens_per_s=tokens_per_s, flops_per_token=fpt,
                    peak_flops=device_peak_flops(device_kind),
                    n_devices=n_devices, steps_per_s=steps_per_s,
                    collective_bytes_per_step=0.0,
                    bytes_accessed=row["bytes_accessed"],
                    device_kind=device_kind,
                    padding_waste_frac=occupancy_waste))
            else:
                row["padding_waste_frac"] = (
                    1.0 - self.prompt_tokens_prefilled
                    / self.prefill_token_slots
                    if self.prefill_token_slots > 0 else 0.0)
            rows[f"serve_{name}"] = row
        return rows

    @property
    def accept_rate(self) -> float:
        """Fraction of proposed draft tokens the target accepted."""
        return (self.draft_accepted / self.draft_proposed
                if self.draft_proposed > 0 else 0.0)

    @property
    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    @property
    def busy(self) -> bool:
        """Anything queued, in flight, or awaiting fetch."""
        return bool(self.queue or any(s is not None for s in self.slots)
                    or self._ring)

    def set_seed(self, seed: int) -> None:
        """Sample from ``seed`` from the next dispatch on (the JAX server's
        ``set_rng``): a reused server gives each batch its own stream, the
        captured graphs included."""
        self.engine.set_seed(seed)

    @torch.no_grad()
    def set_params(self, state_dict) -> None:
        """Hot swap: copy ``state_dict`` (the model's keys, e.g. a loaded
        ``model_NNNNNN.pt``) IN PLACE into the model's tensors. A captured
        graph reads the tensors it was captured with, so the swap never
        replaces a module or a parameter; the model draft shares the
        target's tensors and follows. Every key, shape and dtype is
        checked before anything is written: a mismatch raises
        ``ValueError`` and the old weights stay. Call it on a drained
        server; the prefix cache's idle entries (KV of the old weights)
        are evicted."""
        mine = self.model.state_dict()
        if set(state_dict) != set(mine):
            raise ValueError(
                f"swap state dict keys differ: missing "
                f"{sorted(set(mine) - set(state_dict))[:4]}, unexpected "
                f"{sorted(set(state_dict) - set(mine))[:4]}")
        for key, t in mine.items():
            new = state_dict[key]
            if tuple(new.shape) != tuple(t.shape) or new.dtype != t.dtype:
                raise ValueError(
                    f"swap tensor {key}: {tuple(new.shape)} {new.dtype} "
                    f"does not fit {tuple(t.shape)} {t.dtype}")
        for key, t in mine.items():
            t.copy_(state_dict[key])
        if self.prefix is not None:
            self.prefix.evict_for(self.mgr.num_pages)

    def _check_request(self, prompt: np.ndarray,
                       max_new_tokens: int) -> tuple:
        """(int32 prompt, g_max) of a valid request; raises ValueError."""
        prompt = np.ascontiguousarray(prompt, np.int32).ravel()
        if not 1 <= prompt.shape[0] <= self.engine.max_prompt_len:
            raise ValueError(
                f"prompt length {prompt.shape[0]} outside [1, "
                f"max_prompt_len={self.engine.max_prompt_len}]")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        g_max = min(max_new_tokens,
                    self.engine.max_len - int(prompt.shape[0]))
        if g_max < 1:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens leaves no room to "
                f"generate under max_len={self.engine.max_len}")
        total = prompt.shape[0] + g_max
        if self.mgr.pages_for(total) > self.mgr.capacity:
            raise ValueError(
                f"request needs {self.mgr.pages_for(total)} pages but the "
                f"pool holds {self.mgr.capacity}; raise max_pages or lower "
                f"max_new_tokens")
        return prompt, g_max

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               eos_id: Optional[int] = None) -> Request:
        prompt, g_max = self._check_request(prompt, max_new_tokens)
        self._req_counter += 1
        req = Request(id=self._req_counter, prompt=prompt,
                      max_new_tokens=max_new_tokens, g_max=g_max,
                      eos_id=self.default_eos_id if eos_id is None else eos_id,
                      submit_t=time.perf_counter())
        self.queue.append(req)
        return req

    def submit_prefilled(self, prompt: np.ndarray, max_new_tokens: int, *,
                         first_token: int, kv_pages: dict,
                         eos_id: Optional[int] = None,
                         submit_t: Optional[float] = None
                         ) -> Optional[Request]:
        """Admit a request whose prefill ran on ANOTHER engine (the
        disaggregated serving path, ``mpmd/disagg.py``): ``kv_pages`` is a
        ``DecodeEngine.extract_pages`` payload covering the prompt's
        ``pages_for(prompt_len)`` pages, ``first_token`` the token the
        prefill worker picked at ``position = prompt_len``.

        Unlike :meth:`submit` this admits IMMEDIATELY (no queue): the
        payload is only valid against the page ids allocated here, so
        returning None (no free slot / pool exhausted) pushes the
        backpressure onto the caller's StageLink instead. Pages come
        straight from the PageManager, never the prefix cache (the
        transferred pages hold state the local prefill never wrote)."""
        prompt, g_max = self._check_request(prompt, max_new_tokens)
        n_filled = self.mgr.pages_for(prompt.shape[0])
        got = {k: np.shape(v)[0] for k, v in kv_pages.items()}
        if any(n != n_filled for n in got.values()):
            raise ValueError(f"kv_pages rows {got} != pages_for(prompt_len)"
                             f"={n_filled}")
        free = [s for s in range(len(self.slots)) if self.slots[s] is None]
        if not free:
            return None
        pages = self.mgr.alloc(self.mgr.pages_for(prompt.shape[0] + g_max))
        if pages is None:
            return None
        try:
            self.engine.ingest_pages(pages[:n_filled], kv_pages)
        except ValueError:
            self.mgr.free(pages)
            raise
        slot = free[0]
        self._req_counter += 1
        req = Request(id=self._req_counter, prompt=prompt,
                      max_new_tokens=max_new_tokens, g_max=g_max,
                      eos_id=self.default_eos_id if eos_id is None else eos_id,
                      submit_t=(time.perf_counter() if submit_t is None
                                else submit_t))
        self.engine.set_slot_state(slot, first_token, req.prompt_len)
        self.block_tables[slot, :] = TRASH_PAGE
        self.block_tables[slot, :len(pages)] = pages
        self.active[slot] = 1
        self.slots[slot] = _SlotState(req=req, pages=pages,
                                      position=req.prompt_len)
        self._dirty = True
        # the transferred first token is this request's first FETCHED
        # token too (there is no local prefill dispatch to ride here)
        req.tokens.append(int(first_token))
        self.tokens_fetched += 1
        req.ttft_s = max(0.0, time.perf_counter() - req.submit_t)
        self.ttft.add(req.ttft_s)
        if req.eos_id is not None and int(first_token) == req.eos_id:
            req.finished = True
        elif len(req.tokens) >= req.g_max:
            req.finished = True
        if req.finished or req.g_max <= 1:
            self._release(slot)
        return req

    def _release(self, slot: int) -> None:
        st = self.slots[slot]
        if st is None:
            return
        if self.prefix is not None:
            # shared prefix pages stay cache-resident for the next sharer;
            # only the slot's private tail frees now
            to_free = self.prefix.release(st.req.prompt, st.pages)
            if to_free.size:
                self.mgr.free(to_free)
        else:
            self.mgr.free(st.pages)
        self.block_tables[slot, :] = TRASH_PAGE
        self.active[slot] = 0
        self.slots[slot] = None
        self._dirty = True

    def _reserve_pages(self, req: Request) -> Optional[tuple]:
        """All-or-nothing worst-case page reservation for one admission:
        ``(pages, n_shared)`` or None. With the prefix cache on, the cached
        full-page prompt prefix is slot-ref'd (not re-allocated) and only
        the remainder comes from the pool, evicting idle cache entries
        under pressure before giving up (the JAX method)."""
        n_total = self.mgr.pages_for(req.prompt_len + req.g_max)
        if self.prefix is None:
            pages = self.mgr.alloc(n_total)
            return None if pages is None else (pages, 0)
        shared, covered = self.prefix.acquire(req.prompt)
        need = n_total - len(shared)
        fresh = (self.mgr.alloc(need) if need > 0
                 else np.zeros((0,), np.int32))
        if fresh is None:
            self.prefix.evict_for(need)
            fresh = self.mgr.alloc(need)
        if fresh is None:
            if shared:
                # roll the acquire back; if evict_for dropped the shared
                # pages' entries, ours were the last refs: free the orphans
                back = self.prefix.release(req.prompt[:covered],
                                           np.asarray(shared, np.int32))
                if back.size:
                    self.mgr.free(back)
            return None
        pages = np.concatenate(
            [np.asarray(shared, np.int32), fresh]) if shared else fresh
        self.prefix.publish(req.prompt, pages, n_acquired=len(shared))
        return pages, len(shared)

    def _admit(self) -> bool:
        """Admit queued requests into free slots, up to one prefill batch.
        All-or-nothing worst-case page reservation per request (prompt +
        budget), head-of-line: a request that doesn't fit WAITS — it never
        preempts pages or slots from in-flight requests."""
        if not self.queue:
            return False
        free = [s for s in range(len(self.slots)) if self.slots[s] is None]
        batch: List[tuple] = []
        while (self.queue and free
               and len(batch) < self.engine.prefill_batch):
            req = self.queue[0]
            got = self._reserve_pages(req)
            if got is None:
                break  # pool exhausted: wait for completions to free pages
            pages, n_shared = got
            slot = free.pop(0)
            self.queue.popleft()
            self.block_tables[slot, :] = TRASH_PAGE
            self.block_tables[slot, :len(pages)] = pages
            self.active[slot] = 1
            self.slots[slot] = _SlotState(req=req, pages=pages,
                                          n_shared=n_shared,
                                          position=req.prompt_len)
            self._dirty = True
            batch.append((slot, req))
        if not batch:
            return False
        bp, lp = self.engine.prefill_batch, self.engine.max_prompt_len
        ids = np.zeros((bp, lp), np.int32)
        lens = np.zeros((bp,), np.int32)
        smap = np.full((bp,), -1, np.int32)
        stables = np.zeros((bp, self.engine.pages_per_slot), np.int32)
        for i, (slot, req) in enumerate(batch):
            ids[i, :req.prompt_len] = req.prompt
            lens[i] = req.prompt_len
            smap[i] = slot
            stables[i] = self.block_tables[slot]
            # pages acquired from the prefix cache keep their publisher's
            # values: this prefill's writes to them go to the trash page
            stables[i, :self.slots[slot].n_shared] = TRASH_PAGE
        toks = self.engine.prefill(ids, lens, smap, stables)
        if self._draft_engine is not None:
            # mirror the admission into the draft pool (its own static
            # tables); the draft's first pick is never read: every round
            # pushes the host's state first
            dstables = np.zeros_like(stables)
            for i, (slot, _) in enumerate(batch):
                dstables[i] = self._draft_tables[slot]
            self._draft_engine.prefill(ids, lens, smap, dstables)
        self.prefill_steps += 1
        # padding accounting: actual prompt tokens vs the padded
        # [prefill_batch, max_prompt_len] shape the phase ran at
        self.prompt_tokens_prefilled += int(lens.sum())
        self.prefill_token_slots += bp * lp
        if self.census is not None:
            self.census.prefill(bp, lp)
        self._ring.append((_Fetch(toks), list(batch)))
        # a budget-1 request is already complete at dispatch level
        for slot, _ in batch:
            st = self.slots[slot]
            if st is not None and st.generated >= st.req.g_max:
                self._release(slot)
        return True

    def _sweep(self) -> None:
        """Release the slots of requests an EOS finished at fetch."""
        if self._needs_sweep:
            for slot, st in enumerate(self.slots):
                if st is not None and st.req.finished:
                    self._release(slot)
            self._needs_sweep = False

    def _note_first_token(self) -> None:
        # serving steady-state boundary: every capture so far was warm-up;
        # growth past this snapshot is a violation
        if self.sanitize and self._recompiles_at_first_token is None \
                and self.tokens_fetched > 0:
            self._recompiles_at_first_token = self._recompiles.count

    def _positions_now(self) -> np.ndarray:
        """[S] each active slot's position (inactive: 0), for the census."""
        pos = np.zeros((len(self.slots),), np.int64)
        for s, st in enumerate(self.slots):
            if st is not None and self.active[s]:
                pos[s] = st.position
        return pos

    def step(self) -> bool:
        """One scheduler tick: sweep EOS completions -> admit -> dispatch
        decode (or a speculative round) -> lagged fetch. Returns False when
        nothing advanced. Under sanitize a guard trip's evidence is
        recorded on its way out."""
        with (self.sanitize_report.watch() if self.sanitize
              else contextlib.nullcontext()):
            return self._step_inner()

    def _step_inner(self) -> bool:
        self._sweep()
        # admit until the queue, the free slots, or the page pool runs out
        dispatched = False
        while self._admit():
            dispatched = True
        if self.spec_tokens > 0:
            # synchronous rounds: the round needs every slot's current token
            # on the host, so the prefill ring drains first
            self._fetch(0)
            self._sweep()
            if self.active.any():
                self._spec_round()
                dispatched = True
            self._note_first_token()
            return dispatched
        if self.active.any():
            if self._dirty:
                self.engine.set_block_tables(self.block_tables)
                self.engine.set_active(self.active)
                self._dirty = False
            snap = [(s, st.req) for s, st in enumerate(self.slots)
                    if st is not None and self.active[s]]
            span = self.engine.decode_span
            if self.census is not None:
                self.census.decode(self.block_tables, self._positions_now(),
                                   span)
            toks = self.engine.decode()
            self.decode_steps += 1
            # occupancy accounting: active vs run slot-steps (inactive
            # slots run anyway, writing to trash)
            self.slot_steps_active += int(self.active.sum()) * span
            self.slot_steps_total += len(self.slots) * span
            self._ring.append((_Fetch(toks), snap))
            for s, _ in snap:
                st = self.slots[s]
                # mirrors advance by the full span (the device does, while
                # the slot is active); a budget hit mid-span overshoots
                # harmlessly — see DecodeEngine
                st.generated += span
                st.position += span
                if st.generated >= st.req.g_max:  # budget spent:
                    self._release(s)          # completion, no fetch needed
            dispatched = True
        # lagged on busy ticks (the overlap); full drain on idle ticks
        self._fetch(self.dispatch_lag if dispatched else 0)
        self._note_first_token()
        return dispatched or bool(self._ring)

    def _spec_round(self) -> None:
        """One speculative round: propose K -> verify in one forward ->
        walk acceptance -> advance the host mirrors by what was kept.
        Pages were reserved worst-case at admission, and rejected links
        only wrote rows past the live position in those pages (or the
        trash page), masked until overwritten, so nothing leaks."""
        if self._dirty:
            self.engine.set_block_tables(self.block_tables)
            self.engine.set_active(self.active)
            if self._draft_engine is not None:
                self._draft_engine.set_active(self.active)
            self._dirty = False
        S, K = len(self.slots), self.spec_tokens
        cur_tok = np.zeros((S,), np.int32)
        cur_pos = np.zeros((S,), np.int32)
        snap = []
        for s, st in enumerate(self.slots):
            if st is None or not self.active[s]:
                continue
            cur_tok[s] = st.req.tokens[-1]   # the last fetched token
            cur_pos[s] = st.position
            snap.append((s, st))
        draft = np.zeros((K, S), np.int32)
        if self._draft_engine is not None:
            # K greedy draft steps, each feeding the draft's own pick: the
            # chain the target verifies
            self._draft_engine.set_decode_state(cur_tok, cur_pos)
            steps = [self._draft_engine.decode() for _ in range(K)]
            draft[:] = torch.stack(steps).cpu().numpy()
        else:
            for s, st in snap:
                hist = np.concatenate(
                    [st.req.prompt, np.asarray(st.req.tokens, np.int32)])
                draft[:, s] = ngram_propose(hist, K)
        if self.census is not None:
            self.census.verify(self.block_tables, cur_pos.astype(np.int64),
                               K + 1)
        seq = self.engine.verify(draft, cur_tok, cur_pos).cpu().numpy()
        self.decode_steps += 1
        self.spec_rounds += 1
        self.slot_steps_active += len(snap) * (K + 1)
        self.slot_steps_total += S * (K + 1)
        for s, st in snap:
            req = st.req
            kept = matched = 0
            for j in range(K + 1):
                tok = int(seq[j, s])
                # row j is valid while every earlier draft link matched;
                # the walk never reaches an invalid row
                req.tokens.append(tok)
                self.tokens_fetched += 1
                kept += 1
                if req.eos_id is not None and tok == req.eos_id:
                    req.finished = True     # EOS inside an accepted prefix
                elif len(req.tokens) >= req.g_max:
                    req.finished = True
                if req.finished:
                    break
                if j < K and int(draft[j, s]) == tok:
                    matched += 1
                    continue
                break                        # first mismatch: reject the rest
            st.generated += kept
            st.position += kept
            self.draft_proposed += K
            self.draft_accepted += matched
            if req.finished:
                self._release(s)

    def _fetch(self, lag: int) -> None:
        """Drain the fetch ring down to ``lag`` entries, attributing each
        fetched token vector to its snapshot's requests."""
        while len(self._ring) > lag:
            fetch, snap = self._ring.popleft()
            arr = fetch.wait()
            rows = arr if arr.ndim == 2 else arr[None]  # [span|1, S]
            now = time.perf_counter()
            for slot, req in snap:
                if req.finished:
                    continue
                for row in rows:
                    tok = int(row[slot])
                    req.tokens.append(tok)
                    self.tokens_fetched += 1
                    if req.ttft_s is None:
                        req.ttft_s = now - req.submit_t
                        self.ttft.add(req.ttft_s)
                    if req.eos_id is not None and tok == req.eos_id:
                        req.finished = True
                        self._needs_sweep = True  # slot may still be held
                    elif len(req.tokens) >= req.g_max:
                        req.finished = True  # overshoot rows are discarded
                    if req.finished:
                        break

    def drain(self) -> None:
        """Run until every submitted request has completed and every token
        has been fetched."""
        while self.busy:
            if not self.step():
                break
        self._fetch(0)


def one_shot_decode(model: GPT2Model, ids: np.ndarray, prompt_len: int, *,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0, seed: Optional[int] = None,
                    page_size: int = 0,
                    server: Optional[DecodeServer] = None,
                    device=None) -> np.ndarray:
    """Batch continuation through the serving path: the prefill and decode
    phases that serve traffic, driven as one lockstep batch (one code path
    for one-shot decoding in ``run.sample`` and for served decoding).

    ``ids`` int [B, L]: positions < ``prompt_len`` are the prompts, the
    suffix is regenerated out to L (int32 host array out). Greedy output
    is :func:`models.sampling.gpt2_decode`'s, token for token up to
    near-ties (tested); sampling keys each pick per (slot, position) and
    row i takes slot i, so it draws what ``gpt2_decode`` draws for row i
    at the same seed. Pass ``server`` to reuse one across calls (its state
    recycles between drained batches and its CUDA graphs are kept; a
    given ``seed`` is set on it first); by default one is built on
    ``device`` as the JAX function builds it, prompts padded to L (the
    prefill runs at ``gpt2_decode``'s prefill length) and one prefill for
    the batch, but with pages of ``min(L, 64)`` tokens, ``run.sample``'s
    size, where JAX takes one page of L a slot: the decode kernel holds
    two stages of a page per head in shared memory, which a 1024-token
    page overflows."""
    ids = np.ascontiguousarray(ids, np.int32)
    b, l = ids.shape
    if not 1 <= prompt_len < l:
        if prompt_len == l:
            return ids.copy()
        raise ValueError(f"prompt_len {prompt_len} outside [1, {l}]")
    if server is None:
        server = DecodeServer(
            model, decode_slots=b, page_size=page_size or min(l, 64),
            max_prompt_len=l, max_len=l, prefill_batch=b,
            temperature=temperature, top_k=top_k, top_p=top_p,
            seed=seed or 0, device=device)
    elif seed is not None:
        server.set_seed(seed)
    reqs = [server.submit(ids[i, :prompt_len], max_new_tokens=l - prompt_len)
            for i in range(b)]
    server.drain()
    out = ids.copy()
    for i, req in enumerate(reqs):
        gen = np.asarray(req.tokens, np.int32)
        out[i, prompt_len:prompt_len + len(gen)] = gen
    return out
