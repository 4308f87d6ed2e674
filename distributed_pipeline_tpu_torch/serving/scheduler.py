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
``dispatch_lag`` does not apply. The prefix cache, the sanitizer and the
cost ledger are ROADMAP A.4.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, List, Optional

import numpy as np
import torch

from ..models.gpt2 import GPT2Model
from ..utils.perf import EventStats
from .engine import DecodeEngine
from .paged_kv import TRASH_PAGE, PageManager
from .spec import DRAFT_KINDS, ngram_propose, truncated_draft

__all__ = ["Request", "DecodeServer"]


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
    and where the engine keeps its state (the model is moved there)."""

    def __init__(self, model: GPT2Model, *, decode_slots: int = 8,
                 page_size: int = 16, max_pages: int = 0,
                 max_prompt_len: int = 0, max_len: int = 0,
                 prefill_batch: int = 0, decode_span: int = 1,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None, dispatch_lag: int = 1,
                 decode_impl: str = "auto", kv_quant: str = "fp",
                 spec_tokens: int = 0, spec_draft: str = "ngram",
                 draft_layers: int = 2, device=None) -> None:
        from ..utils.device import resolve_device
        if spec_tokens > 0 and spec_draft not in DRAFT_KINDS:
            raise ValueError(f"spec_draft must be one of {DRAFT_KINDS}, "
                             f"got {spec_draft!r}")
        self.spec_tokens = spec_tokens
        self.device = resolve_device(device)
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
            kv_quant=kv_quant, spec_tokens=spec_tokens)
        self._draft_engine: Optional[DecodeEngine] = None
        if spec_tokens > 0 and spec_draft == "model":
            # Early-exit draft over the target's first draft_layers blocks,
            # on a static full-residency pool: slot s owns pages
            # [1 + s*pps, 1 + (s+1)*pps) for good, so the draft needs no
            # allocator, and rollback is the host's state push each round
            # (accepted draft K/V is valid by the acceptance rule)
            pps = self.engine.pages_per_slot
            self._draft_engine = DecodeEngine(
                truncated_draft(model, draft_layers),
                decode_slots=decode_slots, page_size=page_size,
                max_pages=1 + decode_slots * pps,
                max_prompt_len=max_prompt_len, max_len=max_len,
                prefill_batch=prefill_batch, decode_span=1, seed=seed,
                decode_impl=decode_impl, kv_quant=kv_quant)
            self._draft_tables = np.arange(
                1, 1 + decode_slots * pps,
                dtype=np.int32).reshape(decode_slots, pps)
            self._draft_engine.set_block_tables(self._draft_tables)
        self.mgr = PageManager(max_pages, page_size)
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
        self.ttft = EventStats()
        self.decode_steps = 0
        self.prefill_steps = 0
        self.tokens_fetched = 0
        # speculative gauges: rounds, draft tokens proposed and accepted
        # (every fetched token is target-verified, so tokens_fetched is
        # the accepted-token count)
        self.spec_rounds = 0
        self.draft_proposed = 0
        self.draft_accepted = 0

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

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               eos_id: Optional[int] = None) -> Request:
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
        self._req_counter += 1
        req = Request(id=self._req_counter, prompt=prompt,
                      max_new_tokens=max_new_tokens, g_max=g_max,
                      eos_id=self.default_eos_id if eos_id is None else eos_id,
                      submit_t=time.perf_counter())
        self.queue.append(req)
        return req

    def _release(self, slot: int) -> None:
        st = self.slots[slot]
        if st is None:
            return
        self.mgr.free(st.pages)
        self.block_tables[slot, :] = TRASH_PAGE
        self.active[slot] = 0
        self.slots[slot] = None
        self._dirty = True

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
            pages = self.mgr.alloc(
                self.mgr.pages_for(req.prompt_len + req.g_max))
            if pages is None:
                break  # pool exhausted: wait for completions to free pages
            slot = free.pop(0)
            self.queue.popleft()
            self.block_tables[slot, :] = TRASH_PAGE
            self.block_tables[slot, :len(pages)] = pages
            self.active[slot] = 1
            self.slots[slot] = _SlotState(req=req, pages=pages,
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

    def step(self) -> bool:
        """One scheduler tick: sweep EOS completions -> admit -> dispatch
        decode (or a speculative round) -> lagged fetch. Returns False when
        nothing advanced."""
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
            return dispatched
        if self.active.any():
            if self._dirty:
                self.engine.set_block_tables(self.block_tables)
                self.engine.set_active(self.active)
                self._dirty = False
            snap = [(s, st.req) for s, st in enumerate(self.slots)
                    if st is not None and self.active[s]]
            toks = self.engine.decode()
            span = self.engine.decode_span
            self.decode_steps += 1
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
        seq = self.engine.verify(draft, cur_tok, cur_pos).cpu().numpy()
        self.decode_steps += 1
        self.spec_rounds += 1
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
