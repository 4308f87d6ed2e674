"""Request router: health-gated, load-aware placement with durable replay.

The router is the fleet's only admission point. Every request's lifecycle
is journaled (append-only JSONL — the durable half of the "no admitted
request is ever lost" contract) and placed on the healthiest,
least-loaded replica:

* PLACEMENT — among replicas that are ready (ready.json epoch current),
  supervised (the launcher thread is alive), beaconing (newest beacon
  mtime younger than ``stale_beacon_s``), not draining (hot-swap), and
  not permanently down, pick the one with the fewest outstanding
  requests. A wedged replica stops beaconing and loses NEW placements
  within one staleness window — health-gating is faster than the hang
  watchdog that eventually kills it.
* REPLAY — a replica death/restart is observed as an attempt bump in its
  ``ready.json`` (or the supervisor thread dying). Completions are
  consumed FIRST (a request that finished just before the kill is never
  re-run), then every request assigned to the dead epoch goes back to
  the pending queue and is placed on a sibling. Greedy decoding makes
  the replayed result token-identical (same params, same prompt);
  stochastic sampling re-samples — documented, not hidden. The journal's
  ``replay`` events carry the wasted window (assign -> detection), which
  ``chaos.goodput.aggregate_serving`` books as the ``replay`` category.
* RECOVERY — :meth:`Router.recover` rebuilds pending/done state from the
  journal alone, so even a router restart (the supervisor process dying)
  loses no admitted request.
* AFFINITY (opt-in) — with ``affinity=True`` the router hashes each
  prompt's page-aligned prefix blocks at submit and, among HEALTHY
  candidates, prefers the replica whose advertised prefix-cache index
  (``prefix_index`` riding beacons/heartbeats) matches the most leading
  blocks — multiplying per-replica prefix caches into a fleet-wide
  cache. Ties and cold prefixes fall back to least-loaded, and affinity
  NEVER overrides the health gate, so replay semantics are unchanged: a
  replayed request simply re-scores against the surviving replicas (its
  cached prefix died with the replica — the replay is correct, just
  cold).

Import-light (numpy + stdlib): runs in the torch-free fleet process. The
replica transport is duck-typed (``transport.ReplicaClient`` or any
object with ``alive/ready/beacon_age_s/submit/consume_results``), so
tests drive the router with in-memory fakes. ``submit`` on a client may
raise (a socket transport mid-outage): the placement is reverted and the
request stays pending — nothing is stranded on an unreachable wire.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..obs.trace import request_trace_id
from .transport import prefix_block_hashes

__all__ = ["RoutedRequest", "Router"]


@dataclasses.dataclass
class RoutedRequest:
    """One admitted request and its routing lifecycle."""

    id: int
    prompt: np.ndarray
    max_new_tokens: int
    submit_t: float                     # wall clock (rides to the worker:
    #                                     TTFT includes queue + replay time)
    trace_id: str = ""                  # cross-process trace identity: ONE
    #                                     id per request, derived from the
    #                                     request id (explicit, never wall-
    #                                     clock), riding every journal
    #                                     event and inbox payload so the
    #                                     worker's spans and the router's
    #                                     journal stitch into one timeline
    state: str = "pending"              # pending | assigned | done
    replica: Optional[int] = None
    epoch: Optional[int] = None         # replica attempt at assignment
    assign_t: float = 0.0
    replays: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    params_step: Optional[int] = None
    done_t: float = 0.0
    prefix: Tuple[int, ...] = ()        # page-aligned prefix block hashes
    #                                     (empty unless affinity routing)


class Router:
    """Health-gated, least-loaded placement over a set of replica clients
    (see module docstring). Drive with :meth:`poll` from the fleet loop;
    ``submit`` only enqueues + journals."""

    def __init__(self, clients: Dict[int, object], journal_path: str, *,
                 stale_beacon_s: float = 10.0,
                 affinity: bool = False, page_size: int = 16) -> None:
        self.clients = dict(clients)
        self.journal_path = journal_path
        self.stale_beacon_s = stale_beacon_s
        self.affinity = bool(affinity)
        self.page_size = int(page_size)
        self.records: Dict[int, RoutedRequest] = {}
        self.queue: Deque[int] = collections.deque()
        self._epochs: Dict[int, Optional[int]] = {
            rid: None for rid in self.clients}
        self._draining: set = set()
        self._down: set = set()
        self._req_counter = 0
        self.replayed = 0
        self.duplicate_results = 0
        self.affinity_hits = 0        # placements won by a warm prefix
        self.affinity_placements = 0  # placements scored (affinity on,
        #                               request had >= 1 full block)

    # -------------------------------------------------------------- journal

    def _journal(self, event: dict) -> None:
        try:
            with open(self.journal_path, "a") as f:
                f.write(json.dumps(event) + "\n")
        except OSError:
            pass  # the in-memory state still routes; durability degrades

    # --------------------------------------------------------------- submit

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               submit_t: Optional[float] = None) -> RoutedRequest:
        prompt = np.ascontiguousarray(prompt, np.int32).ravel()
        self._req_counter += 1
        rec = RoutedRequest(
            id=self._req_counter, prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            submit_t=float(submit_t if submit_t is not None
                           else time.time()),
            trace_id=request_trace_id(self._req_counter),
            prefix=(prefix_block_hashes(prompt, self.page_size)
                    if self.affinity else ()))
        self.records[rec.id] = rec
        self.queue.append(rec.id)
        # the full prompt rides the journal: recovery must be able to
        # re-place the request without any other artifact surviving
        self._journal({"ev": "submit", "id": rec.id, "t": rec.submit_t,
                       "trace": rec.trace_id,
                       "prompt": prompt.tolist(),
                       "max_new_tokens": rec.max_new_tokens})
        return rec

    # -------------------------------------------------------- elastic fleet

    def add_client(self, rid: int, client: object) -> None:
        """Scale-up: admit a new replica into placement. It takes no
        traffic until its ready.json lands (the normal health gate)."""
        self.clients[rid] = client
        self._epochs.setdefault(rid, None)
        self._down.discard(rid)
        self._draining.discard(rid)

    def retire(self, rid: int) -> None:
        """Scale-down terminal state: the replica was DRAINED first (set
        ``set_draining`` and wait for ``outstanding == 0``), so unlike a
        death there is nothing to replay — mark it permanently down so
        neither placement nor the down-detection path touches it again."""
        self._draining.discard(rid)
        self._down.add(rid)

    # --------------------------------------------------------------- health

    def set_draining(self, rid: int, draining: bool = True) -> None:
        if draining:
            self._draining.add(rid)
        else:
            self._draining.discard(rid)

    def draining(self, rid: int) -> bool:
        return rid in self._draining

    def down(self, rid: int) -> bool:
        return rid in self._down

    def replica_epoch(self, rid: int) -> Optional[int]:
        return self._epochs.get(rid)

    def healthy(self, rid: int, now: Optional[float] = None) -> bool:
        """Placement gate — NOT the replay trigger (replay keys on epoch
        bumps/death so a briefly-stale replica never gets its in-flight
        work double-served)."""
        if rid in self._down or rid in self._draining:
            return False
        client = self.clients[rid]
        if not client.alive():
            return False
        ready = client.ready()
        if ready is None or ready.get("attempt") != self._epochs.get(rid):
            return False
        age = client.beacon_age_s(now)
        return age is None or age <= self.stale_beacon_s

    def outstanding(self, rid: int) -> int:
        return sum(1 for r in self.records.values()
                   if r.state == "assigned" and r.replica == rid)

    # ----------------------------------------------------------------- poll

    def _consume(self, rid: int) -> None:
        client = self.clients[rid]
        now = time.time()
        for payload in client.consume_results():
            rec = self.records.get(int(payload.get("id", -1)))
            if rec is None or rec.state == "done":
                self.duplicate_results += 1  # replayed twin landed late
                continue
            rec.state = "done"
            rec.tokens = [int(t) for t in payload.get("tokens", [])]
            ttft = payload.get("ttft_s")
            rec.ttft_s = float(ttft) if ttft is not None else None
            ps = payload.get("params_step")
            rec.params_step = int(ps) if ps is not None else None
            rec.done_t = now
            self._journal({"ev": "complete", "id": rec.id, "replica": rid,
                           "t": now, "trace": rec.trace_id,
                           "n_tokens": len(rec.tokens),
                           "ttft_s": rec.ttft_s,
                           "params_step": rec.params_step})

    def _requeue_assigned(self, rid: int, reason: str) -> None:
        now = time.time()
        for rec in self.records.values():
            if rec.state == "assigned" and rec.replica == rid:
                wasted = max(0.0, now - rec.assign_t)
                rec.state = "pending"
                rec.replica = None
                rec.epoch = None
                rec.replays += 1
                self.replayed += 1
                self.queue.append(rec.id)
                self._journal({"ev": "replay", "id": rec.id, "from": rid,
                               "trace": rec.trace_id,
                               "reason": reason, "t": now,
                               "wasted_s": round(wasted, 6)})

    def poll(self, now: Optional[float] = None) -> None:
        """One routing round: observe replica epochs (consume-then-replay
        on any bump or death), collect completions, place pending work."""
        now = time.time() if now is None else now
        for rid, client in self.clients.items():
            if rid in self._down:
                continue
            ready = client.ready()
            epoch = ready.get("attempt") if ready else None
            if epoch is not None and epoch != self._epochs.get(rid):
                # restart observed: completions win, survivors replay
                self._consume(rid)
                self._requeue_assigned(rid, reason=f"epoch->{epoch}")
                self._epochs[rid] = epoch
            if not client.alive():
                # supervisor gone: no more restarts are coming — the
                # replica is permanently down, strand nothing on it
                self._consume(rid)
                self._requeue_assigned(rid, reason="supervisor-exit")
                self._down.add(rid)
                self._journal({"ev": "replica_down", "replica": rid,
                               "t": now})
        for rid in self.clients:
            if rid not in self._down:
                self._consume(rid)
        # placement: affinity-scored (if enabled), else least-loaded,
        # healthy replica per pending request
        while self.queue:
            candidates = [rid for rid in self.clients
                          if self.healthy(rid, now)]
            if not candidates:
                break
            rec = self.records[self.queue.popleft()]
            if rec.state != "pending":
                continue  # stale queue entry (already replayed + done)
            score = 0
            if self.affinity and rec.prefix:
                scores = {r: self._affinity_score(r, rec.prefix)
                          for r in candidates}
                score = max(scores.values())
                self.affinity_placements += 1
                if score > 0:
                    self.affinity_hits += 1
                    candidates = [r for r in candidates
                                  if scores[r] == score]
            rid = min(candidates, key=lambda r: (self.outstanding(r), r))
            rec.state = "assigned"
            rec.replica = rid
            rec.epoch = self._epochs[rid]
            rec.assign_t = now
            try:
                self.clients[rid].submit({
                    "id": rec.id, "prompt": rec.prompt.tolist(),
                    "max_new_tokens": rec.max_new_tokens,
                    "submit_t": rec.submit_t, "replays": rec.replays,
                    "trace": rec.trace_id})
            except (OSError, ConnectionError):
                # data-plane outage (socket mid-fault): nothing reached
                # the replica, so revert — the request stays pending and
                # the replica's growing heartbeat age will gate it out
                rec.state = "pending"
                rec.replica = None
                rec.epoch = None
                self.queue.appendleft(rec.id)
                break
            self._journal({"ev": "assign", "id": rec.id, "replica": rid,
                           "epoch": rec.epoch, "trace": rec.trace_id,
                           "t": now, "affinity": score})

    def _affinity_score(self, rid: int, prefix: tuple) -> int:
        """Number of the request's LEADING prefix blocks the replica
        advertises — the count of cache pages a hit would skip. Clients
        without an index (old transports, in-memory fakes) score 0 and
        simply fall back to least-loaded."""
        index = getattr(self.clients[rid], "prefix_index", None)
        if index is None:
            return 0
        try:
            advertised = set(index() or ())
        except (OSError, ConnectionError):
            return 0
        score = 0
        for h in prefix:
            if h not in advertised:
                break
            score += 1
        return score

    # ---------------------------------------------------------------- stats

    @property
    def submitted(self) -> int:
        return len(self.records)

    @property
    def completed(self) -> int:
        return sum(1 for r in self.records.values() if r.state == "done")

    @property
    def in_flight(self) -> int:
        return sum(1 for r in self.records.values() if r.state != "done")

    @property
    def backlog(self) -> int:
        """Pending requests not yet placed anywhere (the autoscaler's
        pressure signal)."""
        return sum(1 for r in self.records.values()
                   if r.state == "pending")

    def all_done(self) -> bool:
        return self.in_flight == 0

    def ttfts(self) -> List[float]:
        return [r.ttft_s for r in self.records.values()
                if r.state == "done" and r.ttft_s is not None]

    def recent_ttfts(self, window_s: float,
                     now: Optional[float] = None) -> List[float]:
        """TTFTs of requests completed within the trailing window — the
        autoscaler's live SLO signal (completions only: a request still
        queued shows up as backlog, not as a fake-good TTFT)."""
        now = time.time() if now is None else now
        return [r.ttft_s for r in self.records.values()
                if r.state == "done" and r.ttft_s is not None
                and now - r.done_t <= window_s]

    # ------------------------------------------------------------- recovery

    @classmethod
    def recover(cls, clients: Dict[int, object], journal_path: str, *,
                stale_beacon_s: float = 10.0) -> "Router":
        """Rebuild router state from the journal alone (a router-process
        restart): completed requests stay completed; everything else —
        pending or assigned at the time of death — returns to the pending
        queue and will be (re)placed on the next poll. Token contents are
        not journaled (results live in the outbox files until consumed),
        so recovered completions carry counts, not tokens."""
        from ..chaos.goodput import read_journal

        router = cls(clients, journal_path, stale_beacon_s=stale_beacon_s)
        for ev in read_journal(journal_path):
            kind = ev.get("ev")
            if kind == "submit":
                rec = RoutedRequest(
                    id=int(ev["id"]),
                    prompt=np.asarray(ev.get("prompt", []), np.int32),
                    max_new_tokens=int(ev.get("max_new_tokens", 1)),
                    submit_t=float(ev.get("t", 0.0)),
                    # pre-trace journals lack the field: re-derive the
                    # same id the writer would have minted
                    trace_id=str(ev.get("trace")
                                 or request_trace_id(int(ev["id"]))))
                router.records[rec.id] = rec
                router._req_counter = max(router._req_counter, rec.id)
            elif kind == "replay":
                rec = router.records.get(int(ev.get("id", -1)))
                if rec is not None:
                    rec.replays += 1
            elif kind == "complete":
                rec = router.records.get(int(ev.get("id", -1)))
                if rec is not None:
                    rec.state = "done"
                    ttft = ev.get("ttft_s")
                    rec.ttft_s = (float(ttft) if ttft is not None
                                  else None)
                    rec.done_t = float(ev.get("t", 0.0))
        for rec in router.records.values():
            if rec.state != "done":
                rec.state = "pending"
                rec.replica = None
                router.queue.append(rec.id)
        return router
