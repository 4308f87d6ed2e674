"""Span tracing: per-process append-only JSONL trace shards.

Event model (one JSON object per line, compact keys)::

    {"ph": "X", "name": "step", "cat": "train", "t": <epoch s>,
     "dur": <seconds>, "sid": "rank0:17", "parent": "rank0:16",
     "trace": "req00000003", "args": {...}}
    {"ph": "i", "name": "watchdog_kill", "cat": "attempt", "t": ..., ...}

* ``sid`` (span id) and ``trace`` (cross-process trace id) are EXPLICIT:
  a process label plus a monotonic counter, or a caller-minted request
  id — never derived from the wall clock, so two spans can never
  collide because two events landed in the same microsecond and a
  replayed request keeps ONE identity across processes. Timestamps (not
  identity) are wall-clock on purpose: they are what lets shards from
  different processes stitch into one timeline.
* Writes are single-line atomic appends (one buffered ``write`` +
  ``flush`` per event). A SIGKILL mid-write leaves at most one torn
  tail line, which :func:`read_trace` — the one-owner JSONL reader
  contract shared with ``chaos.goodput.read_journal`` — skips.
* The OFF path is free: :data:`NULL` is a singleton whose ``span()``
  returns a shared no-op context manager and whose ``complete``/
  ``instant`` are pass statements; hot paths guard the (tiny) argument
  construction behind ``tracer.enabled``, so a disabled trace allocates
  no span objects and takes no clock readings.

Import-light (stdlib + the chaos JSONL reader only): the launcher,
router and autoscaler trace without a torch import.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Union

from ..chaos.goodput import read_journal as read_trace  # one-owner reader

__all__ = ["TRACE_ENV", "NULL", "NullTracer", "Stopwatch", "Tracer",
           "enabled_by_env", "read_trace", "request_trace_id",
           "trace_path", "tracer_for"]

# Arming env var: rides the launcher's worker environment (dict(os.environ)
# at spawn), so exporting it on the supervisor traces every worker of
# every restart attempt — including --config_json rings that reject
# individual CLI flags (the DPT_PREFETCH_DEPTH channel).
TRACE_ENV = "DPT_TRACE"


def enabled_by_env() -> bool:
    return os.environ.get(TRACE_ENV, "") not in ("", "0")


def trace_path(run_dir: str, who: Union[int, str]) -> str:
    """Shard path for one process: an int rank -> ``trace_rank{k}.jsonl``
    (the trainer/worker spelling); a string label -> ``trace_{who}.jsonl``
    (launcher/router-side writers). Owned here so writers and the
    exporter's glob can never drift."""
    name = f"rank{who}" if isinstance(who, int) else str(who)
    return os.path.join(run_dir, f"trace_{name}.jsonl")


def request_trace_id(req_id: int) -> str:
    """THE cross-process trace identity for serving request ``req_id``
    — one owner for the spelling, so the router's mint, its journal
    recovery, and the exporter's rederivation (for pre-trace journals)
    can never drift apart and break the per-request timeline stitch."""
    return f"req{int(req_id):08d}"


def microbatch_trace_id(step: int, mb: int) -> str:
    """THE cross-process trace identity for one pipeline microbatch —
    the MPMD runtime's counterpart of :func:`request_trace_id`: every
    stage's fwd/bwd spans and every link send/recv frame for microbatch
    ``mb`` of step ``step`` carry this id, so one microbatch stitches
    into one timeline across stage processes in the Perfetto export."""
    return f"s{int(step):06d}.mb{int(mb):04d}"


class Stopwatch:
    """Monotonic interval timer — the sanctioned way to book wall time
    into a metric OUTSIDE utils/perf.py and obs/ (graftlint GL009 flags
    raw ``time.time()``/``perf_counter()`` deltas fed to metric sinks;
    keeping the subtraction here gives ad-hoc timing one owner)."""

    __slots__ = ("_t0",)

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def lap_s(self) -> float:
        """Seconds since construction or the previous lap; resets."""
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        return dt

    def peek_s(self) -> float:
        """Seconds since construction/last lap, without resetting."""
        return time.perf_counter() - self._t0


class _Span:
    """Live span context manager (only ever built by an ENABLED tracer)."""

    __slots__ = ("_tracer", "name", "cat", "trace_id", "args", "_t0",
                 "_watch", "sid")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: Optional[str], args: Optional[dict]) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.args = args
        self.sid = ""

    def __enter__(self) -> "_Span":
        self._t0 = time.time()
        self._watch = Stopwatch()
        self.sid = self._tracer._push()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._tracer._pop(self)


class _NullSpan:
    """Shared no-op context manager: ``NULL.span(...)`` returns THIS one
    object every time — the tracing-off path allocates nothing."""

    __slots__ = ()
    sid = ""

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op; ``enabled`` is
    the one attribute hot paths check before building span arguments."""

    enabled = False

    def span(self, name: str, cat: str = "misc",
             trace_id: Optional[str] = None,
             args: Optional[dict] = None) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, name: str, cat: str, t0: float, dur_s: float,
                 trace_id: Optional[str] = None,
                 args: Optional[dict] = None) -> str:
        return ""

    def instant(self, name: str, cat: str = "misc",
                t: Optional[float] = None,
                trace_id: Optional[str] = None,
                args: Optional[dict] = None) -> str:
        return ""

    def close(self) -> None:
        pass


NULL = NullTracer()


class Tracer:
    """Writes one process's trace shard; thread-safe, lazily opened.

    ``proc`` labels the process ("rank0", "launcher", ...) and prefixes
    every span id — IDs are ``{proc}:{counter}``, explicit and
    collision-free by construction (never wall-clock-derived). Spans
    opened with :meth:`span` nest: the innermost open span is the parent
    of anything booked while it is open (including after-the-fact
    :meth:`complete` bookings, which is how the goodput-aligned
    instrumentation reuses already-measured seconds)."""

    enabled = True

    def __init__(self, path: str, proc: str) -> None:
        self.path = path
        self.proc = proc
        self._n = 0
        self._f: Any = None
        self._stack: list = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------- identity

    def _next_id(self) -> str:
        """Mint one span id. Callers must hold ``_lock`` (concurrent
        unlocked increments could mint the same id, breaking the
        collision-free contract)."""
        self._n += 1
        return f"{self.proc}:{self._n}"

    def _parent(self) -> Optional[str]:
        return self._stack[-1] if self._stack else None

    # --------------------------------------------------------------- events

    def span(self, name: str, cat: str = "misc",
             trace_id: Optional[str] = None,
             args: Optional[dict] = None) -> _Span:
        """Context manager measuring a live span (wall-clock anchor +
        monotonic duration, so a clock step mid-span cannot produce a
        negative or inflated ``dur``)."""
        return _Span(self, name, cat, trace_id, args)

    def _push(self) -> str:
        with self._lock:
            sid = self._next_id()
            self._stack.append(sid)
        return sid

    def _pop(self, span: _Span) -> None:
        with self._lock:
            if span.sid in self._stack:
                self._stack.remove(span.sid)
            parent = self._parent()
        self._emit({"ph": "X", "name": span.name, "cat": span.cat,
                    "t": span._t0, "dur": span._watch.peek_s(),
                    "sid": span.sid, "parent": parent,
                    "trace": span.trace_id, "args": span.args})

    def complete(self, name: str, cat: str, t0: float, dur_s: float,
                 trace_id: Optional[str] = None,
                 args: Optional[dict] = None) -> str:
        """Book an ALREADY-MEASURED span: ``t0`` is the wall-clock start,
        ``dur_s`` the caller's own measured seconds — pass the exact
        value handed to the goodput/stall tracker so the trace and the
        ledger can never disagree."""
        with self._lock:
            sid = self._next_id()
            parent = self._parent()
        self._emit({"ph": "X", "name": name, "cat": cat, "t": t0,
                    "dur": max(0.0, dur_s), "sid": sid,
                    "parent": parent, "trace": trace_id,
                    "args": args})
        return sid

    def instant(self, name: str, cat: str = "misc",
                t: Optional[float] = None,
                trace_id: Optional[str] = None,
                args: Optional[dict] = None) -> str:
        with self._lock:
            sid = self._next_id()
            parent = self._parent()
        self._emit({"ph": "i", "name": name, "cat": cat,
                    "t": time.time() if t is None else t, "sid": sid,
                    "parent": parent, "trace": trace_id,
                    "args": args})
        return sid

    # ---------------------------------------------------------------- sink

    def _emit(self, event: Dict[str, Any]) -> None:
        line = json.dumps({k: v for k, v in event.items() if v is not None},
                          separators=(",", ":"))
        try:
            with self._lock:
                if self._f is None:
                    self._f = open(self.path, "a")
                self._f.write(line + "\n")
                self._f.flush()
        except (OSError, ValueError):
            pass  # tracing is telemetry: never fail the traced work

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


def tracer_for(run_dir: str, who: Union[int, str],
               armed: Optional[bool] = None,
               proc: Optional[str] = None) -> Union[Tracer, NullTracer]:
    """The one constructor call sites use: a live :class:`Tracer` when
    tracing is armed (``armed``; None defers to :func:`enabled_by_env`,
    False forces off regardless of the env) and a local run dir exists
    to write into, else :data:`NULL` — so every caller gets the
    zero-cost off path by default.

    ``proc`` overrides the process label (default ``rank{who}``/the
    label) WITHOUT changing the shard filename — a fleet's replica
    workers all write ``trace_rank0.jsonl`` in their own dirs but must
    label themselves distinctly (``r1.rank0``) or the merged timeline
    holds colliding span ids. Under launcher supervision
    (``DPT_ATTEMPT`` set) the label additionally carries the attempt
    index (``rank0.a2``): a respawned attempt appends to the SAME shard
    with its counter reset to 1, so without the qualifier the
    kill/restart runs this feature exists for would mint colliding
    ids."""
    if armed is None:
        armed = enabled_by_env()
    if not armed or not run_dir or "://" in run_dir:
        return NULL
    if proc is None:
        proc = f"rank{who}" if isinstance(who, int) else str(who)
    path = trace_path(run_dir, who)
    attempt = os.environ.get("DPT_ATTEMPT", "")
    if attempt:
        proc = f"{proc}.a{attempt}"
    else:
        try:
            appending = os.path.getsize(path) > 0
        except OSError:
            appending = False
        if appending:
            # an unsupervised second run appending to an earlier
            # run's shard (a manual resume without the launcher):
            # qualify with the pid — explicit process identity, not a
            # clock — or both runs would label themselves identically
            # with counters restarting at 1
            proc = f"{proc}.p{os.getpid()}"
    return Tracer(path, proc)
