"""StageLink: the one stage-to-stage send/recv substrate.

A link is a ONE-DIRECTIONAL ordered queue of frames between two
processes; a frame is a dict of numpy arrays plus a small JSON metadata
dict. Two implementations stand behind the same interface:

* :class:`FileStageLink` — the host-relay transport: each frame is an
  atomic-rename ``frame_{seq:08d}.npz`` in the link directory (the
  fleet's file-transport pattern: a frame in a socket buffer dies with
  the process, a file does not). The disaggregated fleet's prefill and
  decode workers talk over it.
* :class:`MemStageLink` — an in-process deque speaking the same
  protocol (``mpmd/disagg.serve_disagg_inprocess`` runs both roles in
  one process over it). The callers never know which transport they run
  on.

Contract (both implementations):

* ``send`` blocks while ``pending() >= capacity`` — BACKPRESSURE: a
  fast producer stage can hold at most ``capacity`` undelivered frames
  (bounds the activation stash exactly like the in-program 1F1B
  schedule's ``stash_size``).
* ``recv`` returns frames strictly in send order, blocking up to
  ``timeout_s``; both calls take an ``interrupt`` callable polled while
  blocked so a worker waiting on a DEAD peer can stop waiting (a fleet
  worker's stop flag) instead of hanging into the watchdog.
* Every frame carries the sender's ``epoch``; a receiver on a newer
  epoch silently drops older frames — in-flight activations from before
  a stage-restart rewind can never corrupt the replayed schedule.
* A frame that fails to parse (torn write from a killed sender, disk
  corruption) is quarantined to ``*.corrupt`` and skipped, never
  re-polled forever and never raised into the schedule.
* Blocked time accumulates in ``wait_s`` — the ``link_wait`` goodput
  category (chaos/goodput.py): send/recv stalls are accounted run time,
  not silence.

Import-light: numpy only (moving bytes never pays a torch import).
"""

from __future__ import annotations

import collections
import io
import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import trace as trace_lib

__all__ = [
    "StageLink", "FileStageLink", "MemStageLink",
    "flatten_tree", "unflatten_tree",
]

_FRAME_RE = re.compile(r"frame_(\d{8})\.npz$")
_META_KEY = "__meta__"

Frame = Tuple[Dict[str, np.ndarray], dict]


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict-of-arrays -> flat ``{"a/b/c": array}`` (the frame wire
    format; links ship flat dicts, trees are a caller convention)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            out.update(flatten_tree(v, key))
    else:
        out[prefix] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


class StageLink:
    """Transport interface (see module docstring for the contract)."""

    wait_s: float = 0.0

    def send(self, arrays: Dict[str, np.ndarray], meta: dict, *,
             timeout_s: float = 600.0,
             interrupt: Optional[Callable[[], bool]] = None) -> bool:
        raise NotImplementedError

    def recv(self, *, timeout_s: float = 600.0,
             interrupt: Optional[Callable[[], bool]] = None
             ) -> Optional[Frame]:
        raise NotImplementedError

    def pending(self) -> int:
        raise NotImplementedError

    def set_epoch(self, epoch: int) -> None:
        raise NotImplementedError

    def take_wait_s(self) -> float:
        """Blocked seconds accumulated since the last take (the link_wait
        goodput feed; reading resets so callers book each second once)."""
        s, self.wait_s = self.wait_s, 0.0
        return s


class FileStageLink(StageLink):
    """Atomic-rename file transport over one directory (host relay)."""

    def __init__(self, path: str, *, capacity: int = 8, epoch: int = 0,
                 tracer=trace_lib.NULL, poll_s: float = 0.004) -> None:
        self.path = path
        self.capacity = max(1, int(capacity))
        self.epoch = int(epoch)
        self.tracer = tracer
        self.poll_s = poll_s
        self.wait_s = 0.0
        os.makedirs(path, exist_ok=True)
        self._seq = self._highest_seq() + 1

    # ------------------------------------------------------------- internals
    def _highest_seq(self) -> int:
        top = -1
        try:
            for name in os.listdir(self.path):
                m = _FRAME_RE.match(name)
                if m:
                    top = max(top, int(m.group(1)))
        except OSError:
            pass
        return top

    def _frames(self) -> List[Tuple[int, str]]:
        out = []
        try:
            for name in os.listdir(self.path):
                m = _FRAME_RE.match(name)
                if m:
                    out.append((int(m.group(1)), os.path.join(self.path,
                                                              name)))
        except OSError:
            pass
        return sorted(out)

    # ------------------------------------------------------------- interface
    def pending(self) -> int:
        return len(self._frames())

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def sweep(self) -> int:
        """Delete every pending frame (a rewind's cleanup of a reader's
        OWN inbound links; staleness otherwise rides the epoch filter)."""
        n = 0
        for _, path in self._frames():
            try:
                os.unlink(path)
                n += 1
            except OSError:
                pass
        return n

    def send(self, arrays: Dict[str, np.ndarray], meta: dict, *,
             timeout_s: float = 600.0,
             interrupt: Optional[Callable[[], bool]] = None) -> bool:
        watch = trace_lib.Stopwatch()
        deadline = time.monotonic() + timeout_s
        blocked = False
        while self.pending() >= self.capacity:
            blocked = True
            if interrupt is not None and interrupt():
                self.wait_s += watch.lap_s()
                return False
            if time.monotonic() > deadline:
                self.wait_s += watch.lap_s()
                raise TimeoutError(
                    f"link {self.path}: send blocked past {timeout_s}s at "
                    f"capacity {self.capacity}")
            time.sleep(self.poll_s)
        if blocked:
            self.wait_s += watch.lap_s()
        meta = dict(meta)
        meta.setdefault("epoch", self.epoch)
        t0 = time.time()
        buf = io.BytesIO()
        payload = dict(arrays)
        payload[_META_KEY] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8)
        np.savez(buf, **payload)
        seq = self._seq
        self._seq += 1
        final = os.path.join(self.path, f"frame_{seq:08d}.npz")
        tmp = final + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, final)
        if self.tracer.enabled:
            self.tracer.complete(
                "link_send", "link", t0, time.time() - t0,
                trace_id=meta.get("trace"),
                args={"link": os.path.basename(self.path), "seq": seq,
                      "tag": meta.get("tag")})
        return True

    def recv(self, *, timeout_s: float = 600.0,
             interrupt: Optional[Callable[[], bool]] = None
             ) -> Optional[Frame]:
        watch = trace_lib.Stopwatch()
        t0 = time.time()
        deadline = time.monotonic() + timeout_s
        while True:
            for seq, path in self._frames():
                frame = self._consume(path)
                if frame is None:
                    continue  # quarantined or stale: keep scanning
                arrays, meta = frame
                self.wait_s += watch.lap_s()
                if self.tracer.enabled:
                    self.tracer.complete(
                        "link_recv", "link", t0, time.time() - t0,
                        trace_id=meta.get("trace"),
                        args={"link": os.path.basename(self.path),
                              "seq": seq, "tag": meta.get("tag")})
                return arrays, meta
            if interrupt is not None and interrupt():
                self.wait_s += watch.lap_s()
                return None
            if time.monotonic() > deadline:
                self.wait_s += watch.lap_s()
                return None
            time.sleep(self.poll_s)

    def _consume(self, path: str) -> Optional[Frame]:
        """Load + delete one frame file; quarantine a torn/garbled one and
        drop frames from an older epoch (pre-rewind stragglers)."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
            with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files if k != _META_KEY}
                meta = json.loads(bytes(z[_META_KEY].tobytes()).decode(
                    "utf-8")) if _META_KEY in z.files else {}
        except Exception:
            try:  # torn frame: quarantine so it is never re-polled
                os.replace(path, path + ".corrupt")
            except OSError:
                pass
            return None
        try:
            os.unlink(path)
        except OSError:
            pass
        if int(meta.get("epoch", 0)) < self.epoch:
            return None  # pre-rewind straggler
        return arrays, meta


class MemStageLink(StageLink):
    """In-process deque transport — the device-transfer seam (see module
    docstring). Same framing, epochs, capacity, and quarantine-free
    semantics; used by the in-process runner (dryrun, numerics tests)."""

    def __init__(self, *, capacity: int = 8, epoch: int = 0,
                 tracer=trace_lib.NULL) -> None:
        self.capacity = max(1, int(capacity))
        self.epoch = int(epoch)
        self.tracer = tracer
        self.wait_s = 0.0
        self._q: collections.deque = collections.deque()

    def pending(self) -> int:
        return len(self._q)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def sweep(self) -> int:
        n = len(self._q)
        self._q.clear()
        return n

    def send(self, arrays: Dict[str, np.ndarray], meta: dict, *,
             timeout_s: float = 600.0,
             interrupt: Optional[Callable[[], bool]] = None) -> bool:
        if len(self._q) >= self.capacity:
            # single-threaded in-process use: a full queue is a schedule
            # bug, not a wait — fail loudly rather than deadlock
            raise TimeoutError("MemStageLink at capacity "
                               f"{self.capacity}: no concurrent consumer")
        meta = dict(meta)
        meta.setdefault("epoch", self.epoch)
        self._q.append(({k: np.asarray(v) for k, v in arrays.items()},
                        meta))
        return True

    def recv(self, *, timeout_s: float = 600.0,
             interrupt: Optional[Callable[[], bool]] = None
             ) -> Optional[Frame]:
        while self._q:
            arrays, meta = self._q.popleft()
            if int(meta.get("epoch", 0)) < self.epoch:
                continue
            return arrays, meta
        return None
