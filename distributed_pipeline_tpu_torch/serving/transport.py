"""Replica transport contract: one ``ReplicaClient`` interface, two wires.

The first fleet hard-coded its transport: FILES in the replica dir (atomic-
rename mailboxes, beacon mtimes for liveness). That transport is proven —
a request that only ever lived in a socket buffer dies with the process,
while the journal + inbox/outbox survive any kill — but it pins every
replica to one host. This module extracts the router-side protocol behind
an interface so replicas can live anywhere a socket reaches:

* :class:`FileReplicaClient` — the original transport, verbatim semantics.
  Stays the tier-1 default; every durability invariant the fleet tests
  pin (consume-completions-first, replay-on-epoch-bump, atomic results)
  is this class.
* :class:`SocketReplicaClient` — length-prefixed JSON frames over TCP to
  a :class:`WorkerSocketEndpoint` the worker advertises in
  ``ctrl/endpoint.json``. Liveness is HEARTBEAT-based (the worker's main
  loop stamps each tick; a wedged loop answers heartbeats with a stale
  stamp, so ``beacon_age_s`` grows exactly like a stale beacon mtime).
  Torn frames and half-open connections degrade to the same path as a
  kill: the client drops the connection, the age grows past the router's
  ``stale_beacon_s`` gate, and the journaled request replays on a
  sibling once the attempt bumps.

Only the DATA plane moves over the socket (submit / drain / heartbeat).
The CONTROL plane — ``ready.json``, swap command/ack, ``current.json``
pins, stop flags, launcher beacons and attempt records — stays file-based
for BOTH transports, so the hot-swap state machine, the launcher's hang
watchdog, and ``chaos.goodput.aggregate_serving`` run unchanged.

Durability difference, documented not hidden: file results are deleted
only by the router, so a kill between "computed" and "consumed" loses
nothing; socket results drained but not yet ACKed are re-sent on the next
drain (the client acks batch N in the drain call for batch N+1), and
results still in a killed worker's memory are REPLAYED on a sibling —
token-identical under greedy decoding, the same guarantee replay always
had.

Import-light (stdlib only): the router/fleet process never pays for torch.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..chaos import goodput as goodput_lib

__all__ = [
    "ReplicaPaths", "ReplicaClient", "FileReplicaClient",
    "SocketReplicaClient", "WorkerSocketEndpoint", "TransportError",
    "write_json_atomic", "read_json_file", "send_frame", "recv_frame",
    "prefix_block_hashes",
]


# --------------------------------------------------------------- file layer

def write_json_atomic(path: str, payload: dict) -> None:
    """tmp-write + rename: a reader never sees a torn JSON file, and a
    writer killed mid-write leaves only a ``.tmp`` corpse behind."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload))
    os.replace(tmp, path)


def read_json_file(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


class ReplicaPaths:
    """Canonical file locations for one replica (root doubles as the
    launcher run dir, so beacons/attempts land next to the mailboxes)."""

    def __init__(self, fleet_dir: str, rid: int,
                 root: Optional[str] = None) -> None:
        self.rid = rid
        self.root = root or goodput_lib.replica_dir(fleet_dir, rid)
        self.inbox = os.path.join(self.root, "inbox")
        self.outbox = os.path.join(self.root, "outbox")
        self.ctrl = os.path.join(self.root, "ctrl")
        self.log_dir = os.path.join(self.root, "logs")
        self.ready_path = os.path.join(self.ctrl, "ready.json")
        self.stop_path = os.path.join(self.ctrl, "stop")
        self.swap_path = os.path.join(self.ctrl, "swap.json")
        self.swap_ack_path = os.path.join(self.ctrl, "swap_ack.json")
        self.current_path = os.path.join(self.ctrl, "current.json")
        # socket transport: the worker advertises its data-plane endpoint
        # here (host+port+attempt); the ctrl plane stays in these files
        self.endpoint_path = os.path.join(self.ctrl, "endpoint.json")

    @classmethod
    def at(cls, root: str, rid: int = 0) -> "ReplicaPaths":
        """Build from an existing replica root (the worker side only
        knows its own ``--fleet_worker_dir``, not the fleet dir)."""
        return cls("", rid, root=root)

    def ensure(self) -> "ReplicaPaths":
        for d in (self.root, self.inbox, self.outbox, self.ctrl):
            os.makedirs(d, exist_ok=True)
        return self

    def req_path(self, req_id: int) -> str:
        return os.path.join(self.inbox, f"req_{req_id:08d}.json")

    def result_path(self, req_id: int) -> str:
        return os.path.join(self.outbox, f"req_{req_id:08d}.json")


# ------------------------------------------------------------ prefix hashes

def prefix_block_hashes(tokens: Sequence[int], page_size: int,
                        max_blocks: int = 32) -> Tuple[int, ...]:
    """Cumulative CRC32 hashes of the page-aligned prefix blocks of a
    prompt — the routing-side twin of the paged-KV prefix cache's page
    granularity. ``hashes[i]`` identifies the first ``(i+1)*page_size``
    tokens, so two prompts share exactly ``k`` leading hashes iff they
    share ``k`` full cache pages. CRC32 (not ``hash()``) so the values
    are identical across processes regardless of PYTHONHASHSEED: the
    worker advertises them, the router compares them."""
    page = max(1, int(page_size))
    toks = [int(t) for t in tokens]
    out: List[int] = []
    h = 0
    for b in range(min(len(toks) // page, max_blocks)):
        block = toks[b * page:(b + 1) * page]
        h = zlib.crc32(",".join(map(str, block)).encode(), h)
        out.append(h)
    return tuple(out)


# ----------------------------------------------------------------- framing

class TransportError(ConnectionError):
    """Any data-plane failure: torn frame, half-open peer, refused
    connect, oversized frame. The client maps ALL of these to the same
    observable — a growing heartbeat age — so the router's health gate
    and replay path never need to know which wire failed how."""


MAX_FRAME_BYTES = 16 * 1024 * 1024  # a prompt is a few KB; 16MB is absurd
_HDR = struct.Struct(">I")          # 4-byte big-endian payload length


def send_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    if len(data) > MAX_FRAME_BYTES:
        raise TransportError(f"frame too large: {len(data)} bytes")
    try:
        sock.sendall(_HDR.pack(len(data)) + data)
    except OSError as e:
        raise TransportError(f"send failed: {e}") from e


def _recv_exact(sock: socket.socket, n: int, *,
                header: bool = False) -> bytes:
    """Read exactly n bytes. A clean EOF before the FIRST header byte is
    a normal close (raises TransportError with ``clean=True`` flavor via
    empty message); anything torn mid-frame is a TransportError. An idle
    timeout with zero bytes read propagates as ``socket.timeout`` so a
    server loop can keep a quiet connection open."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if header and not buf:
                raise  # idle, not torn: caller may retry
            raise TransportError(
                f"torn frame: timed out with {len(buf)}/{n} bytes")
        except OSError as e:
            raise TransportError(f"recv failed: {e}") from e
        if not chunk:
            if header and not buf:
                raise TransportError("peer closed")
            raise TransportError(f"torn frame: EOF at {len(buf)}/{n} bytes")
        buf += chunk
    return buf


def recv_frame(sock: socket.socket) -> dict:
    (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size, header=True))
    if length > MAX_FRAME_BYTES:
        raise TransportError(f"frame too large: {length} bytes")
    try:
        payload = json.loads(_recv_exact(sock, length).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise TransportError(f"bad frame payload: {e}") from e
    if not isinstance(payload, dict):
        raise TransportError("frame payload is not an object")
    return payload


# ------------------------------------------------------- client interface

class ReplicaClient:
    """Router-side view of one replica — the transport contract.

    Implementations must provide::

        alive()             -> bool        is anything still supervising it
        ready()             -> dict|None   worker's ready.json announcement
        beacon_age_s(now)   -> float|None  liveness age (None = not born)
        submit(payload)     -> None        deliver one request (may raise
                                           TransportError; the router
                                           reverts the placement)
        consume_results()   -> [dict]      drain finished results, at-least-
                                           once (the router dedups by id)
        prefix_index()      -> seq[int]    advertised prefix-cache hashes
        close()             -> None        release any wire state

    ``ready()`` is ALWAYS the ctrl-plane file: the attempt epoch it
    carries is what keys replay, and it must survive any data-plane
    outage."""

    def __init__(self, paths: ReplicaPaths,
                 alive_fn: Callable[[], bool] = lambda: True) -> None:
        self.paths = paths.ensure()
        self.rid = paths.rid
        self._alive_fn = alive_fn

    def alive(self) -> bool:
        """Whether anything still supervises this replica (a dead
        supervisor means no more restarts: the replica is gone for good)."""
        return bool(self._alive_fn())

    def ready(self) -> Optional[dict]:
        return read_json_file(self.paths.ready_path)

    def beacon_age_s(self, now: Optional[float] = None) -> Optional[float]:
        raise NotImplementedError

    def submit(self, payload: dict) -> None:
        raise NotImplementedError

    def consume_results(self) -> List[dict]:
        raise NotImplementedError

    def prefix_index(self) -> Sequence[int]:
        return ()

    def close(self) -> None:
        pass


class FileReplicaClient(ReplicaClient):
    """The file transport: submit into the replica's inbox, consume
    its outbox, liveness from beacon mtimes. Results are deleted only by
    this reader, so a worker kill between "computed" and "consumed" loses
    nothing."""

    def beacon_age_s(self, now: Optional[float] = None) -> Optional[float]:
        mtimes = goodput_lib.beacon_mtimes(self.paths.root)
        if not mtimes:
            return None
        return max(0.0, (now if now is not None else time.time())
                   - max(mtimes.values()))

    def submit(self, payload: dict) -> None:
        write_json_atomic(self.paths.req_path(int(payload["id"])), payload)

    def consume_results(self) -> List[dict]:
        import glob
        out = []
        for path in sorted(glob.glob(
                os.path.join(self.paths.outbox, "req_*.json"))):
            payload = read_json_file(path)
            if payload is None:
                continue  # torn writes impossible (atomic rename); a
                # vanished file was consumed by a competing reader
            out.append(payload)
            try:
                os.unlink(path)
            except OSError:
                pass
        return out

    def prefix_index(self) -> Sequence[int]:
        beacon = read_json_file(goodput_lib.beacon_path(self.paths.root, 0))
        if beacon is None:
            return ()
        return beacon.get("prefix_index") or ()


class SocketReplicaClient(ReplicaClient):
    """TCP data plane to a :class:`WorkerSocketEndpoint`.

    One persistent connection, reconnected on any error. Heartbeats carry
    the worker's last main-loop tick stamp, so ``beacon_age_s`` measures
    the same thing beacon mtimes do — loop liveness, not just process
    liveness (a wedged worker's endpoint thread still answers, with a
    stale stamp). Heartbeat replies are cached for ``hb_cache_s`` because
    the router's placement gate runs per pending request per poll.

    Drain is at-least-once: the reply keeps results buffered worker-side
    until the NEXT drain acks their ids, so a reply torn mid-frame is
    re-sent rather than lost; the router's duplicate-result accounting
    absorbs any re-delivery."""

    def __init__(self, paths: ReplicaPaths,
                 alive_fn: Callable[[], bool] = lambda: True, *,
                 connect_timeout_s: float = 0.5,
                 io_timeout_s: float = 5.0,
                 hb_cache_s: float = 0.05) -> None:
        super().__init__(paths, alive_fn)
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s
        self.hb_cache_s = hb_cache_s
        self._sock: Optional[socket.socket] = None
        self._pending_ack: List[int] = []
        self._hb_cache: Optional[Tuple[float, Optional[dict]]] = None
        self._last_tick: Optional[float] = None  # newest worker tick stamp
        self._first_fail_t: Optional[float] = None

    # wire plumbing -----------------------------------------------------

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _conn(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        ep = read_json_file(self.paths.endpoint_path)
        if ep is None or "port" not in ep:
            raise TransportError("no endpoint advertised")
        try:
            s = socket.create_connection(
                (ep.get("host", "127.0.0.1"), int(ep["port"])),
                timeout=self.connect_timeout_s)
        except OSError as e:
            raise TransportError(f"connect failed: {e}") from e
        s.settimeout(self.io_timeout_s)
        self._sock = s
        return s

    def _call(self, msg: dict) -> dict:
        try:
            s = self._conn()
            send_frame(s, msg)
            reply = recv_frame(s)
        except socket.timeout as e:
            self._drop_conn()
            raise TransportError(f"timed out: {e}") from e
        except TransportError:
            self._drop_conn()
            raise
        if not reply.get("ok"):
            raise TransportError(
                f"replica refused {msg.get('op')!r}: {reply.get('error')}")
        return reply

    # contract ----------------------------------------------------------

    def _heartbeat(self) -> Optional[dict]:
        mono = time.monotonic()
        if (self._hb_cache is not None
                and mono - self._hb_cache[0] < self.hb_cache_s):
            return self._hb_cache[1]
        try:
            reply = self._call({"op": "hb"})
        except TransportError:
            if self._first_fail_t is None:
                self._first_fail_t = time.time()
            self._hb_cache = (mono, None)
            return None
        self._first_fail_t = None
        self._last_tick = float(reply.get("t_tick") or 0.0) or None
        self._hb_cache = (mono, reply)
        return reply

    def beacon_age_s(self, now: Optional[float] = None) -> Optional[float]:
        wall = now if now is not None else time.time()
        hb = self._heartbeat()
        if hb is not None and self._last_tick is not None:
            return max(0.0, wall - self._last_tick)
        # unreachable: age from the last good tick stamp, else from the
        # advertised endpoint's birth, else from the first failure we
        # observed — None ("not born yet") only before any endpoint exists
        if self._last_tick is not None:
            return max(0.0, wall - self._last_tick)
        ep = read_json_file(self.paths.endpoint_path)
        if ep is not None:
            return max(0.0, wall - float(ep.get("t") or wall))
        if self._first_fail_t is not None:
            return max(0.0, wall - self._first_fail_t)
        return None

    def submit(self, payload: dict) -> None:
        self._call({"op": "submit", "req": payload})

    def consume_results(self) -> List[dict]:
        try:
            reply = self._call({"op": "drain", "ack": self._pending_ack})
        except TransportError:
            return []  # un-acked results stay buffered worker-side
        results = [r for r in reply.get("results", [])
                   if isinstance(r, dict)]
        self._pending_ack = [int(r.get("id", -1)) for r in results]
        return results

    def prefix_index(self) -> Sequence[int]:
        hb = self._heartbeat()
        if hb is None:
            return ()
        return hb.get("prefix_index") or ()

    def close(self) -> None:
        self._drop_conn()


# ------------------------------------------------------- worker endpoint

class WorkerSocketEndpoint:
    """Worker-side data plane for :class:`SocketReplicaClient`: a
    background thread serving submit/drain/hb frames on a loopback-bound
    ephemeral port, advertised atomically in ``ctrl/endpoint.json``.

    The worker's MAIN loop stays the owner of all work: it calls
    :meth:`take_submits` / :meth:`queue_result` / :meth:`tick` exactly
    where the file transport polled its mailboxes. The endpoint thread
    only buffers — so a wedged main loop stops calling ``tick`` and every
    heartbeat reply carries the stale stamp that health-gates the replica
    out (and eventually trips the file-beacon hang watchdog, which kills
    the process and triggers journal replay: identical fault path)."""

    def __init__(self, paths: ReplicaPaths, replica_id: int,
                 attempt: int, host: str = "127.0.0.1") -> None:
        self.paths = paths
        self.replica_id = replica_id
        self.attempt = attempt
        self._lock = threading.Lock()
        self._submits: List[dict] = []
        self._results: Dict[int, dict] = {}  # popped only on client ack
        self._t_tick = time.time()
        self._hb_extra: dict = {}
        self._stop = False
        self._srv = socket.create_server((host, 0))
        self._srv.settimeout(0.25)
        self.port = self._srv.getsockname()[1]
        write_json_atomic(paths.endpoint_path, {
            "host": host, "port": self.port, "attempt": attempt,
            "replica": replica_id, "t": time.time()})
        self._thread = threading.Thread(
            target=self._serve, daemon=True,
            name=f"replica{replica_id}-endpoint")
        self._thread.start()

    # main-loop side ----------------------------------------------------

    def take_submits(self) -> List[dict]:
        with self._lock:
            out, self._submits = self._submits, []
        return out

    def queue_result(self, payload: dict) -> None:
        with self._lock:
            self._results[int(payload["id"])] = payload

    def tick(self, t: Optional[float] = None,
             extra: Optional[dict] = None) -> None:
        with self._lock:
            self._t_tick = t if t is not None else time.time()
            if extra:
                self._hb_extra.update(extra)

    def close(self) -> None:
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass
        try:
            os.unlink(self.paths.endpoint_path)
        except OSError:
            pass
        self._thread.join(timeout=2.0)

    # endpoint-thread side ----------------------------------------------

    def _serve(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True,
                             name=f"replica{self.replica_id}-conn").start()

    def _handle(self, conn: socket.socket) -> None:
        conn.settimeout(0.5)
        try:
            while not self._stop:
                try:
                    msg = recv_frame(conn)
                except socket.timeout:
                    continue  # idle connection: keep it open
                except TransportError:
                    return  # torn/closed: drop the connection, keep state
                try:
                    send_frame(conn, self._reply(msg))
                except TransportError:
                    return  # un-acked results survive for the next drain
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _reply(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "submit":
            req = msg.get("req")
            if not isinstance(req, dict) or "id" not in req:
                return {"ok": False, "error": "malformed submit"}
            with self._lock:
                self._submits.append(req)
            return {"ok": True}
        if op == "drain":
            with self._lock:
                for rid in msg.get("ack") or []:
                    try:
                        self._results.pop(int(rid), None)
                    except (TypeError, ValueError):
                        pass
                results = [self._results[k]
                           for k in sorted(self._results)]
            return {"ok": True, "results": results}
        if op == "hb":
            with self._lock:
                return {"ok": True, "t_tick": self._t_tick,
                        "attempt": self.attempt,
                        "replica": self.replica_id, **self._hb_extra}
        return {"ok": False, "error": f"unknown op {op!r}"}
