"""Multi-replica serving fleet: replica protocol + supervision + hot-swap.

A fleet is N DecodeServer replicas, each a SEPARATE worker process running
its own supervised single-worker ring via the launcher
(``parallel/launcher.py``) — so every replica gets the supervision
machinery: per-attempt records (``attempts.jsonl``), restart budget +
exponential backoff, crash-loop fail-fast, and the beacon-mtime hang
watchdog
(a replica that wedges mid-request stops beaconing and gets SIGKILLed,
which the router then treats like any other death: replay on a sibling).

The replica transport lives behind the :mod:`.transport` contract: the
tier-1 default is FILES inside the fleet dir — deliberately: a request
that only ever lived in a socket buffer dies with the process, while the
router's append-only journal plus per-replica inbox/outbox survive any
kill and make replay a pure bookkeeping operation. The alternative
``socket`` transport moves only the DATA plane (submit/drain/heartbeat)
onto TCP so replicas can live on other hosts; the ctrl plane below stays
file-based either way. Layout (dir names owned by
:mod:`..chaos.goodput` so import-light readers agree)::

    fleet_dir/
      journal.jsonl            router's durable request journal
      replica_0/               = the replica's launcher RUN DIR
        .progress_rank0.json   serving beacon (tick + serving snapshot)
        attempts.jsonl         launcher per-attempt records
        serving_attempt000.json clean-exit serving sidecar
        inbox/req_*.json       router -> worker (atomic rename)
        outbox/req_*.json      worker -> router (atomic rename)
        ctrl/ready.json        worker's liveness+version announcement
        ctrl/swap.json         fleet -> worker: load this checkpoint
        ctrl/swap_ack.json     worker -> fleet: loaded / refused
        ctrl/current.json      fleet's post-swap pin (restart consistency)
        ctrl/stop              graceful-shutdown flag
        logs/worker_0.log      launcher-captured worker output

Protocol invariants the tests pin:

* a worker CLEARS its inbox at startup (those requests were assigned to a
  previous attempt; the router replays them when it observes the attempt
  bump in ``ready.json`` — completions are consumed first, so a request
  that finished just before the kill is never re-run);
* results are atomic-renamed into the outbox and deleted only by the
  router, so a kill between "computed" and "consumed" loses nothing;
* ``ctrl/current.json`` pins the params version a RESTARTED replica must
  load: without it, a replica respawned after a fleet-wide hot-swap would
  silently come back serving the old weights (version skew).

HOT-SWAP (:meth:`ServingFleet.begin_hot_swap` + ``step_swap``) rolls a
newer checkpoint through the fleet one replica at a time — drain (router
stops placing, outstanding requests finish), load, ack — so at every
instant at least N-1 replicas are serving. The FIRST replica is the
canary: it loads the checkpoint before any sibling is touched, so a
corrupt/unreadable swap target aborts the swap with ZERO replicas moved
(no partial-fleet version skew). A failure later in the roll triggers a
best-effort rollback of already-swapped replicas to the old version.

Import-light (no torch): the fleet supervisor and router run in a process
that never imports torch; only replica workers pay for it and for the
card.

This is the JAX package's module (``distributed_pipeline_tpu/serving/
fleet.py``) with one documented divergence of layout: a finalized
checkpoint is the port's ``model_NNNNNN.pt`` file (written to ``.tmp`` and
renamed), not an orbax directory with a commit marker
(:func:`find_newest_finalized`), and the replicas' device rides their
argv as ``--device`` (``replica_platform``) where the JAX fleet pins
``JAX_PLATFORMS``.
"""

from __future__ import annotations

import contextlib
import glob
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..chaos import goodput as goodput_lib
from ..obs import trace as trace_lib
from .transport import (  # noqa: F401  (re-exported for the workers)
    FileReplicaClient,
    ReplicaClient,
    ReplicaPaths,
    SocketReplicaClient,
    WorkerSocketEndpoint,
    read_json_file,
    write_json_atomic,
)

__all__ = [
    "ReplicaPaths", "ReplicaClient", "FileReplicaClient",
    "SocketReplicaClient", "WorkerProtocol", "ServingTracker",
    "ServingFleet", "write_json_atomic", "read_json_file",
    "find_newest_finalized", "checkpoint_target",
]


# ---------------------------------------------------- checkpoint discovery

def checkpoint_target(directory: str, step: int) -> str:
    """The port's checkpoint file of ``step`` in a run dir."""
    return os.path.join(directory, f"model_{step:06d}.pt")


def find_newest_finalized(directory: str) -> Optional[str]:
    """Newest finalized ``model_NNNNNN.pt`` in a run dir, never a ``.tmp``
    (the port writes each checkpoint to ``.tmp`` and renames it, so a file
    under its own name is complete). The fleet supervisor picks a swap
    target without importing torch; actually LOADING it is the canary
    replica's job, and a corrupt payload fails there."""
    best, best_step = None, -1
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    for name in names:
        if not (name.startswith("model_") and name.endswith(".pt")):
            continue
        digits = name[len("model_"):-len(".pt")]
        if not digits.isdigit():
            continue
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            continue
        if int(digits) > best_step:
            best_step, best = int(digits), path
    return best


# ------------------------------------------------------------ worker side

class ServingTracker:
    """Worker-side serving-time decomposition (the serving twin of
    perf.GoodputTracker): ``drain``/``swap`` are booked explicitly,
    ``serving`` is the residual — so ``wall == serving + drain + swap``
    holds identically and the fleet-level fold's ``accounted_frac``
    is 1.0 by construction. Snapshot rides every beacon (the kill flight
    recorder) and the clean-exit sidecar."""

    CATEGORIES = ("drain_s", "swap_s")

    def __init__(self, t_start: Optional[float] = None) -> None:
        # spawn-anchored like the trainer: the launcher stamps DPT_SPAWN_T
        # so interpreter+import+restore time is inside the attempt's wall
        env = os.environ.get("DPT_SPAWN_T")
        self.t_start = (t_start if t_start is not None
                        else float(env) if env else time.time())
        self._cats = {c: 0.0 for c in self.CATEGORIES}
        # optional obs/ span sink (WorkerProtocol wires its tracer in):
        # timed() then books a span from the SAME measured seconds, so
        # the hot-swap drain/load windows on the timeline are exactly the
        # ledger's drain_s/swap_s — they can never disagree
        self.tracer = trace_lib.NULL

    def book(self, category: str, seconds: float) -> None:
        self._cats[category] += max(0.0, seconds)

    @contextlib.contextmanager
    def timed(self, category: str):
        t0 = time.perf_counter()
        t0_wall = time.time()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.book(category, dt)
            if self.tracer.enabled:
                name = category[:-2] if category.endswith("_s") else category
                self.tracer.complete(name, "swap", t0_wall, dt)

    def snapshot(self) -> Dict[str, float]:
        wall = max(0.0, time.time() - self.t_start)
        booked = sum(self._cats.values())
        return {
            "wall_s": round(wall, 6),
            "serving_s": round(max(0.0, wall - booked), 6),
            **{c: round(v, 6) for c, v in self._cats.items()},
        }


class WorkerProtocol:
    """The worker half of the replica protocol, shared by the replica
    worker and the two disaggregated workers (run/serve.py) so they can
    never drift apart."""

    def __init__(self, paths: ReplicaPaths, replica_id: int,
                 attempt: Optional[int] = None,
                 trace_armed: Optional[bool] = None,
                 transport: str = "file") -> None:
        if transport not in ("file", "socket"):
            raise ValueError(f"unknown replica transport {transport!r}")
        self.paths = paths.ensure()
        self.replica_id = replica_id
        self.transport = transport
        self._endpoint: Optional[WorkerSocketEndpoint] = None
        self._socket_pending: Dict[int, dict] = {}  # admitted, unconsumed
        self.attempt = (attempt if attempt is not None
                        else int(os.environ.get("DPT_ATTEMPT") or 0))
        self.tracker = ServingTracker()
        # Span tracing (obs/): one shard per replica worker process,
        # armed by DPT_TRACE (the fleet parent exports it; the launcher
        # forwards it to every attempt) or explicitly. Request spans are
        # booked HERE — at the protocol layer every worker kind shares —
        # so the cross-process trace id propagated by the router cannot
        # drift between them. The
        # process label is replica-qualified: every replica's shard is
        # trace_rank0.jsonl in its OWN dir, but span ids must stay
        # unique across the merged fleet timeline.
        self.tracer = trace_lib.tracer_for(self.paths.root, 0,
                                           armed=trace_armed,
                                           proc=f"r{replica_id}.rank0")
        self.tracker.tracer = self.tracer
        self._admits: Dict[int, tuple] = {}  # id -> (trace id, admit wall)
        self._last_swap_id: Optional[int] = None
        # the launcher learns the run dir through the same handshake the
        # trainer uses — that is what points its hang watchdog (and the
        # attempt harvester) at this replica's beacons
        run_dir_file = os.environ.get("DPT_RUN_DIR_FILE")
        if run_dir_file:
            try:
                with open(run_dir_file, "w") as f:
                    f.write(os.path.abspath(self.paths.root))
            except OSError:
                pass

    # -------------------------------------------------------------- startup

    def startup(self) -> Optional[dict]:
        """Clear stale inbox entries (they belong to a previous attempt;
        the router replays them on observing the attempt bump) and return
        the fleet's ``current.json`` params pin, if any — a restarted
        replica must load THAT version, not its original CLI flags, or a
        restart after a fleet-wide hot-swap reintroduces version skew."""
        for path in glob.glob(os.path.join(self.paths.inbox, "req_*.json")):
            try:
                os.unlink(path)
            except OSError:
                pass
        if self.transport == "socket":
            # the data plane comes up here, AFTER the stale-inbox purge
            # and before any ready announcement: a router that connects
            # early just sees an empty drain
            self._endpoint = WorkerSocketEndpoint(
                self.paths, self.replica_id, self.attempt)
        return read_json_file(self.paths.current_path)

    def announce_ready(self, params_step: int) -> None:
        write_json_atomic(self.paths.ready_path, {
            "attempt": self.attempt, "replica": self.replica_id,
            "params_step": int(params_step), "t": time.time()})
        if self.tracer.enabled:
            # swap visibility: a ready instant at a NEW params_step marks
            # the exact moment the replica started serving that version
            self.tracer.instant("ready", "lifecycle",
                                args={"params_step": int(params_step),
                                      "attempt": self.attempt})

    # ----------------------------------------------------------- main loop

    def stop_requested(self) -> bool:
        return os.path.exists(self.paths.stop_path)

    def poll_inbox(self) -> List[dict]:
        """Pending requests, oldest id first. Entries are NOT consumed
        here — call :meth:`consume` once the request is safely admitted,
        so a kill between read and admit leaves the entry for the replay
        path (for the socket transport the entry lives only in this
        attempt's memory; the attempt bump replays it all the same)."""
        out = []
        if self.transport == "socket":
            assert self._endpoint is not None
            for payload in self._endpoint.take_submits():
                self._socket_pending[int(payload.get("id", -1))] = payload
            out = [self._socket_pending[k]
                   for k in sorted(self._socket_pending)]
        else:
            for path in sorted(glob.glob(
                    os.path.join(self.paths.inbox, "req_*.json"))):
                payload = read_json_file(path)
                if payload is not None:
                    out.append(payload)
        if self.tracer.enabled:
            for payload in out:
                # first sight of the request on this replica: the
                # serve span (booked at write_result) starts here
                self._admits.setdefault(
                    int(payload.get("id", -1)),
                    (payload.get("trace"), time.time()))
        return out

    def consume(self, req_id: int) -> None:
        if self.transport == "socket":
            self._socket_pending.pop(req_id, None)
            return
        try:
            os.unlink(self.paths.req_path(req_id))
        except OSError:
            pass

    def write_result(self, payload: dict) -> None:
        payload = {**payload, "replica": self.replica_id,
                   "attempt": self.attempt, "t_done": time.time()}
        if self.transport == "socket":
            assert self._endpoint is not None
            self._endpoint.queue_result(payload)
        else:
            write_json_atomic(self.paths.result_path(int(payload["id"])),
                              payload)
        admit = self._admits.pop(int(payload["id"]), None)
        if admit is not None and self.tracer.enabled:
            trace_id, t_admit = admit
            self.tracer.complete(
                "serve", "request", t_admit,
                max(0.0, payload["t_done"] - t_admit),
                trace_id=trace_id,
                args={"id": int(payload["id"]),
                      "replica": self.replica_id,
                      "n_tokens": len(payload.get("tokens") or []),
                      "replays": payload.get("replays")})

    def pending_swap(self) -> Optional[dict]:
        """The swap command not yet acked by THIS process. Re-reading the
        same id after a restart is fine: loading a checkpoint is
        idempotent, and an aborted swap's command file is deleted by the
        fleet before any replica could re-observe it."""
        cmd = read_json_file(self.paths.swap_path)
        if cmd is None or cmd.get("id") == self._last_swap_id:
            return None
        return cmd

    def ack_swap(self, swap_id: int, ok: bool, params_step: int,
                 error: str = "") -> None:
        self._last_swap_id = swap_id
        write_json_atomic(self.paths.swap_ack_path, {
            "id": swap_id, "ok": bool(ok), "params_step": int(params_step),
            "error": error[:500], "t": time.time()})

    # ------------------------------------------------------ beacon/sidecar

    def write_beacon(self, tick: int, extra: Optional[dict] = None) -> None:
        """Atomic per-tick progress beacon: the launcher's hang-watchdog
        liveness signal AND the kill flight recorder (the ``serving``
        snapshot is harvested into the attempt record post-mortem). The
        ``step``/``start_step`` fields make the crash-loop detector see
        tick progress the way it sees training steps."""
        payload = {
            "step": int(tick), "start_step": 0, "t": time.time(),
            "attempt": self.attempt, "rank": 0,
            "replica": self.replica_id,
            "serving": self.tracker.snapshot(),
        }
        if extra:
            payload.update(extra)
        if self._endpoint is not None:
            # the SAME tick that proves loop liveness to the file
            # watchdog refreshes the heartbeat stamp (and the advertised
            # prefix index) — the two liveness signals cannot drift
            hb_extra = None
            if extra and "prefix_index" in extra:
                hb_extra = {"prefix_index": extra["prefix_index"]}
            self._endpoint.tick(payload["t"], extra=hb_extra)
        path = goodput_lib.beacon_path(self.paths.root, 0)
        try:
            write_json_atomic(path, payload)
        except OSError:
            pass  # telemetry: never fail a tick

    def close(self) -> None:
        if self._endpoint is not None:
            self._endpoint.close()
            self._endpoint = None

    def write_sidecar(self, extra: Optional[dict] = None) -> None:
        """Clean-exit serving record (aggregate_serving prefers it over
        the post-mortem beacon snapshot)."""
        payload = {"attempt": self.attempt, "replica": self.replica_id,
                   **self.tracker.snapshot()}
        if extra:
            payload.update(extra)
        try:
            write_json_atomic(goodput_lib.serving_record_path(
                self.paths.root, self.attempt), payload)
        except OSError:
            pass


# ------------------------------------------------------------- supervisor

class ServingFleet:
    """N supervised replica rings + the hot-swap state machine.

    Each replica runs ``python -m <worker_modname> <worker_argv>
    --fleet_worker_dir <replica_root> --replica_id <i>`` under
    :func:`..parallel.launcher.run_argv_as_distributed` in its own
    thread — restart budget/backoff, crash-loop fail-fast, attempts.jsonl
    and the beacon-mtime hang watchdog all apply per replica. The worker
    module is a parameter (the JAX package's tests drive its fleet with a
    stand-in worker).
    """

    def __init__(self, fleet_dir: str, n_replicas: int,
                 worker_modname: str, worker_argv: Sequence[str], *,
                 devices_per_proc: int = 1,
                 hang_timeout_s: float = 10.0,
                 hang_startup_timeout_s: float = 0.0,
                 max_restarts: int = 3,
                 restart_backoff_s: float = 0.25,
                 restart_backoff_max_s: float = 5.0,
                 monitor_interval: float = 0.05,
                 replica_platform: str = "",
                 transport: str = "file",
                 launch_fn: Optional[Callable[..., int]] = None) -> None:
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        if transport not in ("file", "socket"):
            raise ValueError(f"unknown replica transport {transport!r}")
        self.fleet_dir = os.path.abspath(fleet_dir)
        self.n_replicas = n_replicas
        self.worker_modname = worker_modname
        self.worker_argv = list(worker_argv)
        self.devices_per_proc = devices_per_proc
        # Replica device: "cpu" or "cuda" rides every replica's argv as
        # ``--device`` (appended, so it wins over the shared argv's);
        # "" leaves the worker argv's own --device (run/serve.py resolves
        # --replica_platform auto to the parent's --device before
        # constructing the fleet).
        self.replica_platform = replica_platform
        self.hang_timeout_s = hang_timeout_s
        self.hang_startup_timeout_s = hang_startup_timeout_s
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.monitor_interval = monitor_interval
        self.transport = transport
        self._launch_fn = launch_fn
        self.paths = [ReplicaPaths(self.fleet_dir, i).ensure()
                      for i in range(n_replicas)]
        self._threads: List[Optional[threading.Thread]] = [None] * n_replicas
        self._rcs: List[Optional[int]] = [None] * n_replicas
        self._swap: Optional[dict] = None

    # ------------------------------------------------------------ lifecycle

    def _launch(self):
        if self._launch_fn is not None:
            return self._launch_fn
        from ..parallel.launcher import run_argv_as_distributed
        return run_argv_as_distributed

    def _supervise(self, i: int) -> None:
        argv = self.worker_argv + [
            "--fleet_worker_dir", self.paths[i].root,
            "--replica_id", str(i)]
        if self.replica_platform:
            argv += ["--device", self.replica_platform]
        self._rcs[i] = self._launch()(
            self.worker_modname, argv, nprocs=1,
            devices_per_proc=self.devices_per_proc,
            max_restarts=self.max_restarts,
            monitor_interval=self.monitor_interval,
            log_dir=self.paths[i].log_dir,
            restart_backoff_s=self.restart_backoff_s,
            restart_backoff_max_s=self.restart_backoff_max_s,
            hang_timeout_s=self.hang_timeout_s,
            hang_startup_timeout_s=self.hang_startup_timeout_s,
            extra_env={"DPT_REPLICA": str(i)},
            tag=f"replica{i}")

    def _spawn(self, i: int) -> None:
        t = threading.Thread(target=self._supervise, args=(i,),
                             name=f"fleet-replica-{i}", daemon=True)
        self._threads[i] = t
        t.start()

    def start(self) -> None:
        for i in range(self.n_replicas):
            self._spawn(i)

    def add_replica(self) -> int:
        """Elastic scale-up: append a new supervised replica ring and
        return its rid. The warmup-before-ready contract means the new
        replica takes no traffic until its ``ready.json`` lands — the
        autoscaler gets warm capacity for free. rids are never re-used
        (a scaled-down slot keeps its dir for the goodput fold), so a
        fresh replica can never inherit a dead attempt's ctrl state."""
        rid = self.n_replicas
        p = ReplicaPaths(self.fleet_dir, rid).ensure()
        self.paths.append(p)
        self._threads.append(None)
        self._rcs.append(None)
        self.n_replicas += 1
        self._spawn(rid)
        return rid

    def stop_replica(self, rid: int) -> None:
        """Graceful per-replica stop (scale-down): the stop flag makes
        the worker drain and exit 0, ending its supervising ring. Call
        only after the router has drained placement off the replica."""
        try:
            with open(self.paths[rid].stop_path, "w") as f:
                f.write(str(time.time()))
        except OSError:
            pass

    def alive(self, rid: int) -> bool:
        t = self._threads[rid]
        return t is not None and t.is_alive()

    def rc(self, rid: int) -> Optional[int]:
        return self._rcs[rid]

    def client(self, rid: int) -> ReplicaClient:
        alive_fn = (lambda rid=rid: self.alive(rid))
        if self.transport == "socket":
            return SocketReplicaClient(self.paths[rid], alive_fn=alive_fn)
        return FileReplicaClient(self.paths[rid], alive_fn=alive_fn)

    def clients(self) -> Dict[int, ReplicaClient]:
        return {i: self.client(i) for i in range(self.n_replicas)}

    def stop(self, join_timeout_s: float = 30.0) -> List[Optional[int]]:
        """Graceful shutdown: stop flags make workers drain and exit 0,
        which ends their supervising rings. A replica that never comes up
        again (budget exhausted -> thread already dead) is fine: the
        flag file is simply never read."""
        for p in self.paths:
            try:
                with open(p.stop_path, "w") as f:
                    f.write(str(time.time()))
            except OSError:
                pass
        deadline = time.monotonic() + join_timeout_s
        for t in self._threads:
            if t is not None:
                t.join(timeout=max(0.1, deadline - time.monotonic()))
        return list(self._rcs)

    def ready_replicas(self) -> List[int]:
        out = []
        for i, p in enumerate(self.paths):
            if self.alive(i) and read_json_file(p.ready_path) is not None:
                out.append(i)
        return out

    # -------------------------------------------------------------- hot-swap

    def begin_hot_swap(self, checkpoint_dir: str, step: int = 0, *,
                       drain_timeout_s: float = 60.0,
                       swap_timeout_s: float = 120.0,
                       injector=None) -> dict:
        """Arm the rolling swap; drive it with :meth:`step_swap` from the
        SAME loop that runs the router (the swap must not block traffic —
        that is the whole zero-downtime point). ``step == 0`` targets the
        newest finalized checkpoint at arm time. ``injector`` gets the
        :meth:`~..chaos.inject.ChaosInjector.on_swap` hook (the
        ``corrupt_swap_checkpoint`` fault fires here, BEFORE the canary
        loads)."""
        if self._swap is not None:
            raise RuntimeError("a hot-swap is already in progress")
        if step:
            target = checkpoint_target(checkpoint_dir, step)
            if not os.path.isfile(target):
                raise FileNotFoundError(f"swap target {target} not found")
        else:
            target = find_newest_finalized(checkpoint_dir)
            if target is None:
                raise FileNotFoundError(
                    f"no finalized model_*.pt checkpoint under "
                    f"{checkpoint_dir}")
            step = int(os.path.basename(target)[len("model_"):-len(".pt")])
        injected = bool(injector.on_swap(target)) if injector else False
        order = self.ready_replicas()
        if not order:
            # nothing can canary-validate the target: completing would
            # pin a never-loaded checkpoint fleet-wide (and a corrupt
            # one would crash-loop every future respawn)
            raise RuntimeError("hot-swap: no ready replica to canary the "
                               "target — retry once the fleet is up")
        self._swap = {
            "id": int(time.time() * 1000) % (10 ** 12),
            "dir": checkpoint_dir, "target": target, "step": step,
            "order": order, "pos": 0, "phase": "drain",
            "t_phase": time.monotonic(),
            "drain_timeout_s": drain_timeout_s,
            "swap_timeout_s": swap_timeout_s,
            "injected": injected,
            "swapped": [],          # rids already on the new version
            "old_steps": {},        # rid -> pre-swap params_step
            "windows": {},          # rid -> [t_drain0, t_done] wall clock
            "rollback": [],         # rids still to roll back on abort
        }
        return {"target": target, "step": step, "order": list(order),
                "injected": injected}

    @property
    def swap_active(self) -> bool:
        return self._swap is not None

    def _finish_swap(self, router, ok: bool, error: str = "") -> dict:
        sw = self._swap
        assert sw is not None
        for rid in sw["order"]:
            router.set_draining(rid, False)
        # remove the command files so a replica respawned later can never
        # re-observe an aborted (or stale) swap command
        for rid in sw["order"]:
            for path in (self.paths[rid].swap_path,):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        if ok and sw["swapped"]:
            # pin EVERY replica — including one that was mid-restart and
            # therefore absent from the swap order: when it comes back,
            # startup reads the pin and loads the NEW version instead of
            # resurrecting pre-swap weights (version skew). Gated on at
            # least one replica having actually VALIDATED the target
            # (loaded + acked), so a degenerate roll can never pin an
            # unproven checkpoint fleet-wide.
            for p in self.paths:
                write_json_atomic(p.current_path, {
                    "dir": sw["dir"], "step": sw["step"],
                    "target": sw["target"]})
        report = {
            "ok": ok, "error": error, "step": sw["step"],
            "target": sw["target"], "injected": sw["injected"],
            "swapped": list(sw["swapped"]),
            "windows": {str(k): v for k, v in sw["windows"].items()},
        }
        if sw.get("rollback_failed"):
            # residual skew an aborted roll could not undo: these
            # replicas still serve the new weights (pins kept truthful)
            report["rollback_failed"] = list(sw["rollback_failed"])
        self._swap = None
        return report

    def step_swap(self, router) -> Optional[dict]:
        """Advance the rolling swap one poll; returns the final report
        when the swap completes or aborts, else None. Exactly ONE replica
        is ever draining/loading — every other replica keeps serving, so
        the fleet never drops below N-1 serving replicas."""
        sw = self._swap
        if sw is None:
            return None
        now = time.monotonic()
        if sw["phase"] == "rollback":
            return self._step_rollback(router, now)
        if sw["pos"] >= len(sw["order"]):
            # a replica that was mid-restart when the roll was planned
            # and became ready since gets appended and rolled too —
            # otherwise it would keep serving pre-swap weights (skew)
            late = [r for r in self.ready_replicas()
                    if r not in sw["order"]]
            if not late:
                return self._finish_swap(router, ok=True)
            sw["order"].extend(late)
        rid = sw["order"][sw["pos"]]
        paths = self.paths[rid]
        if not self.alive(rid):
            # the replica died mid-roll; its restart pin (current.json)
            # was not written, so it comes back — if it comes back — on
            # the old version. Treat like a load failure: abort/rollback.
            return self._abort_swap(router, f"replica {rid} died mid-swap")
        if sw["phase"] == "drain":
            router.set_draining(rid, True)
            sw["windows"].setdefault(rid, [time.time(), None])
            if router.outstanding(rid) == 0:
                ready = read_json_file(paths.ready_path) or {}
                sw["old_steps"][rid] = int(ready.get("params_step", 0))
                try:
                    os.unlink(paths.swap_ack_path)
                except OSError:
                    pass
                write_json_atomic(paths.swap_path, {
                    "id": sw["id"], "dir": sw["dir"], "step": sw["step"],
                    "target": sw["target"]})
                sw["phase"], sw["t_phase"] = "load", now
            elif now - sw["t_phase"] > sw["drain_timeout_s"]:
                return self._abort_swap(
                    router, f"replica {rid} drain timed out")
            return None
        # phase == "load": wait for the worker's ack
        ack = read_json_file(paths.swap_ack_path)
        if ack is not None and ack.get("id") == sw["id"]:
            if ack.get("ok"):
                # pin the new version for restarts, then re-open placement
                write_json_atomic(paths.current_path, {
                    "dir": sw["dir"], "step": sw["step"],
                    "target": sw["target"]})
                sw["swapped"].append(rid)
                sw["windows"][rid][1] = time.time()
                router.set_draining(rid, False)
                sw["pos"] += 1
                sw["phase"], sw["t_phase"] = "drain", now
                # completion is decided at the TOP of the next call, so
                # late-ready replicas can still join the roll
                return None
            return self._abort_swap(
                router, f"replica {rid} refused the swap checkpoint: "
                        f"{ack.get('error', '')}")
        if now - sw["t_phase"] > sw["swap_timeout_s"]:
            return self._abort_swap(router, f"replica {rid} swap timed out")
        return None

    def _abort_swap(self, router, error: str) -> Optional[dict]:
        """Abort: the canary ordering guarantees the common case (bad
        checkpoint) aborts with ``swapped == []``. If later replicas had
        already moved (e.g. the target went bad mid-roll), roll them back
        to their pre-swap version so the fleet ends version-consistent."""
        sw = self._swap
        assert sw is not None
        if not sw["swapped"]:
            return self._finish_swap(router, ok=False, error=error)
        sw["phase"] = "rollback"
        sw["error"] = error
        sw["rollback"] = list(sw["swapped"])
        sw["rb_phase"] = "drain"
        sw["t_phase"] = time.monotonic()
        return None

    def _step_rollback(self, router, now: float) -> Optional[dict]:
        sw = self._swap
        assert sw is not None
        if not sw["rollback"]:
            return self._finish_swap(
                router, ok=False,
                error=sw.get("error", "") + " (rolled back)")
        rid = sw["rollback"][0]
        paths = self.paths[rid]
        old_step = sw["old_steps"].get(rid, 0)
        if not self.alive(rid):
            sw["rollback"].pop(0)  # nothing to roll back on a corpse
            return None
        if sw["rb_phase"] == "drain":
            router.set_draining(rid, True)
            if router.outstanding(rid) == 0:
                try:
                    os.unlink(paths.swap_ack_path)
                except OSError:
                    pass
                write_json_atomic(paths.swap_path, {
                    "id": sw["id"] + 1, "dir": sw["dir"], "step": old_step,
                    "target": checkpoint_target(sw["dir"], old_step)})
                sw["rb_phase"], sw["t_phase"] = "load", now
            elif now - sw["t_phase"] > sw["drain_timeout_s"]:
                sw["rollback"].pop(0)  # stuck: give up on this one
            return None
        ack = read_json_file(paths.swap_ack_path)
        if ack is not None and ack.get("id") == sw["id"] + 1:
            if ack.get("ok"):
                try:
                    os.unlink(paths.current_path)  # back on the old pin
                except OSError:
                    pass
                sw["swapped"].remove(rid)
            else:
                # the rollback LOAD failed: the replica still serves the
                # NEW weights — keep its pin (a restart must stay on the
                # version it actually runs) and leave it in `swapped` so
                # the report tells the truth about the residual skew
                sw.setdefault("rollback_failed", []).append(rid)
            router.set_draining(rid, False)
            sw["rollback"].pop(0)
            sw["rb_phase"], sw["t_phase"] = "drain", now
        elif now - sw["t_phase"] > sw["swap_timeout_s"]:
            sw.setdefault("rollback_failed", []).append(rid)
            sw["rollback"].pop(0)
        return None
