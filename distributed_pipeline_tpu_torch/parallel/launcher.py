"""The supervised worker ring for one process: the port of
``run_argv_as_distributed`` in ``distributed_pipeline_tpu/parallel/
launcher.py``.

:func:`run_argv_as_distributed` runs ``python -m <module> <argv>`` as a
supervised ring: when the worker dies, it is respawned, with

* an EXPONENTIAL BACKOFF between attempts (``restart_backoff_s`` doubling
  per consecutive failure, capped by ``restart_backoff_max_s``),
* a RESTART-RATE BUDGET (``max_restarts`` per sliding ``restart_window_s``
  window — not a lifetime counter, :class:`_RestartBudget`),
* CRASH-LOOP fail-fast (two consecutive failed attempts with zero progress,
  :func:`_crash_looping`),
* the HANG WATCHDOG: the worker's progress beacons (``chaos/goodput``'s
  ``.progress_rank*.json``) double as its liveness signal; once the
  attempt writes its first beacon the watchdog arms, and a beacon that
  freezes for ``hang_timeout_s`` gets the worker SIGKILLed (optionally
  also one that never writes a first beacon within
  ``hang_startup_timeout_s``),
* a structured record per attempt appended to ``attempts.jsonl`` in the
  worker's run dir (:func:`_harvest_attempt`), which the worker names
  through the ``DPT_RUN_DIR_FILE`` handshake.

The serving fleet runs one such ring per replica, each in a thread of the
fleet parent; this module imports no torch. Its log lines go to stderr
(the fleet's stdout carries only its JSON summary). ``nprocs`` must be 1:
a ring of several processes needs the ``torch.distributed`` rendezvous,
which comes with multi-GPU training (ROADMAP A.8). The worker's environment
carries torch's ``env://`` keys (``MASTER_ADDR``/``MASTER_PORT`` on a free
local port, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) for that item. The
JAX launcher pins the worker's backend through ``JAX_PLATFORMS``; the
port's workers take their device from their own ``--device`` flag, which
rides the worker argv (``serving/fleet.py``).
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..chaos import goodput as goodput_lib
from ..obs import trace as trace_lib

__all__ = ["run_argv_as_distributed", "find_free_port"]


def find_free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _worker_env(rank: int, nprocs: int, port: int,
                extra_env: Optional[dict] = None) -> dict:
    """Environment for spawned worker ``rank``: the caller's environment,
    torch's ``env://`` rendezvous keys, and the supervision channel
    (``DPT_ATTEMPT`` / ``DPT_SPAWN_T`` / ``DPT_RUN_DIR_FILE`` ride
    ``extra_env``: launcher-owned keys win over anything inherited)."""
    env = dict(os.environ)
    env.update({
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port),
        "WORLD_SIZE": str(nprocs),
        "RANK": str(rank),
        "LOCAL_RANK": str(rank),
    })
    env.update(extra_env or {})
    return env


def _beacon_mtimes(run_dir_file: str) -> Optional[Dict[str, float]]:
    """mtime per progress beacon in the run dir named by the handshake
    file, or None when the dir (or any beacon) isn't known yet. mtime is
    the liveness signal: the worker atomically replaces its beacon every
    tick, so a frozen newest-mtime means the worker is not advancing."""
    try:
        with open(run_dir_file) as f:
            run_dir = f.read().strip()
    except OSError:
        return None
    if not run_dir or not os.path.isdir(run_dir):
        return None
    return goodput_lib.beacon_mtimes(run_dir) or None


def _run_worker_ring(cmd_base: List[str], nprocs: int,
                     monitor_interval: float, log_dir: str = "",
                     attempt: int = 0, extra_env: Optional[dict] = None,
                     hang_timeout_s: float = 0.0,
                     hang_startup_timeout_s: float = 0.0,
                     run_dir_file: str = "",
                     status: Optional[dict] = None, tag: str = "") -> int:
    """One attempt: spawn the worker, poll liveness and the hang watchdog.
    Returns the worker's exit code (negative for a signal). ``status`` (a
    caller-provided dict) receives ``hung``/``hang_s``/``hang_kind`` when
    the watchdog kills the attempt, so its record books the wasted window
    to the ``hang`` goodput category."""
    port = find_free_port()
    label = f"[launcher{' ' + tag if tag else ''}]"
    print(f"{label} attempt {attempt}: spawning {nprocs} local worker(s)",
          file=sys.stderr, flush=True)
    print(f"{label} worker cmd: {' '.join(cmd_base)}", file=sys.stderr,
          flush=True)
    logs = []
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        print(f"{label} per-worker output -> {log_dir}/worker_N.log",
              file=sys.stderr, flush=True)
    procs: List[subprocess.Popen] = []
    codes: List[Optional[int]] = []
    try:
        for i in range(nprocs):
            env = _worker_env(i, nprocs, port, extra_env)
            if log_dir:
                # append: a restarted ring continues the same file, with an
                # attempt header as the boundary
                f = open(os.path.join(log_dir, f"worker_{i}.log"), "ab")
                f.write(f"[launcher] attempt {attempt}\n".encode())
                f.flush()
                logs.append(f)
                procs.append(subprocess.Popen(cmd_base, env=env, stdout=f,
                                              stderr=subprocess.STDOUT))
            else:
                procs.append(subprocess.Popen(cmd_base, env=env))
        codes = [None] * len(procs)
        # Hang-watchdog state: armed by this attempt's first beacon write
        # (beacon mtime >= spawn wall-clock — earlier attempts' stale
        # beacons never arm it), re-anchored by every later advance.
        t_spawn_wall = time.time()
        t_start = time.monotonic()
        hang_armed = False
        last_advance = t_start
        last_max_mtime = 0.0
        next_hang_poll = 0.0
        watch = hang_timeout_s > 0 or hang_startup_timeout_s > 0
        while any(c is None for c in codes):
            for i, p in enumerate(procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                print(f"{label} worker(s) {failed} exited with "
                      f"{[codes[i] for i in failed]}", file=sys.stderr,
                      flush=True)
                for i, p in enumerate(procs):
                    if codes[i] is None:
                        p.terminate()
                for i, p in enumerate(procs):
                    if codes[i] is None:
                        try:
                            codes[i] = p.wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            p.kill()
                            codes[i] = p.wait()
                break
            now = time.monotonic()
            if watch and run_dir_file and now >= next_hang_poll:
                # beacon stat()s are cheap but not free: throttle the
                # probe independently of the (snappier) liveness poll
                next_hang_poll = now + max(monitor_interval, 0.1)
                mtimes = _beacon_mtimes(run_dir_file)
                mx = max(mtimes.values()) if mtimes else 0.0
                if mx > last_max_mtime:
                    last_max_mtime = mx
                    if mx >= t_spawn_wall - 1e-3:  # THIS attempt's write
                        hang_armed = True
                        last_advance = now
                hung_kind = ""
                if hang_armed and hang_timeout_s > 0 \
                        and now - last_advance > hang_timeout_s:
                    hung_kind = "stall"
                elif not hang_armed and hang_startup_timeout_s > 0 \
                        and now - t_start > hang_startup_timeout_s:
                    hung_kind = "startup"
                if hung_kind:
                    hang_s = now - (last_advance if hang_armed else t_start)
                    what = ("no first beacon" if hung_kind == "startup"
                            else "beacons frozen")
                    print(f"{label} hang watchdog: no progress for "
                          f"{hang_s:.1f}s ({what}); SIGKILLing the worker",
                          file=sys.stderr, flush=True)
                    if status is not None:
                        status.update({"hung": True,
                                       "hang_s": round(hang_s, 3),
                                       "hang_kind": hung_kind})
                    for i, p in enumerate(procs):
                        if codes[i] is None:
                            try:
                                p.send_signal(signal.SIGKILL)
                            except OSError:
                                pass  # died between poll and kill
                    for i, p in enumerate(procs):
                        if codes[i] is None:
                            codes[i] = p.wait()
                    break
            time.sleep(max(monitor_interval, 0.02))
    except BaseException:
        # KeyboardInterrupt or a spawn-phase failure: nothing supervises
        # the ring anymore — tear it down rather than leak workers.
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        raise
    finally:
        for f in logs:
            f.close()
    # any nonzero code fails the attempt (a signal-killed worker's code is
    # negative, so max() would hide it behind a sibling's 0)
    return next((c for c in codes if c not in (None, 0)), 0)


class _RestartBudget:
    """R restarts per sliding window, not a lifetime counter: a long run
    legitimately restarts many times — what must be stopped is a tight
    crash loop. ``window_s <= 0`` restores lifetime counting (every
    restart counts forever)."""

    def __init__(self, max_restarts: int, window_s: float,
                 now=time.monotonic) -> None:
        self.max_restarts = max_restarts
        self.window_s = window_s
        self._now = now
        self._stamps: List[float] = []

    def spent(self) -> int:
        if self.window_s > 0:
            cutoff = self._now() - self.window_s
            self._stamps = [t for t in self._stamps if t >= cutoff]
        return len(self._stamps)

    def allows_restart(self) -> bool:
        return self.spent() < self.max_restarts

    def charge(self) -> None:
        self._stamps.append(self._now())


def _crash_looping(records: List[dict]) -> bool:
    """Two consecutive FAILED attempts with zero progress: the ring is not
    recovering, it is burning restarts — stop now rather than when the
    budget runs out. Attempts whose progress is unknown (no beacons) never
    trigger this."""
    if len(records) < 2:
        return False
    for rec in records[-2:]:
        if rec.get("rc", 1) == 0 or rec.get("steps") is None \
                or rec.get("steps", 0) > 0:
            return False
    return True


def _harvest_attempt(run_dir_file: str, attempt: int, rc: int,
                     t_spawn: float, t_exit: float, prev_t_exit: float,
                     prev_max_step: Optional[int],
                     ring_status: Optional[dict] = None,
                     nprocs: Optional[int] = None,
                     devices_per_proc: Optional[int] = None
                     ) -> Tuple[dict, Optional[str]]:
    """Build the structured per-attempt record and locate the run dir.

    The run dir is learned through the handshake file the worker writes
    (``DPT_RUN_DIR_FILE``; a serving replica's ``WorkerProtocol`` stamps
    its replica dir into it). Progress and the post-mortem snapshot (a
    training ``goodput`` one or a serving one) come from the beacons in
    that dir."""
    run_dir: Optional[str] = None
    try:
        with open(run_dir_file) as f:
            run_dir = f.read().strip() or None
    except OSError:
        run_dir = None
    end_step: Optional[int] = None
    start_step = prev_max_step
    beacon_goodput = None
    serving_snap = None
    stage = None
    resume_overhead = None
    recompiles = steady_recompiles = None
    if run_dir and os.path.isdir(run_dir):
        beacons = goodput_lib.read_beacons(run_dir)
        ours = {r: b for r, b in beacons.items()
                if int(b.get("attempt", 0)) == attempt}
        if beacons and not ours:
            # The ring IS beacon-capable (earlier attempts reported), but
            # this attempt died before its first beacon — that is zero
            # progress, not unknown progress: the crash-loop fail-fast
            # must see it.
            end_step = prev_max_step or 0
        if ours:
            end_step = max(int(b.get("step", 0)) for b in ours.values())
            # progress is measured against the step THIS attempt started
            # from (the beacon's start_step), not the high-water mark
            starts = [int(b["start_step"]) for b in ours.values()
                      if b.get("start_step") is not None]
            if starts:
                start_step = min(starts)
            b0 = ours.get(0) or next(iter(ours.values()))
            beacon_goodput = b0.get("goodput")
            # serving replicas beacon a `serving` snapshot instead of a
            # training goodput one: a killed replica attempt keeps its
            # flight recorder (aggregate_serving falls back to it when no
            # clean-exit sidecar exists)
            snap = b0.get("serving")
            serving_snap = snap if isinstance(snap, dict) else None
            stage = b0.get("stage")
            recompiles = b0.get("recompile_count")
            steady_recompiles = b0.get("steady_recompile_count")
            if isinstance(beacon_goodput, dict):
                resume_overhead = (beacon_goodput.get("startup_s", 0.0)
                                   + beacon_goodput.get("restore_s", 0.0)
                                   + beacon_goodput.get("compile_s", 0.0))
    steps = (None if end_step is None
             else max(0, end_step - (start_step or 0)))
    record = {
        "attempt": attempt,
        "rc": rc,
        "t_spawn": round(t_spawn, 3),
        "t_exit": round(t_exit, 3),
        "duration_s": round(t_exit - t_spawn, 3),
        "downtime_s": round(max(0.0, t_spawn - prev_t_exit), 3)
        if prev_t_exit else 0.0,
        "start_step": start_step,
        "end_step": end_step,
        "steps": steps,
        "resume_overhead_s": (round(resume_overhead, 3)
                              if resume_overhead is not None else None),
        "recompile_count": recompiles,
        "steady_recompile_count": steady_recompiles,
        "goodput": beacon_goodput,
    }
    if serving_snap is not None:
        record["serving"] = serving_snap
    if stage is not None:
        record["stage"] = stage
    if nprocs is not None:
        record["nprocs"] = nprocs
        record["devices_per_proc"] = devices_per_proc
    if ring_status and ring_status.get("hung"):
        # Watchdog kill: the frozen window is measured, bounded waste —
        # its own goodput category (hang), not anonymous lost time.
        record["hung"] = True
        record["hang_s"] = ring_status.get("hang_s", 0.0)
        record["hang_kind"] = ring_status.get("hang_kind", "stall")
    return record, run_dir


def run_argv_as_distributed(modname: str, script_argv: Sequence[str],
                            nprocs: int = 1, devices_per_proc: int = 1,
                            max_restarts: int = 0,
                            monitor_interval: float = 0.2,
                            log_dir: str = "",
                            restart_window_s: float = 3600.0,
                            restart_backoff_s: float = 1.0,
                            restart_backoff_max_s: float = 30.0,
                            hang_timeout_s: float = 0.0,
                            hang_startup_timeout_s: float = 0.0,
                            extra_env: Optional[dict] = None,
                            tag: str = "") -> int:
    """Run ``python -m modname script_argv`` as a supervised ring of one
    worker process; returns the final attempt's exit code.

    Between attempts: exponential backoff, the sliding-window restart
    budget, crash-loop fail-fast, and one ``attempts.jsonl`` record per
    attempt (rc, duration, downtime, progress, hang window, post-mortem
    snapshot). ``extra_env`` reaches the worker of every attempt
    (launcher-owned keys win); ``log_dir`` captures the worker's output
    to ``worker_0.log`` (appended across attempts); ``tag`` prefixes this
    supervisor's log lines, so rings supervised concurrently from one
    process stay attributable. Thread-safe: all state is local, and the
    run-dir handshake file is a fresh tempfile per call.
    ``devices_per_proc`` is recorded in the attempt records."""
    if nprocs != 1:
        raise NotImplementedError(
            f"nprocs={nprocs}: a ring of several processes needs the "
            f"torch.distributed rendezvous, which comes with multi-GPU "
            f"training (ROADMAP A.8); the supervised ring runs one process")
    cmd_base = [sys.executable, "-m", modname, *script_argv]
    budget = _RestartBudget(max_restarts, restart_window_s)
    fd, run_dir_file = tempfile.mkstemp(prefix="dpt_run_dir_")
    os.close(fd)
    label = f"[launcher{' ' + tag if tag else ''}]"
    records: List[dict] = []
    attempt = 0
    consecutive_failures = 0
    prev_t_exit = 0.0
    prev_max_step: Optional[int] = None
    # Supervision trace (obs/, armed by DPT_TRACE): attempt spans, backoff
    # windows, and watchdog kills land in trace_launcher*.jsonl in the run
    # dir — created lazily once the worker handshake reveals the dir.
    tracer: Any = trace_lib.NULL
    try:
        while True:
            t_spawn = time.time()
            ring_status: dict = {}
            code = _run_worker_ring(
                cmd_base, nprocs, monitor_interval, log_dir=log_dir,
                attempt=attempt,
                extra_env={**(extra_env or {}),
                           "DPT_ATTEMPT": str(attempt),
                           "DPT_SPAWN_T": repr(t_spawn),
                           "DPT_RUN_DIR_FILE": run_dir_file},
                hang_timeout_s=hang_timeout_s,
                hang_startup_timeout_s=hang_startup_timeout_s,
                run_dir_file=run_dir_file, status=ring_status, tag=tag)
            t_exit = time.time()
            record, run_dir = _harvest_attempt(
                run_dir_file, attempt, code, t_spawn, t_exit, prev_t_exit,
                prev_max_step, ring_status=ring_status, nprocs=nprocs,
                devices_per_proc=devices_per_proc)
            records.append(record)
            if run_dir and os.path.isdir(run_dir):
                try:
                    goodput_lib.append_attempt(run_dir, record)
                except OSError as e:
                    print(f"{label} attempts.jsonl write failed: {e}",
                          file=sys.stderr, flush=True)
                if tracer is trace_lib.NULL:
                    tracer = trace_lib.tracer_for(
                        run_dir, f"launcher_{tag}" if tag else "launcher")
            if tracer.enabled:
                tracer.complete(
                    f"attempt {attempt}", "supervise", t_spawn,
                    t_exit - t_spawn,
                    args={"rc": code, "steps": record["steps"],
                          "nprocs": nprocs,
                          "devices_per_proc": devices_per_proc})
                if ring_status.get("hung"):
                    tracer.instant(
                        "watchdog_kill", "supervise", t=t_exit,
                        args={"hang_s": ring_status.get("hang_s"),
                              "kind": ring_status.get("hang_kind")})
            prev_t_exit = t_exit
            if record["end_step"] is not None:
                prev_max_step = max(prev_max_step or 0, record["end_step"])
            if code == 0:
                return 0
            # "consecutive" failures reset when an attempt made progress:
            # a kill after a long healthy stretch is not a crash loop
            if (record["steps"] or 0) > 0:
                consecutive_failures = 1
            else:
                consecutive_failures += 1
            if _crash_looping(records):
                print(f"{label} crash loop: last 2 attempts made zero "
                      f"progress (rc={code}); failing fast instead of "
                      f"burning {max_restarts - budget.spent()} more "
                      f"restart(s)", file=sys.stderr, flush=True)
                return code
            if not budget.allows_restart():
                window = (f"in the last {restart_window_s:.0f}s"
                          if restart_window_s > 0 else "total")
                print(f"{label} ring failed (rc={code}); restart budget "
                      f"exhausted ({budget.spent()}/{max_restarts} "
                      f"{window})", file=sys.stderr, flush=True)
                return code
            budget.charge()
            backoff = 0.0
            if restart_backoff_s > 0:
                backoff = min(restart_backoff_max_s,
                              restart_backoff_s
                              * (2.0 ** (consecutive_failures - 1)))
            attempt += 1
            print(f"{label} ring failed (rc={code}); restart "
                  f"{budget.spent()}/{max_restarts} (window "
                  f"{restart_window_s:.0f}s), backoff {backoff:.1f}s",
                  file=sys.stderr, flush=True)
            if backoff > 0:
                if tracer.enabled:
                    tracer.complete("backoff", "supervise", time.time(),
                                    backoff,
                                    args={"consecutive_failures":
                                          consecutive_failures})
                time.sleep(backoff)
    finally:
        tracer.close()
        try:
            os.unlink(run_dir_file)
        except OSError:
            pass
