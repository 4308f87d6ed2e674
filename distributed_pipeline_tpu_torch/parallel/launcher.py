"""The supervised worker ring: the port of
``distributed_pipeline_tpu/parallel/launcher.py``.

:func:`run_argv_as_distributed` runs ``python -m <module> <argv>`` as a
supervised ring of ``nprocs`` local worker processes. Each worker's
environment carries torch's ``env://`` rendezvous keys (``MASTER_ADDR`` /
``MASTER_PORT`` on a free loopback port, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), the autorun flag
(``DPT_DIST_AUTORUN``) and the run timestamp ``DPT_RUN_TIMESTAMP``, pinned
once for every worker of every attempt so that all ranks and every restart
resolve one auto-generated run dir. ``parallel/dist.py`` joins the
workers into a ``torch.distributed`` process group from those keys. When
a worker dies,

* its SIBLINGS are terminated (they would otherwise block in a collective
  forever; torchrun's elastic-agent behaviour) and the whole ring is
  respawned, with
* an EXPONENTIAL BACKOFF between attempts (``restart_backoff_s`` doubling
  per consecutive failure, capped by ``restart_backoff_max_s``),
* a RESTART-RATE BUDGET (``max_restarts`` per sliding ``restart_window_s``
  window — not a lifetime counter, :class:`_RestartBudget`),
* CRASH-LOOP fail-fast (two consecutive failed attempts with zero progress,
  :func:`_crash_looping`),
* the HANG WATCHDOG: the workers' progress beacons (``chaos/goodput``'s
  ``.progress_rank*.json``) double as the liveness signal; once the
  attempt writes its first beacon the watchdog arms, and a beacon that
  freezes for ``hang_timeout_s`` gets the ring SIGKILLed (optionally also
  one that never writes a first beacon within ``hang_startup_timeout_s``),
* a structured record per attempt appended to ``attempts.jsonl`` in the
  run dir (:func:`_harvest_attempt`), which the workers name through the
  ``DPT_RUN_DIR_FILE`` handshake.

``DPT_FORCE_NPROCS`` (a per-attempt schedule, ``"2,1"``) makes an attempt
respawn at another world size; the trainer then resumes by global samples
consumed. :func:`parse_and_autorun` is the entry points' ``--distributed``
flag: ``--distributed --nprocs N`` relaunches the running module as such a
ring and exits with its code. The multi-host in-process path
(``--coordinator_address``, ``--num_processes``, ``--process_id``) is not
ported (ROADMAP A.8g).

The serving fleet runs one ring of one process per replica, each in a
thread of the fleet parent; this module imports no torch. Its log lines go
to stderr (the fleet's stdout carries only its JSON summary). The JAX
launcher pins the worker's backend through ``JAX_PLATFORMS``; the port's
workers take their device from their own ``--device`` flag.
"""

from __future__ import annotations

import argparse
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..chaos import goodput as goodput_lib
from ..obs import trace as trace_lib

__all__ = ["run_argv_as_distributed", "find_free_port",
           "create_distributed_parser", "parse_distributed_args",
           "parse_and_autorun", "get_main_modname",
           "parse_capacity_schedule", "AUTORUN_ENV_FLAG",
           "FORCE_NPROCS_ENV", "RUN_TIMESTAMP_ENV"]

# Set on every spawned worker (the reference's DIST_UTIL_AUTORUN_FLAG):
# ``parallel/dist.py`` takes it as a launch to join.
AUTORUN_ENV_FLAG = "DPT_DIST_AUTORUN"
# The run timestamp every worker of every attempt resolves its run dir with
RUN_TIMESTAMP_ENV = "DPT_RUN_TIMESTAMP"
# Per-attempt world-size schedule: "2,1" = attempt 0 at 2 workers, every
# later attempt at 1 (on one host the env is the capacity probe)
FORCE_NPROCS_ENV = "DPT_FORCE_NPROCS"


def _ephemeral_low() -> int:
    """The low end of the kernel's ephemeral port range (32768 when it
    cannot be read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _bound_port(port: int) -> Optional[int]:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        return s.getsockname()[1]
    except OSError:
        return None
    finally:
        s.close()


def find_free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago,
    drawn below the kernel's ephemeral range: a port from that range can
    be handed to an outgoing connection (gloo opens many) between this
    check and the rendezvous's bind."""
    low = _ephemeral_low()
    if low > 2048:
        pick = random.Random()
        for _ in range(64):
            port = _bound_port(pick.randrange(low // 2, low))
            if port is not None:
                return port
    return _bound_port(0)


def parse_capacity_schedule(text: str) -> Optional[List[int]]:
    """``"2,1"`` -> [2, 1]; empty -> None. Raises on a malformed or
    non-positive entry: an override that is silently ignored would run the
    wrong topology."""
    if not text:
        return None
    out = []
    for tok in text.split(","):
        tok = tok.strip()
        if not tok.isdigit() or int(tok) < 1:
            raise ValueError(f"capacity schedule entries must be positive "
                             f"ints, got {tok!r} in {text!r}")
        out.append(int(tok))
    return out


def _capacity_at(schedule: Optional[List[int]], attempt: int,
                 default: int) -> int:
    if not schedule:
        return default
    return schedule[min(attempt, len(schedule) - 1)]


def _worker_env(rank: int, nprocs: int, port: int,
                extra_env: Optional[dict] = None,
                run_timestamp: str = "") -> dict:
    """Environment for spawned worker ``rank``: the caller's environment,
    torch's ``env://`` rendezvous keys, the autorun flag, the pinned run
    timestamp, ``OMP_NUM_THREADS`` (the host's cores over the ranks,
    unless the caller set it), and the supervision channel (``DPT_ATTEMPT`` /
    ``DPT_SPAWN_T`` / ``DPT_RUN_DIR_FILE`` ride ``extra_env``:
    launcher-owned keys win over anything inherited)."""
    env = dict(os.environ)
    if run_timestamp:
        env[RUN_TIMESTAMP_ENV] = run_timestamp
    if nprocs > 1 and "OMP_NUM_THREADS" not in env:
        # the host's cores split over the ranks (torchrun's default too):
        # ranks that each spin a thread per core stall one another at
        # every collective
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1)
                                         // nprocs))
    env.update({
        AUTORUN_ENV_FLAG: "1",
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port),
        "WORLD_SIZE": str(nprocs),
        "RANK": str(rank),
        "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(nprocs),
    })
    env.update(extra_env or {})
    return env


def _tee_pump(proc: subprocess.Popen, sink, prefix: str
              ) -> threading.Thread:
    """A daemon thread copying one worker's piped output to its log file
    and to this process's stderr, each line prefixed (torchrun's ``-t``
    tee). The log always gets the line; a broken console only stops the
    echo (stopping the pump would block the worker on a full pipe)."""

    def pump() -> None:
        echo = True
        for line in iter(proc.stdout.readline, b""):
            sink.write(line)
            sink.flush()
            if echo:
                try:
                    sys.stderr.write(
                        f"{prefix} {line.decode(errors='replace')}")
                    sys.stderr.flush()
                except (ValueError, OSError):
                    echo = False

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


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
                     log_tee: bool = False, run_timestamp: str = "",
                     attempt: int = 0, extra_env: Optional[dict] = None,
                     hang_timeout_s: float = 0.0,
                     hang_startup_timeout_s: float = 0.0,
                     run_dir_file: str = "",
                     status: Optional[dict] = None, tag: str = "") -> int:
    """One attempt: spawn the ring, poll liveness and the hang watchdog;
    when any worker exits non-zero, terminate its siblings (they would
    block in a collective forever). Returns the first non-zero exit code
    (negative for a signal), else 0. ``status`` (a
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
    tees: List[threading.Thread] = []
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        mode = "tee'd to stderr and" if log_tee else "->"
        print(f"{label} per-worker output {mode} {log_dir}/worker_N.log",
              file=sys.stderr, flush=True)
    procs: List[subprocess.Popen] = []
    codes: List[Optional[int]] = []
    try:
        for i in range(nprocs):
            env = _worker_env(i, nprocs, port, extra_env, run_timestamp)
            if log_dir:
                # append: a restarted ring continues the same file, with an
                # attempt header as the boundary
                f = open(os.path.join(log_dir, f"worker_{i}.log"), "ab")
                f.write(f"[launcher] attempt {attempt}\n".encode())
                f.flush()
                logs.append(f)
                if log_tee:
                    p = subprocess.Popen(cmd_base, env=env,
                                         stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT)
                    procs.append(p)
                    tees.append(_tee_pump(p, f, f"[worker {i}]"))
                else:
                    procs.append(subprocess.Popen(
                        cmd_base, env=env, stdout=f,
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
        for t in tees:
            t.join(timeout=5)
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
                            tag: str = "", log_tee: bool = False) -> int:
    """Run ``python -m modname script_argv`` as a supervised ring of
    ``nprocs`` worker processes; returns the final attempt's exit code.

    Between attempts: exponential backoff, the sliding-window restart
    budget, crash-loop fail-fast, and one ``attempts.jsonl`` record per
    attempt (rc, duration, downtime, progress, hang window, world size,
    post-mortem snapshot). An attempt's world size comes from the
    ``DPT_FORCE_NPROCS`` schedule when it is set, else ``nprocs``.
    ``extra_env`` reaches every worker of every attempt (launcher-owned
    keys win); ``log_dir`` captures worker i's output to
    ``worker_{i}.log`` (appended across attempts), and ``log_tee`` also
    echoes it to stderr; ``tag`` prefixes this supervisor's log lines, so
    rings supervised concurrently from one process stay attributable.
    Thread-safe: all state is local, and the run-dir handshake file is a
    fresh tempfile per call. ``devices_per_proc`` is recorded in the
    attempt records."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    cmd_base = [sys.executable, "-m", modname, *script_argv]
    # one timestamp for every worker of every attempt (the workers' env
    # only: this process's environ stays as it was, so a second launch
    # from it mints its own)
    run_timestamp = (os.environ.get(RUN_TIMESTAMP_ENV)
                     or time.strftime("%Y%m%d-%H%M%S"))
    # parsed once, so a malformed schedule fails the launch, not attempt 3
    nprocs_sched = parse_capacity_schedule(
        os.environ.get(FORCE_NPROCS_ENV, ""))
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
            nprocs_a = _capacity_at(nprocs_sched, attempt, nprocs)
            if nprocs_a != nprocs:
                print(f"{label} attempt {attempt}: capacity override -> "
                      f"{nprocs_a} worker(s) (was {nprocs})",
                      file=sys.stderr, flush=True)
            ring_status: dict = {}
            code = _run_worker_ring(
                cmd_base, nprocs_a, monitor_interval, log_dir=log_dir,
                log_tee=log_tee, run_timestamp=run_timestamp,
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
                prev_max_step, ring_status=ring_status, nprocs=nprocs_a,
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
                          "nprocs": nprocs_a,
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


def create_distributed_parser() -> argparse.ArgumentParser:
    """The launcher's own flags (the JAX launcher's, less the multi-host
    and fake-device ones). ``--devices_per_proc`` is recorded in the
    attempt records only: each worker takes one device."""
    # allow_abbrev=False: parse_known_args must not take a prefix of a
    # script flag for a launcher flag
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--distributed", action="store_true",
                   help="launch a multi-process run (with --nprocs N) or "
                        "join the one the environment describes")
    p.add_argument("--nprocs", type=int, default=0,
                   help="spawn N local worker processes joined in one "
                        "torch.distributed process group")
    p.add_argument("--devices_per_proc", type=int, default=1,
                   help="recorded in attempts.jsonl; each worker runs on "
                        "one device")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="respawn the ring after a failure at most this many "
                        "times per sliding --restart_window_s window; "
                        "checkpoint auto-resume continues the run")
    p.add_argument("--restart_window_s", type=float, default=3600.0,
                   help="sliding window of the --max_restarts budget; <= 0 "
                        "counts restarts over the whole run")
    p.add_argument("--restart_backoff_s", type=float, default=1.0,
                   help="base seconds of exponential backoff between "
                        "attempts (doubling per consecutive failure); 0 "
                        "disables")
    p.add_argument("--restart_backoff_max_s", type=float, default=30.0,
                   help="cap on the restart backoff")
    p.add_argument("--monitor_interval", type=float, default=0.2,
                   help="seconds between worker liveness polls")
    p.add_argument("--hang_timeout_s", type=float, default=0.0,
                   help="kill the ring when no rank's progress beacon "
                        "advances for this many seconds after the first "
                        "one; 0 disables")
    p.add_argument("--hang_startup_timeout_s", type=float, default=0.0,
                   help="kill an attempt that writes no beacon within this "
                        "many seconds of its spawn; 0 disables")
    p.add_argument("--log_dir", default="",
                   help="capture worker i's stdout and stderr to "
                        "{log_dir}/worker_{i}.log (restarts append)")
    p.add_argument("--log_tee", action="store_true",
                   help="with --log_dir, also echo each worker's output to "
                        "stderr, '[worker N]'-prefixed")
    return p


def parse_distributed_args(argv: Optional[Sequence[str]] = None
                           ) -> Tuple[argparse.Namespace, List[str]]:
    """Split argv into (the launcher's namespace, the script's argv)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    return create_distributed_parser().parse_known_args(argv)


def get_main_modname() -> Optional[str]:
    """The running ``__main__``'s module name, for relaunching it with
    ``-m``; None when it was not run as a module."""
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    if spec is None or not spec.name:
        return None
    name = spec.name
    return name[:-len(".__main__")] if name.endswith(".__main__") else name


def parse_and_autorun(parse: Callable[[List[str]], Any],
                      argv: Optional[Sequence[str]] = None,
                      modname: Optional[str] = None) -> Any:
    """The entry points' launcher: with ``--distributed --nprocs N``, run
    ``modname`` (default: the running module) as a supervised ring of N
    workers on the rest of argv and exit with the ring's code; otherwise
    return ``parse(script_argv)``. A worker (or a plain run) parses its
    argv with the launcher's flags taken out; ``--distributed`` without
    ``--nprocs`` joins the process group the environment describes
    (``parallel/dist.py``), or runs as one process when there is none."""
    ns, script_argv = parse_distributed_args(argv)
    if ns.distributed and ns.nprocs >= 1:
        modname = modname or get_main_modname()
        if modname is None:
            raise RuntimeError("--distributed --nprocs relaunches the entry "
                               "point as a module: run it with python -m")
        sys.exit(run_argv_as_distributed(
            modname, script_argv, ns.nprocs, ns.devices_per_proc,
            max_restarts=ns.max_restarts,
            monitor_interval=ns.monitor_interval, log_dir=ns.log_dir,
            log_tee=ns.log_tee, restart_window_s=ns.restart_window_s,
            restart_backoff_s=ns.restart_backoff_s,
            restart_backoff_max_s=ns.restart_backoff_max_s,
            hang_timeout_s=ns.hang_timeout_s,
            hang_startup_timeout_s=ns.hang_startup_timeout_s))
    return parse(script_argv)
