"""Host-driven MPMD pipeline driver (torch-free): the port of
``distributed_pipeline_tpu/mpmd/driver.py``.

One process (this one) supervises S stage process groups — each under
its OWN launcher ring (per-stage restart budget, backoff, beacon
hang-watchdog), so stages are independently preemptible — and drives
the training schedule over control links while activations/grads move
stage-to-stage over data links (mpmd/link.py).

Per step: broadcast ``step`` on every cmd link; stages run their local
:func:`~.protocol.schedule_for` order; families with a tied embedding
(gpt2: the word embedding feeds stage 0's lookup AND the last stage's
logit head) route the shared-param grad through the driver (``shared``
res -> summed ``shared_sum`` cmd) before stages apply; every stage
answers ``done`` (the last stage's carries the step loss).

Recovery: a stage death is observed as its ready-file ATTEMPT BUMP
(its own ring respawned it; the worker re-announces with its restored
snapshot step). The driver bumps the link epoch, broadcasts ``rewind``
to ALL stages at ``r = min(ready params_step)``, survivors abort their
in-flight step via the link interrupt and reload their own local
snapshot — a file read, never a process restart — and the schedule
replays from ``r + 1``. Losses are deterministic in (seed, step), so a
replayed step reproduces the original sequence.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..chaos import goodput as goodput_lib
from ..obs import trace as trace_lib
from ..parallel.launcher import run_argv_as_distributed
from .link import FileStageLink
from .protocol import (StagePaths, link_dir, read_ready, write_config)

__all__ = ["PipelineDriver"]

WORKER_MODULE = "distributed_pipeline_tpu_torch.mpmd.stage_worker"
# each stage ring's supervision: how often it polls its process, and the
# backoff before a respawn (doubling per consecutive failure, capped)
MONITOR_INTERVAL_S = 0.05
RESTART_BACKOFF_S = 0.25
RESTART_BACKOFF_MAX_S = 5.0
# how long the driver waits for a step's answers, and for every stage to
# announce it is ready, before it gives up
STEP_TIMEOUT_S = 300.0
READY_TIMEOUT_S = 300.0


class PipelineDriver:
    """Supervise S stage rings and run the host-driven schedule.

    ``config`` is the dict written to ``mpmd_config.json`` for stage
    workers (its ``device`` — ``cpu``, or empty for CUDA — is where every
    stage runs; the launcher passes no device of its own); the driver
    itself only reads ``n_stages``, the model family, ``n_microbatches``
    and ``link_capacity`` from it. ``worker_modname`` names the stage
    worker's module, so torch-free tests supervise
    ``tests/_torch_port_mpmd_child.py`` stand-in stages through the REAL
    launcher.
    """

    def __init__(self, run_dir: str, config: Dict[str, Any], *,
                 worker_modname: str = WORKER_MODULE,
                 max_restarts: int = 3,
                 hang_timeout_s: float = 0.0,
                 trace_armed: Optional[bool] = None) -> None:
        self.run_dir = run_dir
        self.config = dict(config)
        self.n_stages = int(config["n_stages"])
        if self.n_stages < 2:
            raise ValueError("an MPMD pipeline needs >= 2 stages")
        self._launch_kw = dict(
            nprocs=1, devices_per_proc=1, max_restarts=max_restarts,
            monitor_interval=MONITOR_INTERVAL_S,
            restart_backoff_s=RESTART_BACKOFF_S,
            restart_backoff_max_s=RESTART_BACKOFF_MAX_S,
            hang_timeout_s=hang_timeout_s)
        self._modname = worker_modname
        self.paths = [StagePaths(run_dir, s).ensure()
                      for s in range(self.n_stages)]
        os.makedirs(os.path.join(run_dir, "links"), exist_ok=True)
        write_config(run_dir, self.config)
        self._threads: List[Optional[threading.Thread]] = (
            [None] * self.n_stages)
        self._rcs: List[Optional[int]] = [None] * self.n_stages
        self._known_attempt: Dict[int, int] = {}
        self.tracer = trace_lib.tracer_for(run_dir, "driver",
                                           armed=trace_armed, proc="driver")
        cap = int(self.config.get("link_capacity", 4))
        self.epoch = 0
        self._cmd = [FileStageLink(link_dir(run_dir, "cmd", s),
                                   capacity=max(8, cap),
                                   tracer=self.tracer)
                     for s in range(self.n_stages)]
        self._res = [FileStageLink(link_dir(run_dir, "res", s),
                                   capacity=max(8, cap),
                                   tracer=self.tracer)
                     for s in range(self.n_stages)]
        # gpt2 ties the word embedding across the first and last stage;
        # their grads sum through the driver before any apply. Derived
        # from the model family (the SAME rule StageMath applies — the
        # two sides deadlock if they disagree); "tied_embedding"
        # overrides for stand-in worker tests with no model config. The
        # family's default is run.train's (diffuseq).
        tied = self.config.get("tied_embedding")
        if tied is None:
            tied = (self.config.get("model", {})
                    .get("model_family", "diffuseq") == "gpt2")
        self.shared_stages = [0, self.n_stages - 1] if tied else []

    # --------------------------------------------------------- supervision
    def start(self) -> None:
        for s in range(self.n_stages):
            t = threading.Thread(target=self._supervise, args=(s,),
                                 daemon=True, name=f"mpmd-stage{s}")
            self._threads[s] = t
            t.start()

    def _supervise(self, s: int) -> None:
        argv = ["--run_dir", self.run_dir, "--stage", str(s),
                "--n_stages", str(self.n_stages)]
        try:
            rc = run_argv_as_distributed(
                self._modname, argv,
                log_dir=self.paths[s].log_dir,
                extra_env={"DPT_STAGE": str(s)},
                tag=f"stage{s}", **self._launch_kw)
        except Exception:
            rc = -1
        self._rcs[s] = rc

    def alive(self, s: int) -> bool:
        t = self._threads[s]
        return t is not None and t.is_alive()

    def rc(self, s: int) -> Optional[int]:
        return self._rcs[s]

    def attempts(self, s: int) -> int:
        return len(goodput_lib.read_attempts(self.paths[s].root))

    # ------------------------------------------------------------- control
    def _ready(self, s: int) -> Optional[dict]:
        return read_ready(self.paths[s])

    def _wait_all_ready(self) -> List[dict]:
        deadline = time.monotonic() + READY_TIMEOUT_S
        while True:
            rs = [self._ready(s) for s in range(self.n_stages)]
            if all(r is not None for r in rs):
                for s, r in enumerate(rs):
                    self._known_attempt[s] = int(r.get("attempt", 0))
                return rs  # type: ignore[return-value]
            for s in range(self.n_stages):
                if not self.alive(s):
                    raise RuntimeError(
                        f"stage {s} ring exited rc={self._rcs[s]} before "
                        f"ready")
            if time.monotonic() > deadline:
                missing = [s for s, r in enumerate(rs) if r is None]
                raise RuntimeError(f"stages {missing} never became ready "
                                   f"within {READY_TIMEOUT_S}s")
            time.sleep(0.02)

    def _restarted_stages(self) -> List[int]:
        out = []
        for s in range(self.n_stages):
            r = self._ready(s)
            if r is not None and int(r.get("attempt", 0)) \
                    != self._known_attempt.get(s, 0):
                out.append(s)
        return out

    def _broadcast(self, op: str, meta: dict,
                   arrays: Optional[Dict[int, Dict[str, np.ndarray]]] = None,
                   stages: Optional[List[int]] = None) -> None:
        for s in (stages if stages is not None else range(self.n_stages)):
            self._cmd[s].send((arrays or {}).get(s, {}),
                              {"op": op, **meta})

    def _set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        for ln in self._cmd + self._res:
            ln.set_epoch(epoch)

    # ---------------------------------------------------------- step loop
    def run(self, n_steps: int) -> Dict[str, Any]:
        """Drive ``n_steps`` optimizer steps; returns losses + ledger."""
        self.start()
        rs = self._wait_all_ready()
        losses: Dict[int, float] = {}
        metrics: Dict[int, dict] = {}
        done_step = min(int(r.get("params_step", 0)) for r in rs)
        rewinds = 0
        n_mb = int(self.config.get("n_microbatches", 1))
        while done_step < n_steps:
            step = done_step + 1
            with self.tracer.span("pipeline_step", "driver",
                                  args={"step": step, "epoch": self.epoch}):
                self._broadcast("step", {"step": step, "epoch": self.epoch,
                                         "n_mb": n_mb})
                outcome = self._collect_step(step)
            if outcome is None:  # a stage ring restarted its worker
                rewinds += 1
                done_step = self._rewind()
                continue
            losses[step] = outcome.get("loss", float("nan"))
            metrics[step] = {k: v for k, v in outcome.items()
                             if k not in ("op", "step", "stage", "epoch")}
            done_step = step
        self.stop()
        agg = goodput_lib.aggregate_run(self.run_dir)
        self.tracer.close()
        return {
            "steps": n_steps,
            "losses": [losses[t] for t in sorted(losses)],
            "metrics": metrics,
            "rewinds": rewinds,
            "attempts_per_stage": [self.attempts(s)
                                   for s in range(self.n_stages)],
            "goodput": agg,
        }

    def _collect_step(self, step: int) -> Optional[dict]:
        """Gather this step's res traffic: tied-grad partials (summed and
        broadcast back), then ``done`` from every stage. Returns the last
        stage's done payload, or None when a restart was detected (the
        caller rewinds). Raises when a stage ring is permanently down."""
        need_shared = set(self.shared_stages)
        shared_sum: Optional[Dict[str, np.ndarray]] = None
        need_done = set(range(self.n_stages))
        payload: Dict[str, Any] = {"loss": 0.0}
        deadline = time.monotonic() + STEP_TIMEOUT_S
        while need_done:
            progress = False
            for s in list(need_done):
                got = self._res[s].recv(timeout_s=0.05)
                if got is None:
                    continue
                arrays, meta = got
                if int(meta.get("epoch", 0)) != self.epoch \
                        or int(meta.get("step", -1)) != step:
                    progress = True  # stale straggler: already dropped
                    continue
                op = meta.get("op")
                progress = True
                if op == "shared":
                    need_shared.discard(s)
                    if shared_sum is None:
                        shared_sum = {k: v.copy() for k, v in arrays.items()}
                    else:
                        for k, v in arrays.items():
                            shared_sum[k] = shared_sum[k] + v
                    if not need_shared and self.shared_stages:
                        self._broadcast(
                            "shared_sum", {"step": step, "epoch": self.epoch},
                            arrays={t: shared_sum
                                    for t in self.shared_stages},
                            stages=self.shared_stages)
                elif op == "done":
                    need_done.discard(s)
                    # the step loss is the sum of per-stage partials
                    # (diffuseq books tT + decoder_nll on stage 0, mse on
                    # the last stage; gpt2's lands entirely on the last)
                    payload["loss"] += float(meta.get("loss_partial", 0.0))
                    for k, v in meta.items():
                        if k not in ("op", "step", "stage", "epoch",
                                     "loss_partial"):
                            payload[k] = v
            if self._restarted_stages():
                return None
            for s in range(self.n_stages):
                if not self.alive(s) and s in need_done:
                    raise RuntimeError(
                        f"stage {s} ring gave up (rc={self._rcs[s]}) at "
                        f"step {step} — restart budget exhausted")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"step {step} timed out after {STEP_TIMEOUT_S}s "
                    f"(waiting on stages {sorted(need_done)})")
            if not progress:
                time.sleep(0.01)
        return payload

    def _rewind(self) -> int:
        """Roll every stage back to the min ready step on a new epoch.
        Surviving stage PROCESSES are untouched: each reloads its own
        local snapshot (a file op); only the dead stage's ring respawned.
        Returns the step training resumes from."""
        # wait for every restarted stage to re-announce ready
        deadline = time.monotonic() + READY_TIMEOUT_S
        while True:
            rs = [self._ready(s) for s in range(self.n_stages)]
            if all(r is not None for r in rs):
                break
            if time.monotonic() > deadline:
                raise RuntimeError("rewind: stages never re-announced ready")
            time.sleep(0.02)
        self._set_epoch(self.epoch + 1)
        for s, r in enumerate(rs):
            self._known_attempt[s] = int(r.get("attempt", 0))
        target = min(int(r.get("params_step", 0)) for r in rs)
        self.tracer.instant("rewind", "driver",
                            args={"step": target, "epoch": self.epoch})
        self._broadcast("rewind", {"step": target, "epoch": self.epoch})
        acked = set()
        deadline = time.monotonic() + READY_TIMEOUT_S
        while len(acked) < self.n_stages:
            for s in range(self.n_stages):
                if s in acked:
                    continue
                got = self._res[s].recv(timeout_s=0.05)
                if got is None:
                    continue
                _, meta = got
                if meta.get("op") == "rewound" \
                        and int(meta.get("epoch", -1)) == self.epoch:
                    acked.add(s)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"rewind to {target}: stages "
                    f"{sorted(set(range(self.n_stages)) - acked)} never "
                    f"acked")
        return target

    # ---------------------------------------------------------------- stop
    def stop(self) -> None:
        for s in range(self.n_stages):
            try:
                with open(self.paths[s].stop_path, "w") as f:
                    f.write("stop")
            except OSError:
                pass
            self._cmd[s].send({}, {"op": "stop", "epoch": self.epoch})
        for t in self._threads:
            if t is not None:
                t.join(60.0)

    def result_path(self) -> str:
        return os.path.join(self.run_dir, "mpmd_result.json")

    def write_result(self, result: Dict[str, Any]) -> None:
        tmp = self.result_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1, default=float)
        os.replace(tmp, self.result_path())
