"""MPMD stage worker: one pipeline stage as its own supervised process.
The port of ``distributed_pipeline_tpu/mpmd/stage_worker.py``.

Launched per stage by the driver under its OWN launcher ring
(``run_argv_as_distributed`` with nprocs=1: the stage's "process group"
is one process, and stage-to-stage traffic rides StageLink instead of
collectives; on one card every stage process shares ``cuda:0``). The
worker owns its parameter slice (mpmd/stage_math.py) on the device
``mpmd_config.json`` names (``cuda`` unless it says ``cpu``), executes
the driver's two-phase step protocol (mpmd/protocol.py module
docstring), snapshots its state every ``SNAPSHOT_EVERY`` steps (step 0
included), and re-announces ``ready.json`` so the driver can detect its
ring's restarts and pick rewind targets. Its clean-exit sidecar carries
the process's kernel launches and plain calls, its peak device memory,
each step's seconds and the bytes of an act frame and of a snapshot.

Abort-over-hang: every blocking link op takes an interrupt callable
(cmd traffic pending, or the stop file) — a stage waiting on a DEAD
peer abandons the step without applying and returns to the command
loop, where the driver's ``rewind`` frame redirects it. State stays
consistent because an aborted step applies nothing and a rewind reloads
the local snapshot.

Chaos injection: ``DPT_MPMD_KILL=stage:step`` SIGKILLs that stage
mid-schedule (after its first op of that step, in-flight frames on the
wire) on attempt 0 only — the stage's own ring respawns it, the driver
rewinds, and the run must finish with the reference loss sequence.

    python -m distributed_pipeline_tpu_torch.mpmd.stage_worker \
        --run_dir DIR --stage I --n_stages N
"""

from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Any, Optional, Tuple

from ..obs import trace as trace_lib
from ..obs.trace import microbatch_trace_id
from .link import FileStageLink
from .protocol import (StagePaths, StageProtocol, data_links_for_stage,
                       link_dir, load_snapshot, newest_snapshot_step,
                       read_config, save_snapshot, schedule_for,
                       _snapshot_steps)

_ABORT = object()   # step abandoned (interrupt/mismatch); await rewind
_CTRL = "ctrl"      # a control frame surfaced mid-step; main loop handles
# a snapshot every SNAPSHOT_EVERY steps (step 0 included), the newest
# SNAPSHOT_KEEP kept
SNAPSHOT_EVERY = 1
SNAPSHOT_KEEP = 8
# how long a stage waits for a data frame or the summed shared gradients,
# and for the driver's next command, before it gives up
DATA_TIMEOUT_S = 600.0
IDLE_TIMEOUT_S = 600.0


class StageWorker:
    def __init__(self, run_dir: str, stage: int, n_stages: int) -> None:
        self.run_dir = run_dir
        self.stage = int(stage)
        self.n_stages = int(n_stages)
        self.config = read_config(run_dir)
        self.paths = StagePaths(run_dir, stage)
        self.proto = StageProtocol(self.paths, n_stages=n_stages)
        self.gp = self.proto.goodput
        self.proto.write_beacon(0)

        self.kill_step = -1
        spec = os.environ.get("DPT_MPMD_KILL", "")
        if spec and self.proto.attempt == 0:
            ks, _, kt = spec.partition(":")
            if int(ks) == self.stage:
                self.kill_step = int(kt)

        # the torch side (imports, the full init on the host, the slice
        # on the device); nothing here captures a CUDA graph, so the
        # monitor's count stays the compiles a stage made: none
        from ..utils.perf import RecompileMonitor
        from .stage_math import StageMath
        self.mon = RecompileMonitor()
        self.math = StageMath(self.config, self.stage)
        self.gp.add("startup_s", self.gp.summary()["wall_s"])

        with self.gp.timed("restore_s"):
            self.done = newest_snapshot_step(self.paths.snap_dir)
            if self.done > 0:
                self.math.load_flat(
                    load_snapshot(self.paths.snap_dir, self.done))
        # the sidecar's step seconds (and of them the data's and the
        # math's) and frame and snapshot bytes
        self.step_s: list = []
        self.data_s: list = []
        self.math_s: list = []
        self.act_frame_bytes = 0
        self.snapshot_bytes = 0
        # stage 0 makes its next step's batch while the other stages start
        # (booked as setup, not as a step's data stall)
        with self.gp.timed("setup_s"):
            self.math.prefetch(self.done + 1)
        if 0 not in _snapshot_steps(self.paths.snap_dir):
            # the rewind target can be 0: persist the from-seed init so
            # every rewind is the same uniform snapshot reload
            with self.gp.timed("save_s"):
                path = save_snapshot(self.paths.snap_dir, 0,
                                     self.math.export_flat(),
                                     keep=SNAPSHOT_KEEP)
            self.snapshot_bytes = os.path.getsize(path)
        self.proto.start_step = self.done
        self.high_water = self.done   # replays below this book recompute_s

        cap = int(self.config.get("link_capacity", 4))
        tr = self.proto.tracer
        self.cmd = FileStageLink(link_dir(run_dir, "cmd", stage),
                                 capacity=max(8, cap), tracer=tr)
        self.res = FileStageLink(link_dir(run_dir, "res", stage),
                                 capacity=max(8, cap), tracer=tr)
        dl = data_links_for_stage(run_dir, stage, n_stages)
        mk = (lambda p: FileStageLink(p, capacity=cap, tracer=tr)
              if p else None)
        self.act_in = mk(dl["act_in"])
        self.act_out = mk(dl["act_out"])
        self.grad_in = mk(dl["grad_in"])
        self.grad_out = mk(dl["grad_out"])
        self.epoch = 0
        self.warm_compiles: Optional[int] = None

    # ------------------------------------------------------------ plumbing
    def _links(self):
        return [ln for ln in (self.cmd, self.res, self.act_in, self.act_out,
                              self.grad_in, self.grad_out) if ln is not None]

    def _interrupt(self) -> bool:
        return self.cmd.pending() > 0 or self.proto.stop_requested()

    def _set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        for ln in self._links():
            ln.set_epoch(epoch)

    def _book_recompiles(self) -> None:
        total = self.mon.count
        steady = (total - self.warm_compiles
                  if self.warm_compiles is not None else 0)
        self.proto.set_recompiles(total, steady)

    def _take_link_wait(self) -> float:
        return sum(ln.take_wait_s() for ln in self._links())

    def _recv_data(self, link: FileStageLink, step: int, mb: int,
                   tag: str):
        """One in-order data frame for (step, mb); anything else proves
        the peer diverged (its ring restarted mid-step) -> abort."""
        got = link.recv(timeout_s=DATA_TIMEOUT_S, interrupt=self._interrupt)
        if got is None:
            return _ABORT
        arrays, meta = got
        if (int(meta.get("epoch", 0)) != self.epoch
                or int(meta.get("step", -1)) != step
                or int(meta.get("mb", -1)) != mb
                or meta.get("tag") != tag):
            return _ABORT
        return arrays

    # ----------------------------------------------------------- step body
    def _run_step(self, step: int, n_mb: int) -> Tuple[str, Any]:
        """Execute one full optimizer step. Returns ("ok", done_payload),
        ("abort", None), or ("ctrl", frame) when a control frame arrived
        while awaiting the tied-grad sum."""
        watch = trace_lib.Stopwatch()
        with self.proto.tracer.span("stage_step", "stage",
                                    args={"step": step, "stage": self.stage,
                                          "epoch": self.epoch}):
            ds = 0.0
            ms = trace_lib.Stopwatch()
            math_s = 0.0
            if self.math.is_first:
                d0 = trace_lib.Stopwatch()
                self.math.start_step(step, n_mb)   # includes the batch gen
                ds = d0.lap_s()
                self.gp.add("data_stall_s", ds)
            else:
                self.math.start_step(step, n_mb)
            ops = schedule_for(self.stage, self.n_stages, n_mb,
                               self.config.get("schedule", "1f1b"))
            for i, (op, mb) in enumerate(ops):
                if step == self.kill_step and i == 1:
                    # chaos: die mid-schedule with frames on the wire
                    os.kill(os.getpid(), signal.SIGKILL)
                tid = microbatch_trace_id(step, mb)
                if op == "F":
                    inb = None
                    if self.act_in is not None:
                        inb = self._recv_data(self.act_in, step, mb, "act")
                        if inb is _ABORT:
                            return ("abort", None)
                    with self.proto.tracer.span("fwd", "stage",
                                                trace_id=tid,
                                                args={"mb": mb}):
                        ms.lap_s()
                        out = self.math.forward_mb(mb, inb)
                        math_s += ms.lap_s()
                    if self.act_out is not None:
                        self.act_frame_bytes = sum(a.nbytes
                                                   for a in out.values())
                        if not self.act_out.send(
                                out, {"step": step, "mb": mb, "tag": "act",
                                      "trace": tid},
                                interrupt=self._interrupt):
                            return ("abort", None)
                else:
                    inb = None
                    if self.grad_in is not None:
                        inb = self._recv_data(self.grad_in, step, mb,
                                              "grad")
                        if inb is _ABORT:
                            return ("abort", None)
                    with self.proto.tracer.span("bwd", "stage",
                                                trace_id=tid,
                                                args={"mb": mb}):
                        ms.lap_s()
                        out = self.math.backward_mb(mb, inb)
                        math_s += ms.lap_s()
                    if self.grad_out is not None:
                        if not self.grad_out.send(
                                out, {"step": step, "mb": mb,
                                      "tag": "grad", "trace": tid},
                                interrupt=self._interrupt):
                            return ("abort", None)
            part = self.math.shared_grads()
            shared_sum = None
            if part is not None:
                self.res.send(part, {"op": "shared", "step": step,
                                     "epoch": self.epoch})
                got = self._await_shared_sum(step)
                if got is _ABORT:
                    return ("abort", None)
                if isinstance(got, tuple) and got[0] == _CTRL:
                    return ("ctrl", got[1])
                shared_sum = got
            payload = self.math.apply(shared_sum)
        dur = watch.lap_s()
        self.step_s.append(dur)
        self.data_s.append(ds)
        self.math_s.append(math_s)
        lw = self._take_link_wait()
        self.gp.add("link_wait_s", lw)
        if step <= self.high_water:
            # a rewind replay: this step's work was already paid for once
            self.gp.add("recompute_s", max(0.0, dur - lw - ds))
        return ("ok", payload)

    def _await_shared_sum(self, step: int):
        """Block for the driver-summed tied grads; a rewind/stop frame
        arriving instead is surfaced to the main loop unconsumed-in-
        spirit (returned as a ctrl result)."""
        deadline = time.monotonic() + DATA_TIMEOUT_S
        while True:
            got = self.cmd.recv(timeout_s=1.0)
            if got is not None:
                arrays, meta = got
                op = meta.get("op")
                if (op == "shared_sum"
                        and int(meta.get("step", -1)) == step
                        and int(meta.get("epoch", 0)) == self.epoch):
                    return arrays
                if op in ("rewind", "stop"):
                    return (_CTRL, (arrays, meta))
                # stale shared_sum/step from an older epoch: drop
            if self.proto.stop_requested():
                return (_CTRL, ({}, {"op": "stop"}))
            if time.monotonic() > deadline:
                return _ABORT

    # ------------------------------------------------------------- control
    def _handle_rewind(self, meta: dict) -> None:
        target = int(meta["step"])
        epoch = int(meta["epoch"])
        self._set_epoch(epoch)
        with self.gp.timed("restore_s"):
            if target != self.done:
                flat = load_snapshot(self.paths.snap_dir, target)
                if flat is None:
                    raise RuntimeError(
                        f"stage {self.stage}: rewind target {target} has "
                        f"no loadable snapshot")
                self.math.load_flat(flat)
        self.done = target
        self.proto.tracer.instant("rewound", "stage",
                                  args={"step": target, "epoch": epoch})
        self.proto.announce_ready(target)
        self.res.send({}, {"op": "rewound", "step": target, "epoch": epoch})

    def run(self) -> int:
        self.proto.announce_ready(self.done)
        self.proto.write_beacon(self.done)
        last_cmd = time.monotonic()
        pending_ctrl: Optional[tuple] = None
        while True:
            if pending_ctrl is not None:
                got, pending_ctrl = pending_ctrl, None
            else:
                got = self.cmd.recv(timeout_s=0.5)
            if got is None:
                if self.proto.stop_requested():
                    break
                if time.monotonic() - last_cmd > IDLE_TIMEOUT_S:
                    break   # orphaned (driver gone): exit clean
                continue
            last_cmd = time.monotonic()
            _, meta = got
            op = meta.get("op")
            if op == "stop":
                break
            if op == "rewind":
                self._handle_rewind(meta)
                continue
            if op != "step":
                continue   # stale shared_sum etc. from an aborted step
            step = int(meta["step"])
            if int(meta.get("epoch", 0)) != self.epoch \
                    or step != self.done + 1:
                continue   # pre-restart straggler; the rewind heals it
            status, payload = self._run_step(step,
                                             int(meta.get("n_mb", 1)))
            if status == "ctrl":
                pending_ctrl = payload
                continue
            if status != "ok":
                continue   # aborted: await the driver's rewind
            self.done = step
            self.high_water = max(self.high_water, step)
            if self.warm_compiles is None:
                self.warm_compiles = self.mon.count
            if step % SNAPSHOT_EVERY == 0:
                with self.gp.timed("save_s"):
                    path = save_snapshot(self.paths.snap_dir, step,
                                         self.math.export_flat(),
                                         keep=SNAPSHOT_KEEP)
                self.snapshot_bytes = os.path.getsize(path)
            self._book_recompiles()
            self.proto.announce_ready(step)
            self.proto.write_beacon(step)
            self.res.send({}, {"op": "done", "step": step,
                               "epoch": self.epoch, "stage": self.stage,
                               **payload})
        self.gp.add("link_wait_s", self._take_link_wait())
        self._book_recompiles()
        self.proto.write_beacon(self.done)
        self.proto.write_sidecar(self.done, extra={
            **self.math.stats(), "step_s": self.step_s,
            "step_data_s": self.data_s, "step_math_s": self.math_s,
            "act_frame_bytes": self.act_frame_bytes,
            "snapshot_bytes": self.snapshot_bytes})
        self.proto.tracer.close()
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--stage", type=int, required=True)
    p.add_argument("--n_stages", type=int, required=True)
    args = p.parse_args(argv)
    worker = StageWorker(args.run_dir, args.stage, args.n_stages)
    return worker.run()


if __name__ == "__main__":
    raise SystemExit(main())
