"""ChaosInjector: executes a :class:`~.plan.ChaosPlan` inside a live run
(the port of ``distributed_pipeline_tpu/chaos/inject.py``).

Training: the trainer calls three hooks — :meth:`ChaosInjector.on_step` at
the top of every optimizer step (``corrupt_checkpoint``, ``kill``,
``stall_step``, ``slow_rank``), :meth:`ChaosInjector.on_data` before
pulling a batch (``stall_data``) and :meth:`ChaosInjector.on_save` right
after a checkpoint save (``crash_in_save``); each fires whatever faults
the plan schedules for the current step on this rank. Serving: a replica
worker calls :meth:`ChaosInjector.on_serve_tick` once per scheduler tick
(``kill_replica``, ``stall_replica``), and the fleet parent calls
:meth:`ChaosInjector.on_swap` when a checkpoint hot-swap is armed
(``corrupt_swap_checkpoint``). Every fault except ``slow_rank`` fires AT
MOST ONCE PER RUN: a marker file in the run dir (written BEFORE the fault
executes) makes the respawned attempt sail past the step that killed its
predecessor.

The port's notion of a finalized checkpoint: the JAX package's checkpoint
is an orbax ``model_*`` DIRECTORY, finalized once it holds a commit
marker. The port's is one step's files, ``model_/ema_{rate}_/opt_
NNNNNN.pt`` and ``meta_NNNNNN.json`` (``utils/checkpoint.py``), each
written to ``.tmp`` and renamed, the meta last: a step is finalized
exactly when its meta file exists, so the meta plays the commit marker.
:func:`corrupt_newest_checkpoint` garbles the head of the newest finalized
step's ``model_NNNNNN.pt`` and leaves its meta (the step still looks
finalized, its restore fails: the walk-back's case), as the JAX version
garbles only the ``model_`` directory; ``crash_in_save`` removes the
just-saved step's meta before its SIGKILL, which leaves the torn step (its
payload without its commit marker) that a kill between the payload writes
and the meta write would.

Import-light on purpose: the fleet parent imports this without torch.
"""

from __future__ import annotations

import os
import re
import signal
import sys
import time
from typing import Optional

from .plan import ChaosFault, ChaosPlan

__all__ = ["ChaosInjector", "corrupt_newest_checkpoint",
           "corrupt_checkpoint_payload"]

# Payload bytes for checkpoint corruption: long enough to guarantee any
# parser downstream sees garbage, loud enough to grep in a hexdump.
_GARBAGE = b"\xde\xad\xbe\xef CHAOS-CORRUPTED " * 8


_META_RE = re.compile(r"^meta_(\d{6,})\.json$")


def _meta_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"meta_{step:06d}.json")


def corrupt_newest_checkpoint(directory: str) -> Optional[str]:
    """Garble the head of the newest finalized step's ``model_NNNNNN.pt``
    under ``directory`` (a step whose meta file exists; its meta is left
    as it is). Returns the corrupted path, or None when there is no
    finalized checkpoint to corrupt."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    steps = sorted((int(m.group(1)) for m in map(_META_RE.match, names)
                    if m), reverse=True)
    for step in steps:
        path = os.path.join(directory, f"model_{step:06d}.pt")
        if os.path.exists(path):
            corrupt_checkpoint_payload(path)
            return path
    return None


def corrupt_checkpoint_payload(path: str) -> bool:
    """Garble the head of ONE checkpoint: a ``model_NNNNNN.pt`` file (or,
    given a directory, every file under it). The file keeps its name, so
    it still looks finalized; any ``torch.load`` of it must fail. Returns
    whether anything was written — ``False`` means there was no payload to
    damage (missing/empty), so a caller injecting a swap fault can tell the
    fault went nowhere."""
    if os.path.isdir(path):
        files = [os.path.join(root, f) for root, _, names in os.walk(path)
                 for f in names]
    else:
        files = [path]
    wrote = False
    for fpath in files:
        try:
            if os.path.getsize(fpath) == 0:
                continue
            with open(fpath, "r+b") as f:
                f.write(_GARBAGE)
            wrote = True
        except OSError:
            pass  # a file we cannot open is already damage enough
    return wrote


class ChaosInjector:
    """Fires the plan's faults from the trainer's and the fleet's hook
    points.

    ``run_dir`` anchors the once-per-run markers (the training run dir, a
    replica's dir for the tick hook, the fleet dir for the swap hook);
    without one, markers degrade to in-process memory."""

    def __init__(self, plan: ChaosPlan, rank: int = 0,
                 run_dir: str = "") -> None:
        self.plan = plan
        self.rank = rank
        self.run_dir = run_dir
        self._fired_mem: set = set()

    # ------------------------------------------------------------- markers

    def _marker(self, idx: int) -> str:
        return os.path.join(self.run_dir, f".chaos_fired_{idx:02d}")

    def _already_fired(self, idx: int) -> bool:
        if idx in self._fired_mem:
            return True
        return bool(self.run_dir) and os.path.exists(self._marker(idx))

    def _mark_fired(self, idx: int, fault: ChaosFault) -> None:
        # Marker lands BEFORE the fault executes: a SIGKILL leaves no
        # chance to write afterwards, and a re-fired kill every attempt
        # would be an unrecoverable crash loop, not an injected fault.
        self._fired_mem.add(idx)
        if self.run_dir:
            with open(self._marker(idx), "w") as f:
                f.write(f"{fault.kind} step={fault.step} rank={fault.rank} "
                        f"t={time.time():.3f}\n")

    def _fire_kill(self, fault: ChaosFault) -> None:
        sig = getattr(signal, fault.sig, None)
        if not isinstance(sig, signal.Signals):
            raise ValueError(f"chaos kill: unknown signal {fault.sig!r}")
        print(f"[chaos] rank {self.rank}: {fault.sig} self at step "
              f"{fault.step}", file=sys.stderr, flush=True)
        os.kill(os.getpid(), sig)
        # SIGTERM may be handled/deferred by the host loop; SIGKILL never
        # returns here. Either way the fault's job is done.

    # -------------------------------------------------------- training hooks

    def _due(self, step: int, kinds) -> list:
        return [(i, f) for i, f in enumerate(self.plan.faults)
                if f.kind in kinds and f.rank == self.rank
                and f.step == step and not self._already_fired(i)]

    def on_step(self, loop) -> None:
        """Top of ``run_step``: corrupt/kill/stall_step faults scheduled
        for the step ABOUT to run (``loop.step`` counts the completed
        ones; plan order — corrupt-then-kill at the same step is the
        classic 'newest checkpoint is garbage AND the worker died'), plus
        the slow_rank straggler delay."""
        for idx, fault in self._due(loop.step,
                                    ("corrupt_checkpoint", "kill",
                                     "stall_step")):
            self._mark_fired(idx, fault)
            if fault.kind == "corrupt_checkpoint":
                # the newest checkpoint is the one the loop last saved:
                # its background write lands first, so the victim does not
                # depend on the writer's timing
                loop.wait_for_saves()
                victim = corrupt_newest_checkpoint(
                    self.run_dir or loop.checkpoint_dir)
                print(f"[chaos] rank {self.rank}: corrupted checkpoint "
                      f"{victim}", file=sys.stderr, flush=True)
            elif fault.kind == "stall_step":
                # the wedge the hang watchdog exists for: alive, beacons
                # frozen, no exit code; the marker landed first, so the
                # attempt the watchdog kills is resumed past the wedge
                print(f"[chaos] rank {self.rank}: wedging step loop "
                      f"{fault.seconds}s at step {fault.step}",
                      file=sys.stderr, flush=True)
                time.sleep(fault.seconds)
            else:
                self._fire_kill(fault)
        # slow_rank: a straggler, not a hang — sleeps before EVERY step in
        # its [step, until_step] range, with no once-per-run marker; the
        # beacons keep advancing, so the hang watchdog must ride through
        for fault in self.plan.faults:
            if (fault.kind == "slow_rank" and fault.rank == self.rank
                    and fault.step <= loop.step <= fault.until_step):
                time.sleep(fault.seconds)

    def on_data(self, loop) -> float:
        """Before pulling the batch for the NEXT step: stall faults.
        Returns the injected stall seconds (the caller books them into
        the data-wait gauge: the input-pipeline time they simulate)."""
        stalled = 0.0
        for idx, fault in self._due(loop.step, ("stall_data",)):
            self._mark_fired(idx, fault)
            print(f"[chaos] rank {self.rank}: stalling data "
                  f"{fault.seconds}s at step {fault.step}",
                  file=sys.stderr, flush=True)
            time.sleep(fault.seconds)
            stalled += fault.seconds
        return stalled

    def on_save(self, loop) -> None:
        """Right after the checkpoint of step ``loop.step`` is scheduled:
        crash_in_save faults leave that step torn — its payload files
        written, its meta (the commit marker) absent, whatever the writer
        thread's timing (``loop.tear_save``) — and SIGKILL the process;
        resume must skip the step."""
        for idx, fault in self._due(loop.step, ("crash_in_save",)):
            self._mark_fired(idx, fault)
            if not loop.tear_save():
                # no save of this rank's in flight: drop the meta if the
                # writing rank has committed it
                meta = _meta_path(self.run_dir or loop.checkpoint_dir,
                                  loop.step)
                try:
                    os.remove(meta)
                except OSError:
                    pass  # torn already
            print(f"[chaos] rank {self.rank}: SIGKILL mid-save at step "
                  f"{fault.step}", file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    # ------------------------------------------------------- serving hooks

    def on_serve_tick(self, admitted: int, in_flight: int) -> None:
        """Serving replica hook, called once per scheduler tick with the
        replica's cumulative ADMITTED request count and its current
        in-flight count. ``kill_replica`` / ``stall_replica`` faults for
        this replica (``rank`` = replica id) fire at the first tick where
        ``admitted >= step`` AND something is in flight — "mid-request"
        by construction, whatever the traffic process did to the
        schedule. Threshold (not equality) because admitted counts can
        jump by a whole prefill batch in one tick. Marker-once like every
        fault: a respawned replica sails past."""
        if in_flight <= 0:
            return
        due = [(i, f) for i, f in enumerate(self.plan.faults)
               if f.kind in ("kill_replica", "stall_replica")
               and f.rank == self.rank and admitted >= f.step
               and not self._already_fired(i)]
        for idx, fault in due:
            self._mark_fired(idx, fault)
            if fault.kind == "stall_replica":
                # the serving wedge: alive, beacons frozen — only the
                # per-replica hang watchdog can end this
                print(f"[chaos] replica {self.rank}: wedging serve loop "
                      f"{fault.seconds}s ({in_flight} in flight)",
                      file=sys.stderr, flush=True)
                time.sleep(fault.seconds)
            else:
                self._fire_kill(fault)

    def on_swap(self, checkpoint_path: str) -> bool:
        """Fleet-side hook at the start of a checkpoint hot-swap:
        ``corrupt_swap_checkpoint`` garbles the swap TARGET before any
        replica loads it (``step``/``rank`` ignored — the swap is a
        fleet-level event, and this injector's run_dir is the fleet dir).
        Returns whether a fault fired, so the swap report can say the
        abort was injected rather than organic."""
        due = [(i, f) for i, f in enumerate(self.plan.faults)
               if f.kind == "corrupt_swap_checkpoint"
               and not self._already_fired(i)]
        fired = False
        for idx, fault in due:
            self._mark_fired(idx, fault)
            wrote = corrupt_checkpoint_payload(checkpoint_path)
            print(f"[chaos] fleet: corrupted swap checkpoint "
                  f"{checkpoint_path} (payload garbled: {wrote})",
                  file=sys.stderr, flush=True)
            fired = True
        return fired
