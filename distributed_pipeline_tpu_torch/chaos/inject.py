"""ChaosInjector: executes the serving faults of a :class:`~.plan.ChaosPlan`
inside a live fleet (the serving half of ``distributed_pipeline_tpu/chaos/
inject.py``).

A replica worker calls :meth:`ChaosInjector.on_serve_tick` once per
scheduler tick (``kill_replica``, ``stall_replica``); the fleet parent calls
:meth:`ChaosInjector.on_swap` when a checkpoint hot-swap is armed
(``corrupt_swap_checkpoint``). Every fault fires AT MOST ONCE PER RUN: a
marker file in the run dir (written BEFORE the fault executes) makes the
respawned attempt sail past the tick that killed its predecessor. The
training hooks (``on_step``, ``on_data``, ``on_save``) come with the
training side's chaos (ROADMAP A.10); a serving run ignores the training
kinds, as in the JAX package.

The port's notion of a finalized checkpoint: the JAX package's checkpoint
is an orbax ``model_*`` DIRECTORY, finalized once it holds a commit marker.
The port's is one FILE, ``model_NNNNNN.pt``, written to ``.tmp`` and then
renamed (``utils/checkpoint.py``), so it is finalized exactly when it
exists under its own name. :func:`corrupt_checkpoint_payload` garbles that
file's head, so a ``torch.load`` of it fails: the same behaviour (the
target still looks finalized, any restore of it fails) over a different
layout.

Import-light on purpose: the fleet parent imports this without torch.
"""

from __future__ import annotations

import os
import signal
import sys
import time

from .plan import ChaosFault, ChaosPlan

__all__ = ["ChaosInjector", "corrupt_checkpoint_payload"]

# Payload bytes for checkpoint corruption: long enough to guarantee any
# parser downstream sees garbage, loud enough to grep in a hexdump.
_GARBAGE = b"\xde\xad\xbe\xef CHAOS-CORRUPTED " * 8


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
    """Fires the plan's serving faults from the fleet's hook points.

    ``run_dir`` anchors the once-per-run markers (a replica's dir for the
    tick hook, the fleet dir for the swap hook); without one, markers
    degrade to in-process memory."""

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
