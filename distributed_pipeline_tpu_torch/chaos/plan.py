"""ChaosPlan: a declarative schedule of faults to inject into a live run.

The plan is plain JSON so it travels every channel a config does —
``--chaos_plan`` on the CLI, a field in ``--config_json``, or the
``DPT_CHAOS_PLAN`` environment variable, which (like ``DPT_PREFETCH_DEPTH``)
is inherited by every worker of every restart attempt the launcher spawns:
the one channel that reaches a ``--config_json`` ring without minting a new
config file.

Schema::

    {"faults": [
        {"kind": "kill",               "step": 3, "rank": 1,
         "sig": "SIGKILL"},
        {"kind": "crash_in_save",      "step": 6, "rank": 0},
        {"kind": "stall_data",         "step": 2, "rank": 0,
         "seconds": 1.5},
        {"kind": "stall_step",         "step": 4, "rank": 0,
         "seconds": 600},
        {"kind": "slow_rank",          "step": 2, "rank": 0,
         "seconds": 0.2, "until_step": 6},
        {"kind": "corrupt_checkpoint", "step": 5, "rank": 0}
    ]}

Fault kinds (executed by :mod:`.inject`):

* ``kill`` — the targeted rank sends itself ``sig`` (SIGKILL/SIGTERM/...)
  at the top of optimizer step ``step`` (a worker dying mid-step);
* ``crash_in_save`` — the targeted rank SIGKILLs itself right after the
  checkpoint save at ``step`` is SCHEDULED, i.e. between the array write
  and finalize — leaving an unfinalized/torn checkpoint on disk;
* ``stall_data`` — the targeted rank's data iterator blocks ``seconds``
  before yielding the batch at ``step`` (a wedged input pipeline);
* ``stall_step`` — the targeted rank WEDGES inside the step loop for
  ``seconds`` at the top of step ``step`` (a hung collective / network
  stall: the process stays alive but no rank advances — the failure the
  launcher's ``--hang_timeout_s`` watchdog exists to detect, since no
  exit code ever fires the restart machinery). Fires once per run (the
  marker makes the respawned attempt sail past the wedge step);
* ``slow_rank`` — a STRAGGLER, not a hang: the targeted rank sleeps
  ``seconds`` before EVERY step in ``[step, until_step]``. Progress
  continues (beacons keep advancing), so the hang watchdog must NOT
  fire — the negative control proving the watchdog keys on stalled
  progress, not on slowness;
* ``corrupt_checkpoint`` — garbles the payload of the newest FINALIZED
  checkpoint in the run dir at ``step`` (bit rot / torn replication: the
  directory still looks committed, but restore fails — the case the
  resume walk-back exists for).

Serving-fleet faults (``rank`` targets a REPLICA id, ``step``
is an admitted-request threshold — serving has no optimizer steps):

* ``kill_replica`` — the targeted replica's worker sends itself ``sig``
  at the first scheduler tick where it has admitted >= ``step`` requests
  AND at least one is still in flight (a replica dying mid-request: the
  router must replay the in-flight requests on a sibling);
* ``stall_replica`` — same trigger, but the worker WEDGES alive for
  ``seconds`` (a stuck device / network stall): beacons freeze, so only
  the per-replica hang watchdog can end it — the serving twin of
  ``stall_step``;
* ``corrupt_swap_checkpoint`` — fired FLEET-side at the next checkpoint
  hot-swap: the swap target's payload is garbled before any replica
  loads it, so the canary replica's validation must fail and the swap
  must abort with every replica still serving the old weights (``step``
  and ``rank`` are ignored — the swap is a fleet-level event).

This module must stay import-light (no torch): the fleet parent and the
launcher read plans in a process that never imports torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

__all__ = ["ChaosFault", "ChaosPlan", "CHAOS_PLAN_ENV"]

CHAOS_PLAN_ENV = "DPT_CHAOS_PLAN"

_KINDS = ("kill", "crash_in_save", "stall_data", "stall_step", "slow_rank",
          "corrupt_checkpoint",
          "kill_replica", "stall_replica", "corrupt_swap_checkpoint")


@dataclasses.dataclass(frozen=True)
class ChaosFault:
    """One scheduled fault. ``rank`` targets a single process (faults on
    other ranks no-op), so a plan can kill worker 1 mid-step while worker
    0 keeps serving the coordinator."""

    kind: str
    step: int
    rank: int = 0
    sig: str = "SIGKILL"      # kill only
    seconds: float = 1.0      # stall_data / stall_step / slow_rank
    until_step: int = -1      # slow_rank only: last straggled step
    #                           (defaults to ``step`` — one slow step)

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown chaos fault kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if self.step < 0:
            raise ValueError(f"chaos fault step must be >= 0, got {self.step}")
        if self.kind in ("stall_data", "stall_step", "slow_rank",
                         "stall_replica") and self.seconds <= 0:
            raise ValueError(f"{self.kind} fault needs seconds > 0")
        if self.kind == "slow_rank":
            if self.until_step < 0:
                object.__setattr__(self, "until_step", self.step)
            elif self.until_step < self.step:
                raise ValueError(
                    f"slow_rank until_step {self.until_step} precedes "
                    f"step {self.step}")


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    faults: tuple

    @classmethod
    def parse(cls, src: str) -> "ChaosPlan":
        """Build a plan from inline JSON, ``@/path/to/plan.json``, or a
        bare path to an existing file. Raises ValueError on anything
        malformed — a chaos run with a silently-empty plan would 'pass'
        without testing anything."""
        text = src.strip()
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        elif not text.startswith("{") and os.path.exists(text):
            with open(text) as f:
                text = f.read()
        try:
            payload = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"chaos plan is not valid JSON: {e}") from e
        raw = payload.get("faults") if isinstance(payload, dict) else payload
        if not isinstance(raw, list) or not raw:
            raise ValueError("chaos plan must carry a non-empty 'faults' list")
        faults: List[ChaosFault] = []
        for i, f in enumerate(raw):
            if not isinstance(f, dict):
                raise ValueError(f"chaos fault #{i} must be an object")
            known = {k: f[k] for k in
                     ("kind", "step", "rank", "sig", "seconds",
                      "until_step") if k in f}
            if set(f) - set(known):
                raise ValueError(f"chaos fault #{i} has unknown keys "
                                 f"{sorted(set(f) - set(known))}")
            faults.append(ChaosFault(**known))
        return cls(faults=tuple(faults))

    def describe(self) -> str:
        return "; ".join(
            f"{f.kind}@step{f.step}/rank{f.rank}"
            + (f" {f.sig}" if f.kind in ("kill", "kill_replica") else "")
            + (f" {f.seconds}s" if f.kind in ("stall_data", "stall_step",
                                              "stall_replica")
               else "")
            + (f" {f.seconds}s/step thru {f.until_step}"
               if f.kind == "slow_rank" else "")
            for f in self.faults)

    def to_json(self) -> str:
        return json.dumps(
            {"faults": [dataclasses.asdict(f) for f in self.faults]})
