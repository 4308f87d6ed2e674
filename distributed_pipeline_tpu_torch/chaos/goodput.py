"""Run-dir artifacts and the goodput ledgers of training runs and of the
serving fleet: every second of a (possibly much-restarted) run accounted
for. The port's copy of ``distributed_pipeline_tpu/chaos/goodput.py``.

In a training run dir:

* ``.progress_rank{k}.json`` — per-rank BEACON, replaced every optimizer
  step by the trainer: current step, wall clock, and the in-attempt
  ``utils/perf.GoodputTracker`` summary so far. A SIGKILLed attempt's last
  beacon is its flight recorder, and the launcher's hang watchdog reads
  the beacons' mtimes as its liveness signal;
* ``goodput_attempt{A:03d}.json`` — rank 0's final goodput record for a
  CLEANLY exited attempt (written at ``run_loop`` exit);
* ``attempts.jsonl`` — the LAUNCHER's per-attempt records (exit code,
  spawn/exit wall clock, step progress from the beacons, downtime,
  resume overhead, hang window, the post-mortem beacon snapshot).

:func:`aggregate_run` folds all three into::

    wall ≈ useful + startup + restore + compile + save + data_stall
           + recompute + hang + lost + downtime

with ``goodput = useful / wall``. A fleet dir holds one ``replica_{i}``
run dir per replica, each supervised by its own launcher ring
(``parallel/launcher.py``), plus the router's durable request
``journal.jsonl``; a replica worker beacons a ``serving`` snapshot and
writes ``serving_attempt{A:03d}.json`` at a clean exit.
:func:`aggregate_serving` folds a fleet dir into::

    serving wall == serving + drain + replay + paid_idle + swap
                    + downtime + lost

with ``accounted_frac == 1.0`` by construction — ``replay`` is the
serving-shaped time whose output was thrown away (work a killed replica
did on requests that later re-ran on a sibling, measured by the router
into the journal), ``drain``/``swap`` are the hot-swap windows, and
``lost`` is attempt wall covered by no snapshot.

An MPMD pipeline run dir (one ``stage_{k}`` launcher-ring dir a stage,
no attempts of its own) folds stage by stage (``_aggregate_pipeline``):
its wall is the summed stage wall, and ``link_wait_s`` is the stages'
blocked link time.

Import-light (no torch): the fleet parent, the pipeline driver and the
launcher read and write these artifacts without torch.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional

__all__ = [
    "beacon_path", "read_beacons", "beacon_max_step", "beacon_mtimes",
    "attempts_path", "append_attempt", "read_attempts",
    "goodput_record_path", "read_goodput_records", "aggregate_run",
    "replica_dir", "replica_id", "list_replica_dirs",
    "serving_journal_path", "read_journal", "serving_record_path",
    "read_serving_records", "aggregate_serving",
]

_BEACON_RE = re.compile(r"\.progress_rank(\d+)\.json$")

# Goodput categories summed across attempts (the JAX tuple:
# utils/perf.GoodputTracker.CATEGORIES, the data stall merged at summary
# time, and the pipeline stages' link_wait_s)
_CATEGORIES = ("startup_s", "setup_s", "restore_s", "compile_s", "save_s",
               "data_stall_s", "recompute_s", "link_wait_s")


def beacon_path(run_dir: str, rank: int) -> str:
    return os.path.join(run_dir, f".progress_rank{rank}.json")


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # torn mid-replace read / dead file: skip


def read_beacons(run_dir: str) -> Dict[int, dict]:
    out: Dict[int, dict] = {}
    for path in glob.glob(os.path.join(run_dir, ".progress_rank*.json")):
        m = _BEACON_RE.search(path)
        payload = _read_json(path) if m else None
        if m and isinstance(payload, dict):
            out[int(m.group(1))] = payload
    return out


def beacon_mtimes(run_dir: str) -> Dict[str, float]:
    """mtime per beacon file — the launcher hang watchdog's liveness
    signal (a worker atomically replaces its beacon every tick, so a
    frozen newest-mtime means no worker is advancing). Lives
    here so the beacon naming has exactly one owner; a beacon caught
    mid-replace is skipped and picked up next poll."""
    out: Dict[str, float] = {}
    for path in glob.glob(os.path.join(run_dir, ".progress_rank*.json")):
        try:
            out[path] = os.stat(path).st_mtime
        except OSError:
            pass
    return out


def beacon_max_step(run_dir: str) -> int:
    """Highest step ANY rank's beacon ever reported — the resume boundary
    for recompute accounting (steps at or below it were already paid for
    by an earlier attempt)."""
    return max((int(b.get("step", 0)) for b in read_beacons(run_dir).values()),
               default=0)


def attempts_path(run_dir: str) -> str:
    return os.path.join(run_dir, "attempts.jsonl")


def append_attempt(run_dir: str, record: dict) -> None:
    with open(attempts_path(run_dir), "a") as f:
        f.write(json.dumps(record) + "\n")


def read_attempts(run_dir: str) -> List[dict]:
    path = attempts_path(run_dir)
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass  # torn tail line from a killed writer
    return out


def goodput_record_path(run_dir: str, attempt: int) -> str:
    return os.path.join(run_dir, f"goodput_attempt{attempt:03d}.json")


def read_goodput_records(run_dir: str) -> Dict[int, dict]:
    out: Dict[int, dict] = {}
    for path in glob.glob(os.path.join(run_dir, "goodput_attempt*.json")):
        payload = _read_json(path)
        if isinstance(payload, dict):
            out[int(payload.get("attempt", 0))] = payload
    return out


# ------------------------------------------------------- serving artifacts

_REPLICA_RE = re.compile(r"replica_(\d+)$")
_SERVING_RECORD_RE = re.compile(r"serving_attempt(\d+)\.json$")


def replica_dir(fleet_dir: str, rid: int) -> str:
    """One replica's run dir inside a fleet dir — the dir its supervising
    launcher ring writes ``attempts.jsonl``/beacons into and its worker
    writes serving sidecars into. Owned here so the fleet writer
    (serving/fleet.py) and the import-light readers agree on the layout
    without serving/ imports."""
    return os.path.join(fleet_dir, f"replica_{rid}")


def list_replica_dirs(fleet_dir: str) -> List[str]:
    out = []
    for path in glob.glob(os.path.join(fleet_dir, "replica_*")):
        if _REPLICA_RE.search(path) and os.path.isdir(path):
            out.append(path)
    return sorted(out, key=replica_id)


def replica_id(replica_dir_path: str) -> int:
    """Replica index encoded in a replica dir path — the one parser for
    the naming :func:`replica_dir` writes (import-light readers must not
    each grow their own slice/regex of it)."""
    m = _REPLICA_RE.search(replica_dir_path)
    if m is None:
        raise ValueError(f"not a replica dir: {replica_dir_path!r}")
    return int(m.group(1))


_STAGE_RE = re.compile(r"stage_(\d+)$")


def stage_dir(run_dir: str, stage: int) -> str:
    """One MPMD pipeline stage's run dir inside a pipeline run dir (the
    stage-side twin of :func:`replica_dir`): ``run.train --mpmd``'s
    stage rings write them, and the readers (``run/status.py``,
    ``obs/export.py``) look for them."""
    return os.path.join(run_dir, f"stage_{stage}")


def list_stage_dirs(run_dir: str) -> List[str]:
    out = []
    for path in glob.glob(os.path.join(run_dir, "stage_*")):
        if _STAGE_RE.search(path) and os.path.isdir(path):
            out.append(path)
    return sorted(out, key=stage_id)


def stage_id(stage_dir_path: str) -> int:
    m = _STAGE_RE.search(stage_dir_path)
    if m is None:
        raise ValueError(f"not a stage dir: {stage_dir_path!r}")
    return int(m.group(1))


def serving_journal_path(fleet_dir: str) -> str:
    """The router's durable request journal (append-only JSONL)."""
    return os.path.join(fleet_dir, "journal.jsonl")


def read_journal(path: str) -> List[dict]:
    """Journal events, torn-tail tolerant (same contract as
    :func:`read_attempts` — a killed router's last line may be partial)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def serving_record_path(run_dir: str, attempt: int) -> str:
    return os.path.join(run_dir, f"serving_attempt{attempt:03d}.json")


def read_serving_records(run_dir: str) -> Dict[int, dict]:
    """Clean-exit serving sidecars per attempt (a filename prefix of their
    own, so the training side's goodput records are never misparsed as
    one)."""
    out: Dict[int, dict] = {}
    for path in glob.glob(os.path.join(run_dir, "serving_attempt*.json")):
        payload = _read_json(path)
        if _SERVING_RECORD_RE.search(path) and isinstance(payload, dict):
            out[int(payload.get("attempt", 0))] = payload
    return out


def _fnum(x: Any, default: float = 0.0) -> float:
    """Defensive number coercion for fields read off disk: a killed
    attempt's artifacts may carry ``null`` (a beacon snapshotted mid-
    build, a record harvested with no beacon at all) or garbage from a
    torn write — the fold must degrade that attempt, never raise."""
    try:
        if isinstance(x, bool) or x is None:
            return default
        return float(x)
    except (TypeError, ValueError):
        return default


def aggregate_run(run_dir: str) -> Dict[str, Any]:
    """Fold a training run's attempts into one goodput decomposition.

    Per attempt, the in-attempt record is the clean-exit sidecar when one
    exists, else the launcher's post-mortem beacon snapshot (a killed
    attempt's flight recorder). Attempt wall not covered by either —
    including whole attempts that died before their first beacon — lands
    in ``lost_s``: genuinely thrown-away time, EXCEPT the watchdog-
    measured ``hang_s`` window, which gets its own category (a wedge the
    watchdog bounded is a different failure than unaccounted loss).
    ``downtime_s`` is the launcher-observed gap between attempts
    (teardown + backoff + spawn).

    Degrades, never raises: a hard-killed attempt with a missing or
    zero-byte sidecar/beacon, or one whose snapshot carries nulls, folds
    as ``lost`` time — ``accounted_frac`` stays 1.0 by construction.
    SERVING attempts in a mixed run dir (a replica dir fed to the
    training fold, or a dir where both halves ran) degrade the same way:
    their artifacts carry a ``serving`` snapshot / ``serving_attempt*``
    sidecar and NO training goodput, so their wall folds to ``lost`` and
    they are counted in ``serving_attempts`` — use
    :func:`aggregate_serving` for the serving-side decomposition. A
    pipeline run dir (``stage_{k}`` dirs and no attempts or sidecars of
    its own) folds stage by stage (:func:`_aggregate_pipeline`).
    """
    attempts = read_attempts(run_dir)
    sidecars = read_goodput_records(run_dir)
    if not attempts and not sidecars:
        stages = list_stage_dirs(run_dir)
        if stages:
            return _aggregate_pipeline(stages)
    serving_recs = read_serving_records(run_dir)
    cats = {c: 0.0 for c in _CATEGORIES}
    useful = lost = downtime = hang = 0.0
    serving_attempts = 0
    per_attempt: List[dict] = []

    def _fold(duration_s: Optional[float], gp: Optional[dict],
              hang_s: float = 0.0):
        nonlocal useful, lost, hang
        hang += hang_s
        if not isinstance(gp, dict):
            gp = None  # a non-dict snapshot (torn write) is no snapshot
        if gp:
            for c in _CATEGORIES:
                cats[c] += _fnum(gp.get(c))
            useful += _fnum(gp.get("useful_step_s"))
            if duration_s is not None:
                lost += max(0.0, duration_s - _fnum(gp.get("wall_s"))
                            - hang_s)
        elif duration_s is not None:
            lost += max(0.0, duration_s - hang_s)

    if attempts:
        for rec in attempts:
            idx = int(_fnum(rec.get("attempt")))
            gp = sidecars.get(idx) or rec.get("goodput") or None
            # a serving attempt (a replica worker under the same launcher)
            # has serving artifacts and no training goodput: its wall
            # degrades to lost here instead of raising or misparsing
            is_serving = (idx in serving_recs
                          or isinstance(rec.get("serving"), dict))
            if is_serving and not isinstance(gp, dict):
                serving_attempts += 1
            downtime += _fnum(rec.get("downtime_s"))
            dur = rec.get("duration_s")
            if isinstance(dur, bool) or not isinstance(dur, (int, float)):
                # null/garbled duration (torn record): re-derive from the
                # spawn/exit stamps so the attempt's wall degrades to
                # lost instead of silently vanishing from the fold
                dur = max(0.0, _fnum(rec.get("t_exit"))
                          - _fnum(rec.get("t_spawn")))
            _fold(float(dur), gp, hang_s=_fnum(rec.get("hang_s")))
            per_attempt.append({**rec,
                                "goodput_source": ("sidecar" if idx in sidecars
                                                   else "beacon"
                                                   if isinstance(gp, dict)
                                                   else "serving"
                                                   if is_serving else None)})
        wall = (_fnum(attempts[-1].get("t_exit"))
                - _fnum(attempts[0].get("t_spawn")))
    else:
        # a launcher-less run (one process): the sidecars are all there is
        for idx in sorted(sidecars):
            _fold(None, sidecars[idx])
            per_attempt.append({"attempt": idx, "goodput_source": "sidecar"})
        wall = sum(_fnum(s.get("wall_s")) for s in sidecars.values())
    wall = max(wall, 1e-9)
    accounted = useful + sum(cats.values()) + hang + lost + downtime
    return {
        "wall_s": wall,
        "useful_step_s": useful,
        "goodput": useful / wall,
        **cats,
        "hang_s": hang,
        "lost_s": lost,
        "downtime_s": downtime,
        "accounted_s": accounted,
        "accounted_frac": accounted / wall,
        "attempts": len(per_attempt),
        "serving_attempts": serving_attempts,
        "per_attempt": per_attempt,
    }


def _aggregate_pipeline(stage_dirs: List[str]) -> Dict[str, Any]:
    """Fold an MPMD pipeline run dir (one ``stage_{k}`` launcher-ring dir
    per stage, no root-level attempts) into ONE decomposition: every
    numeric field sums across the per-stage folds, so ``wall_s`` is
    summed STAGE wall (an S-stage run's wall is ~S x the clock time —
    every stage-second accounted, the same contract as
    :func:`aggregate_serving`'s summed replica wall) and
    ``accounted_frac`` stays 1.0 iff it held per stage. ``per_stage``
    keeps each stage's own fold (minus its per_attempt detail) so a
    restart on stage k is attributable to stage k alone."""
    cats = {c: 0.0 for c in _CATEGORIES}
    useful = lost = downtime = hang = wall = accounted = 0.0
    n_attempts = 0
    serving_attempts = 0
    per_stage: List[dict] = []
    for sd in stage_dirs:
        agg = aggregate_run(sd)
        wall += _fnum(agg.get("wall_s"))
        useful += _fnum(agg.get("useful_step_s"))
        for c in _CATEGORIES:
            cats[c] += _fnum(agg.get(c))
        hang += _fnum(agg.get("hang_s"))
        lost += _fnum(agg.get("lost_s"))
        downtime += _fnum(agg.get("downtime_s"))
        accounted += _fnum(agg.get("accounted_s"))
        n_attempts += int(_fnum(agg.get("attempts")))
        serving_attempts += int(_fnum(agg.get("serving_attempts")))
        per_stage.append({"stage": stage_id(sd),
                          **{k: v for k, v in agg.items()
                             if k != "per_attempt"}})
    wall = max(wall, 1e-9)
    return {
        "wall_s": wall,
        "useful_step_s": useful,
        "goodput": useful / wall,
        **cats,
        "hang_s": hang,
        "lost_s": lost,
        "downtime_s": downtime,
        "accounted_s": accounted,
        "accounted_frac": accounted / wall,
        "attempts": n_attempts,
        "serving_attempts": serving_attempts,
        "stages": len(per_stage),
        "per_stage": per_stage,
        "per_attempt": [],
    }


def aggregate_serving(fleet_dir: str) -> Dict[str, Any]:
    """Fold a serving fleet's artifacts into one ledger::

        wall == serving + drain + replay + paid_idle + swap
                + downtime + lost

    ``wall`` is summed REPLICA wall (each replica's first-spawn ->
    last-exit span, which the launcher's attempt records decompose into
    durations + downtime exactly), so an N-replica fleet's wall is ~N x
    the fleet's clock time — every replica-second is accounted. Per
    attempt, the in-attempt snapshot
    is the clean-exit ``serving_attempt*`` sidecar when one exists, else
    the launcher's post-mortem ``serving`` beacon snapshot; attempt wall
    covered by neither folds to ``lost``. ``replay`` — work a dead or
    wedged replica did on requests that later re-ran on a sibling — is
    ROUTER-attributed (the journal's ``replay`` events carry the wasted
    window) and re-booked out of ``serving``, clamped so the identity
    stays exact — note the windows are PER REQUEST and may overlap the
    same wall period (N requests in flight on one killed replica each
    book their own assign->death window), so under heavy replay the
    clamp can consume all of ``serving``. ``paid_idle`` — the
    autoscaler's journaled unneeded-capacity seconds — is re-booked out
    of ``serving`` with the same clamp discipline (zero when no
    autoscaler ran). Degrades, never raises: a torn or null field folds as lost time.
    """
    serving = drain = swap = lost = downtime = wall = 0.0
    per_replica: List[dict] = []
    n_attempts = 0
    for rd in list_replica_dirs(fleet_dir):
        attempts = read_attempts(rd)
        sidecars = read_serving_records(rd)
        r = {"replica": int(_REPLICA_RE.search(rd).group(1)),
             "attempts": len(attempts), "serving_s": 0.0, "lost_s": 0.0}
        for rec in attempts:
            n_attempts += 1
            idx = int(_fnum(rec.get("attempt")))
            snap = sidecars.get(idx) or rec.get("serving") or None
            if not isinstance(snap, dict):
                snap = None
            downtime += _fnum(rec.get("downtime_s"))
            wall += _fnum(rec.get("downtime_s"))
            dur = rec.get("duration_s")
            if isinstance(dur, bool) or not isinstance(dur, (int, float)):
                dur = max(0.0, _fnum(rec.get("t_exit"))
                          - _fnum(rec.get("t_spawn")))
            dur = float(dur)
            wall += dur
            if snap:
                # the worker's tracker keeps wall == serving + drain +
                # swap identically (serving is the residual), so folding
                # the parts preserves the identity; the uncovered tail
                # (snapshot -> kill) is lost
                d = _fnum(snap.get("drain_s"))
                s = _fnum(snap.get("swap_s"))
                sv = _fnum(snap.get("serving_s"))
                drain += d
                swap += s
                serving += sv
                r["serving_s"] += sv
                att_lost = max(0.0, dur - _fnum(snap.get("wall_s")))
            else:
                att_lost = dur
            lost += att_lost
            r["lost_s"] += att_lost
        per_replica.append(r)
    # Router-attributed replay: serving-shaped time whose output was
    # discarded. Re-booked out of `serving`, clamped to keep the identity
    # exact even against a torn/overstated journal.
    replay_raw = sum(
        _fnum(ev.get("wasted_s"))
        for ev in read_journal(serving_journal_path(fleet_dir))
        if ev.get("ev") == "replay")
    replay = min(max(0.0, replay_raw), serving)
    serving -= replay
    # Autoscaler-attributed paid idle: replica-seconds that were up and
    # ready but UNNEEDED (idle beyond the scaler's floor with an empty
    # queue). Same re-booking discipline as replay: journal deltas
    # summed, clamped against what is left of `serving`, identity exact.
    paid_idle_raw = sum(
        _fnum(ev.get("idle_s"))
        for ev in read_journal(serving_journal_path(fleet_dir))
        if ev.get("ev") == "paid_idle")
    paid_idle = min(max(0.0, paid_idle_raw), serving)
    serving -= paid_idle
    wall = max(wall, 1e-9)
    accounted = (serving + drain + replay + paid_idle + swap + downtime
                 + lost)
    return {
        "wall_s": wall,
        "serving_s": serving,
        "drain_s": drain,
        "replay_s": replay,
        "paid_idle_s": paid_idle,
        "swap_s": swap,
        "downtime_s": downtime,
        "lost_s": lost,
        "accounted_s": accounted,
        "accounted_frac": accounted / wall,
        "replicas": len(per_replica),
        "attempts": n_attempts,
        "per_replica": per_replica,
    }
