"""Timeline export: run/fleet dir artifacts -> Perfetto + Prometheus.

One command turns everything a run (or serving fleet) left on disk into
a single Chrome-trace-event JSON that Perfetto / ``chrome://tracing``
loads directly::

    python -m distributed_pipeline_tpu_torch.obs.export <run_or_fleet_dir>

Four artifact kinds fold into one timeline, each readable on its own
(an UNTRACED run still exports — attempts/beacons/journal carry real
timestamps regardless of ``DPT_TRACE``):

* ``trace_*.jsonl`` shards (:mod:`.trace`): the instrumented spans;
* ``attempts.jsonl``: launcher per-attempt records -> ``attempt``/
  ``downtime`` spans + ``watchdog_kill`` instants;
* ``.progress_rank*.json`` beacons: last-known state instants (a killed
  process's flight recorder, placed at its final beacon time);
* the router ``journal.jsonl`` (fleet dirs): per-request ``queue`` /
  ``service`` spans and ``replay`` wasted-work spans, each carrying the
  request's cross-process trace id — the same id the worker's ``serve``
  span carries, so submit -> assign -> prefill/decode -> complete ->
  replay -> swap stitches into ONE timeline per request.

Layout: one pid per process/replica (rank files and the supervising
launcher's attempt spans share the replica's pid), one track (tid) per
category. Timestamps are normalized to the earliest event.

:func:`prometheus_lines` renders the same artifacts as a Prometheus
textfile snapshot — including the per-replica beacon ``serving``
snapshots, so fleet health is visible LIVE (scrape or ``run/status.py``)
instead of only post-mortem via ``aggregate_serving``.

Import-light: stdlib + the chaos readers; never imports jax.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

from ..chaos import goodput
from . import ledger as ledger_lib
from .trace import read_trace, request_trace_id

__all__ = ["chrome_trace", "collect_sources", "is_fleet_dir",
           "journal_counts", "main", "percentile", "prometheus_lines",
           "write_outputs"]

_SHARD_RE = re.compile(r"trace_([A-Za-z0-9_.-]+)\.jsonl$")


def is_fleet_dir(d: str) -> bool:
    """A fleet dir holds replica_* run dirs and/or the router journal; a
    training run dir holds neither."""
    return bool(goodput.list_replica_dirs(d)) or os.path.exists(
        goodput.serving_journal_path(d))


def percentile(vals: List[float], q: float) -> float:
    """Nearest-rank percentile on a copy-sorted sample (the EventStats
    convention, kept jax/numpy-free for the status CLI); 0.0 when empty."""
    if not vals:
        return 0.0
    v = sorted(vals)
    n = len(v)
    return v[min(n - 1, max(0, -(-int(q * 100) * n // 100) - 1))]


def _fnum(x: Any, default: float = 0.0) -> float:
    try:
        if isinstance(x, bool) or x is None:
            return default
        return float(x)
    except (TypeError, ValueError):
        return default


# ----------------------------------------------------------- event sources

def _shard_events(d: str) -> List[Tuple[str, List[dict]]]:
    """(label, events) per trace shard in ONE directory (non-recursive)."""
    out = []
    for path in sorted(glob.glob(os.path.join(d, "trace_*.jsonl"))):
        m = _SHARD_RE.search(path)
        if m:
            out.append((m.group(1), read_trace(path)))
    return out


def _attempt_events(run_dir: str) -> List[dict]:
    """attempts.jsonl -> internal-format events: one ``attempt`` span per
    record (spawn -> exit), a ``downtime`` span for the gap before it,
    and a ``watchdog_kill`` instant for hang-killed attempts. Used only
    when the dir has no live launcher trace shard (an ARMED launcher
    books the same spans itself; an untraced run still gets its attempt
    timeline from the records)."""
    events: List[dict] = []
    for rec in goodput.read_attempts(run_dir):
        t_spawn = _fnum(rec.get("t_spawn"))
        t_exit = _fnum(rec.get("t_exit"))
        if t_spawn <= 0 or t_exit < t_spawn:
            continue  # torn/garbled record: skip, never raise
        a = rec.get("attempt")
        args = {k: rec.get(k) for k in
                ("rc", "steps", "start_step", "end_step", "nprocs",
                 "devices_per_proc", "resume_overhead_s")
                if rec.get(k) is not None}
        # cat matches the launcher's LIVE spans exactly ("supervise"):
        # one attempt must land on the same track whether the run was
        # traced or reconstructed from the records alone
        events.append({"ph": "X", "name": f"attempt {a}",
                       "cat": "supervise",
                       "t": t_spawn, "dur": t_exit - t_spawn, "args": args})
        down = _fnum(rec.get("downtime_s"))
        if down > 0:
            events.append({"ph": "X", "name": "downtime",
                           "cat": "supervise",
                           "t": t_spawn - down, "dur": down})
        if rec.get("hung"):
            events.append({"ph": "i", "name": "watchdog_kill",
                           "cat": "supervise", "t": t_exit,
                           "args": {"hang_s": rec.get("hang_s"),
                                    "kind": rec.get("hang_kind")}})
    return events


def _tune_trial_events(d: str) -> List[dict]:
    """``tune_trials.jsonl`` -> per-trial spans: the tuner's
    journal is its trace — every measured/pruned trial carries its wall
    stamp and duration, so an UNTRACED tune still exports a timeline
    (the attempts.jsonl pattern; an armed tune tracer books richer spans
    itself and wins — see the caller's shard check). The journal stamps
    ``t`` at trial END, so the span starts at ``t - dur_s``; static
    rejects (no duration) land as instants."""
    events: List[dict] = []
    for row in read_trace(os.path.join(d, "tune_trials.jsonl")):
        if not isinstance(row, dict) or row.get("kind") not in ("trial",
                                                                "final"):
            continue
        t = _fnum(row.get("t"))
        if t <= 0:
            continue
        dur = _fnum(row.get("dur_s"))
        args = {"cid": row.get("cid"), "rung": row.get("rung"),
                "status": row.get("status")}
        res = row.get("result")
        if isinstance(res, dict) and res.get("steps_per_s") is not None:
            args["steps_per_s"] = res.get("steps_per_s")
        if row.get("reason"):
            args["reason"] = row.get("reason")
        name = f"{row.get('kind')} {row.get('cid')}"
        if dur > 0:
            events.append({"ph": "X", "name": name, "cat": "tune",
                           "t": t - dur, "dur": dur, "args": args})
        else:
            events.append({"ph": "i", "name": name, "cat": "tune",
                           "t": t, "args": args})
    return events


def _ledger_events(run_dir: str) -> List[dict]:
    """``perf_ledger.json`` -> Perfetto COUNTER events (ph "C"): one
    counter track per program carrying mfu + the roofline gap terms,
    plus a bytes track for the collective payload — the attribution as
    a timeline series next to the spans it explains. The ledger is a
    snapshot (atomically replaced each log window), so each export
    carries one sample at the snapshot's wall stamp; Perfetto renders a
    counter with the value held from that point."""
    led = ledger_lib.read_ledger(run_dir)
    if not led:
        return []
    t = _fnum(led.get("t"))
    if t <= 0:
        return []
    events: List[dict] = []
    for name, row in sorted((led.get("programs") or {}).items()):
        if "mfu" not in row:
            continue
        series = {"mfu": row["mfu"],
                  **{k: row.get(k, 0.0) for k in ledger_lib.GAP_TERMS},
                  "padding_waste_frac": row.get("padding_waste_frac",
                                                0.0)}
        events.append({"ph": "C", "name": f"roofline {name}",
                       "cat": "ledger", "t": t,
                       "args": {k: round(_fnum(v), 6)
                                for k, v in series.items()}})
        if row.get("collective_bytes_per_step"):
            events.append({"ph": "C", "name": f"collective_bytes {name}",
                           "cat": "ledger", "t": t,
                           "args": {"bytes_per_step": _fnum(
                               row["collective_bytes_per_step"])}})
    return events


def _beacon_events(run_dir: str) -> Dict[int, dict]:
    """rank -> one ``beacon`` instant at the rank's LAST beacon time (a
    killed attempt's flight-recorder position on the timeline)."""
    out: Dict[int, dict] = {}
    for rank, b in goodput.read_beacons(run_dir).items():
        t = _fnum(b.get("t"))
        if t <= 0:
            continue
        args = {k: b.get(k) for k in
                ("step", "attempt", "steady_recompile_count")
                if b.get(k) is not None}
        snap = b.get("serving") or b.get("goodput")
        if isinstance(snap, dict):
            args.update({k: v for k, v in snap.items()
                         if isinstance(v, (int, float))})
        out[rank] = {"ph": "i", "name": "last_beacon", "cat": "beacon",
                     "t": t, "args": args}
    return out


def journal_counts(events: List[dict]) -> dict:
    """Request-state machine over the router journal, shared by the
    Prometheus snapshot and the status CLI (one owner: the two live
    views of the same fleet dir must never disagree): submitted/
    completed/in-flight/replayed totals, per-replica assigned-in-flight,
    and TTFT percentiles from the completion events."""
    subs: set = set()
    done: set = set()
    where: Dict[int, int] = {}  # req id -> replica currently assigned
    replays = 0
    ttfts: List[float] = []
    affinity_hits = 0
    scale_ups = scale_downs = 0
    paid_idle_s = 0.0
    for ev in events:
        kind = ev.get("ev")
        try:
            rid = int(ev.get("id")) if ev.get("id") is not None else None
        except (TypeError, ValueError):
            rid = None
        if kind == "submit" and rid is not None:
            subs.add(rid)
        elif kind == "assign" and rid is not None:
            if _fnum(ev.get("affinity")) > 0:
                affinity_hits += 1
            try:
                where[rid] = int(ev.get("replica"))
            except (TypeError, ValueError):
                pass
        elif kind == "scale":
            if ev.get("dir") == "up":
                scale_ups += 1
            elif ev.get("dir") == "down":
                scale_downs += 1
        elif kind == "paid_idle":
            paid_idle_s += _fnum(ev.get("idle_s"))
        elif kind == "complete" and rid is not None:
            done.add(rid)
            where.pop(rid, None)
            if ev.get("ttft_s") is not None:
                ttfts.append(_fnum(ev.get("ttft_s")))
        elif kind == "replay":
            replays += 1
            if rid is not None:
                where.pop(rid, None)
    per_replica: Dict[int, int] = {}
    for rep in where.values():
        per_replica[rep] = per_replica.get(rep, 0) + 1
    return {
        "submitted": len(subs),
        "completed": len(done),
        "in_flight": len(subs - done),
        "replayed": replays,
        "assigned": per_replica,
        "ttfts": ttfts,
        "ttft_p50_s": (round(percentile(ttfts, 0.5), 4)
                       if ttfts else None),
        "ttft_p95_s": (round(percentile(ttfts, 0.95), 4)
                       if ttfts else None),
        "affinity_hits": affinity_hits,
        "scale_ups": scale_ups,
        "scale_downs": scale_downs,
        "paid_idle_s": round(paid_idle_s, 4),
    }


def _request_trace_id(ev: dict) -> Optional[str]:
    tid = ev.get("trace")
    if tid:
        return str(tid)
    rid = ev.get("id")  # pre-trace journal: rederive the minted id
    try:
        return request_trace_id(int(rid)) if rid is not None else None
    except (TypeError, ValueError):
        return None


def _journal_events(fleet_dir: str) -> List[dict]:
    """Router journal -> per-request lifecycle spans. The journal is the
    router's trace: every event carries request identity (and, since
    tracing landed, the explicit trace id), so queue/service/replay
    spans need no separate shard."""
    events: List[dict] = []
    pending_since: Dict[int, float] = {}
    assigned: Dict[int, Tuple[float, Any]] = {}
    for ev in read_trace(goodput.serving_journal_path(fleet_dir)):
        kind = ev.get("ev")
        t = _fnum(ev.get("t"))
        tid = _request_trace_id(ev)
        try:
            rid = int(ev.get("id")) if ev.get("id") is not None else None
        except (TypeError, ValueError):
            rid = None
        if kind == "submit" and rid is not None:
            pending_since[rid] = t
            events.append({"ph": "i", "name": "submit", "cat": "request",
                           "t": t, "trace": tid,
                           "args": {"id": rid,
                                    "max_new_tokens":
                                        ev.get("max_new_tokens")}})
        elif kind == "assign" and rid is not None:
            t0 = pending_since.pop(rid, t)
            events.append({"ph": "X", "name": "queue", "cat": "request",
                           "t": t0, "dur": max(0.0, t - t0), "trace": tid,
                           "args": {"id": rid,
                                    "replica": ev.get("replica")}})
            assigned[rid] = (t, ev.get("replica"))
        elif kind == "complete" and rid is not None:
            t0, replica = assigned.pop(rid, (t, ev.get("replica")))
            events.append({"ph": "X", "name": "service", "cat": "request",
                           "t": t0, "dur": max(0.0, t - t0), "trace": tid,
                           "args": {"id": rid, "replica": replica,
                                    "n_tokens": ev.get("n_tokens"),
                                    "ttft_s": ev.get("ttft_s")}})
        elif kind == "replay" and rid is not None:
            t0, replica = assigned.pop(rid, (t, ev.get("from")))
            pending_since[rid] = t
            events.append({"ph": "X", "name": "replayed_work",
                           "cat": "replay", "t": t0,
                           "dur": max(0.0, t - t0), "trace": tid,
                           "args": {"id": rid, "from": ev.get("from"),
                                    "reason": ev.get("reason"),
                                    "wasted_s": ev.get("wasted_s")}})
        elif kind == "replica_down":
            events.append({"ph": "i", "name": "replica_down",
                           "cat": "replay", "t": t,
                           "args": {"replica": ev.get("replica")}})
        elif kind == "scale":
            events.append({"ph": "i",
                           "name": f"scale_{ev.get('dir')}",
                           "cat": "autoscale", "t": t,
                           "args": {"replica": ev.get("replica"),
                                    "reason": ev.get("reason"),
                                    "n_active": ev.get("n_active")}})
    return events


def collect_sources(d: str) -> List[Tuple[int, str, List[dict]]]:
    """(pid, process_name, internal events) per process/replica.

    Training run dir: pid 1 = launcher (its trace shard + the
    attempts.jsonl conversion), pid 10+k per rank shard (+ its beacon).
    Fleet dir: pid 1 = router (journal + any fleet-root shards), pid
    10+i per replica — the replica's worker shard, its supervising
    ring's attempt spans, and its beacon share the replica's pid (one
    pid per process/replica; categories separate the tracks)."""
    sources: List[Tuple[int, str, List[dict]]] = []
    if is_fleet_dir(d):
        router_events = _journal_events(d)
        for label, events in _shard_events(d):
            router_events.extend(events)
        sources.append((1, "router", router_events))
        for rd in goodput.list_replica_dirs(d):
            rid = goodput.replica_id(rd)
            shards = _shard_events(rd)
            events = [ev for _, shard in shards for ev in shard]
            if not any(label.startswith("launcher") for label, _ in shards):
                events.extend(_attempt_events(rd))
            events.extend(_beacon_events(rd).values())
            # per-replica roofline counter tracks (--cost_ledger workers)
            events.extend(_ledger_events(rd))
            sources.append((10 + rid, f"replica_{rid}", events))
        return sources
    stage_dirs = goodput.list_stage_dirs(d)
    if stage_dirs:
        # MPMD pipeline run: pid 1 = the jax-free host driver
        # (its own shard lives in the run-dir root), pid 10+k per stage —
        # the stage worker's shard, its supervising ring's attempt spans,
        # and its beacon (the replica pattern). Cross-process microbatch
        # stitching rides the trace ids the links carry in frame meta.
        driver_events = [ev for _, events in _shard_events(d)
                         for ev in events]
        sources.append((1, "driver", driver_events))
        for sd in stage_dirs:
            sid = goodput.stage_id(sd)
            shards = _shard_events(sd)
            events = [ev for _, shard in shards for ev in shard]
            if not any(label.startswith("launcher")
                       for label, _ in shards):
                events.extend(_attempt_events(sd))
            events.extend(_beacon_events(sd).values())
            sources.append((10 + sid, f"stage_{sid}", events))
        return sources
    rank_shards: Dict[int, List[dict]] = {}
    launcher_events: List[dict] = []
    have_launcher_shard = False
    have_tune_shard = False
    for label, events in _shard_events(d):
        m = re.fullmatch(r"rank(\d+)", label)
        if m:
            rank_shards.setdefault(int(m.group(1)), []).extend(events)
        else:
            have_launcher_shard = (have_launcher_shard
                                   or label.startswith("launcher"))
            have_tune_shard = have_tune_shard or label.startswith("tune")
            launcher_events.extend(events)
    if not have_launcher_shard:
        launcher_events.extend(_attempt_events(d))
    if not have_tune_shard:
        # untraced tune runs: the trial journal is the span source (the
        # attempts.jsonl pattern; an armed tune tracer wins)
        launcher_events.extend(_tune_trial_events(d))
    # cost-ledger counter tracks (--cost_ledger runs) ride the launcher
    # pid: one roofline series per program
    launcher_events.extend(_ledger_events(d))
    beacons = _beacon_events(d)
    for rank, ev in beacons.items():
        rank_shards.setdefault(rank, []).append(ev)
    sources.append((1, "launcher", launcher_events))
    for rank in sorted(rank_shards):
        sources.append((10 + rank, f"rank{rank}", rank_shards[rank]))
    return sources


# ------------------------------------------------------------ chrome trace

def chrome_trace(d: str) -> dict:
    """Fold one run/fleet dir into a Chrome-trace-event dict (load the
    written file directly in Perfetto / chrome://tracing)."""
    sources = [(pid, name, evs) for pid, name, evs in collect_sources(d)
               if evs]
    base = min((_fnum(ev.get("t"))
                for _, _, evs in sources for ev in evs
                if _fnum(ev.get("t")) > 0), default=0.0)
    trace_events: List[dict] = []
    for pid, pname, events in sources:
        trace_events.append({"ph": "M", "name": "process_name", "pid": pid,
                             "tid": 0, "args": {"name": pname}})
        cats = sorted({str(ev.get("cat", "misc")) for ev in events})
        tid_of = {c: i + 1 for i, c in enumerate(cats)}
        for cat, tid in tid_of.items():
            trace_events.append({"ph": "M", "name": "thread_name",
                                 "pid": pid, "tid": tid,
                                 "args": {"name": cat}})
        for ev in events:
            t = _fnum(ev.get("t"))
            if t <= 0:
                continue
            cat = str(ev.get("cat", "misc"))
            args = dict(ev.get("args") or {})
            for key, out_key in (("trace", "trace_id"), ("sid", "span_id"),
                                 ("parent", "parent_id")):
                if ev.get(key):
                    args[out_key] = ev[key]
            if ev.get("ph") == "C":
                # counter sample: args ARE the series values (numeric
                # only — Perfetto draws one line per key)
                trace_events.append({
                    "name": str(ev.get("name", "?")), "cat": cat,
                    "ph": "C", "pid": pid, "tid": tid_of[cat],
                    "ts": round((t - base) * 1e6, 1),
                    "args": {k: _fnum(v) for k, v in args.items()}})
                continue
            ch = {"name": str(ev.get("name", "?")), "cat": cat,
                  "ph": "i" if ev.get("ph") == "i" else "X",
                  "pid": pid, "tid": tid_of[cat],
                  "ts": round((t - base) * 1e6, 1), "args": args}
            if ch["ph"] == "X":
                ch["dur"] = round(max(0.0, _fnum(ev.get("dur"))) * 1e6, 1)
            else:
                ch["s"] = "t"
            trace_events.append(ch)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"source_dir": os.path.abspath(d),
                          "base_wall_clock_s": base}}


# -------------------------------------------------------------- prometheus

class _Prom:
    """Tiny metric-family accumulator -> textfile lines."""

    def __init__(self) -> None:
        self._fams: Dict[str, Tuple[str, List[Tuple[str, float]]]] = {}

    def add(self, name: str, value: Any, labels: Optional[dict] = None,
            help_: str = "") -> None:
        v = _fnum(value, default=float("nan"))
        if v != v:  # non-numeric: skip rather than emit NaN
            return
        lab = ""
        if labels:
            inner = ",".join(f'{k}="{v2}"' for k, v2 in sorted(
                labels.items()))
            lab = "{" + inner + "}"
        fam = self._fams.setdefault(name, (help_, []))
        fam[1].append((lab, v))

    def lines(self) -> List[str]:
        out: List[str] = []
        for name, (help_, samples) in self._fams.items():
            if help_:
                out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} gauge")
            for lab, v in samples:
                out.append(f"{name}{lab} {v:g}")
        return out


def _prom_run(p: _Prom, run_dir: str, now: float,
              labels: Optional[dict] = None) -> None:
    for rank, b in sorted(goodput.read_beacons(run_dir).items()):
        lab = {**(labels or {}), "rank": rank}
        p.add("dpt_beacon_step", b.get("step"), lab,
              help_="last step any beacon reported")
        p.add("dpt_beacon_age_seconds", now - _fnum(b.get("t")), lab,
              help_="seconds since the rank's last beacon write")
        p.add("dpt_beacon_attempt", b.get("attempt"), lab)
    attempts = goodput.read_attempts(run_dir)
    if attempts:
        p.add("dpt_attempts_total", len(attempts), labels,
              help_="launcher attempts recorded")
        p.add("dpt_last_attempt_rc", attempts[-1].get("rc"), labels)
    agg = goodput.aggregate_run(run_dir)
    if agg["attempts"]:
        p.add("dpt_goodput", agg["goodput"], labels,
              help_="useful-step share of accounted wall time")
        p.add("dpt_accounted_frac", agg["accounted_frac"], labels)
        for cat in ("useful_step_s", "startup_s", "setup_s", "restore_s",
                    "compile_s", "save_s", "data_stall_s", "link_wait_s",
                    "recompute_s", "hang_s", "lost_s", "downtime_s"):
            p.add("dpt_goodput_seconds", agg[cat],
                  {**(labels or {}), "category": cat[:-2]},
                  help_="goodput ledger decomposition (seconds)")
    _prom_ledger(p, run_dir, labels)


def _prom_ledger(p: _Prom, run_dir: str,
                 labels: Optional[dict] = None) -> None:
    """perf_ledger.json -> dpt_mfu/gap gauges. One owner shared by the
    training-run and per-replica fleet snapshots (a replica worker with
    --cost_ledger writes the same file into its replica dir)."""
    led = ledger_lib.read_ledger(run_dir)
    for name, row in sorted(((led or {}).get("programs") or {}).items()):
        if "mfu" not in row:
            continue
        lab = {**(labels or {}), "program": name}
        p.add("dpt_mfu", row["mfu"], lab,
              help_="measured model-FLOPs utilization per program "
                    "(perf_ledger.json)")
        for term in ledger_lib.GAP_TERMS:
            p.add("dpt_mfu_gap", row.get(term),
                  {**lab, "component": term.replace("mfu_gap_", "")},
                  help_="roofline MFU-gap decomposition "
                        "(sums with dpt_mfu to 1)")
        p.add("dpt_collective_bytes_per_step",
              row.get("collective_bytes_per_step"), lab,
              help_="HLO-tallied collective payload per step")
        p.add("dpt_padding_waste_frac", row.get("padding_waste_frac"),
              lab, help_="share of step tokens that are padding")
        if row.get("accept_rate") is not None:
            # speculative-decoding gauges: only the decode
            # program of a --spec_tokens replica/run carries them
            p.add("dpt_accept_rate", row.get("accept_rate"), lab,
                  help_="draft-token acceptance rate under speculative "
                        "decoding (perf_ledger.json)")
            p.add("dpt_accepted_tokens_per_s",
                  row.get("accepted_tokens_per_s"), lab,
                  help_="target-verified tokens per second under "
                        "speculative decoding")


def _prom_fleet(p: _Prom, fleet_dir: str, now: float) -> None:
    from ..serving.transport import ReplicaPaths, read_json_file

    for rd in goodput.list_replica_dirs(fleet_dir):
        rid = goodput.replica_id(rd)
        lab = {"replica": rid}
        paths = ReplicaPaths.at(rd, rid)
        ready = read_json_file(paths.ready_path)
        p.add("dpt_replica_ready", 1 if ready else 0, lab,
              help_="replica announced ready (current attempt)")
        if ready:
            p.add("dpt_replica_params_step", ready.get("params_step"), lab,
                  help_="checkpoint step the replica serves")
        beacons = goodput.read_beacons(rd)
        b = beacons.get(0)
        if b:
            p.add("dpt_replica_tick", b.get("step"), lab)
            p.add("dpt_replica_beacon_age_seconds",
                  now - _fnum(b.get("t")), lab,
                  help_="staleness of the replica's liveness beacon")
            p.add("dpt_replica_attempt", b.get("attempt"), lab)
            snap = b.get("serving")
            if isinstance(snap, dict):
                # the LIVE serving-time decomposition (satellite: fleet
                # health visible now, not only post-mortem)
                for cat in ("wall_s", "serving_s", "drain_s", "swap_s"):
                    p.add("dpt_replica_serving_seconds", snap.get(cat),
                          {**lab, "category": cat[:-2]},
                          help_="in-attempt serving-time decomposition "
                                "from the replica's beacon")
            if b.get("accept_rate") is not None:
                # live speculative gauges off the beacon (no --cost_ledger
                # needed): same names the ledger path emits per program
                p.add("dpt_accept_rate", b.get("accept_rate"), lab,
                      help_="draft-token acceptance rate under "
                            "speculative decoding (perf_ledger.json)")
                p.add("dpt_accepted_tokens_per_s",
                      b.get("accepted_tokens_per_s"), lab,
                      help_="target-verified tokens per second under "
                            "speculative decoding")
            if b.get("prefix_hits") is not None:
                p.add("dpt_replica_prefix_cache_total",
                      b.get("prefix_hits"), {**lab, "kind": "hit"},
                      help_="prefix-cache hits/misses advertised on the "
                            "replica's beacon")
                p.add("dpt_replica_prefix_cache_total",
                      b.get("prefix_misses"), {**lab, "kind": "miss"})
        attempts = goodput.read_attempts(rd)
        if attempts:
            p.add("dpt_replica_attempts_total", len(attempts), lab)
        # per-replica roofline: a --cost_ledger replica worker snapshots
        # perf_ledger.json into its replica dir
        _prom_ledger(p, rd, lab)
    events = read_trace(goodput.serving_journal_path(fleet_dir))
    if events:
        counts = journal_counts(events)
        p.add("dpt_requests_total", counts["submitted"],
              {"state": "submitted"},
              help_="router journal request counts")
        p.add("dpt_requests_total", counts["completed"],
              {"state": "completed"})
        p.add("dpt_requests_total", counts["replayed"],
              {"state": "replayed"})
        p.add("dpt_requests_in_flight", counts["in_flight"],
              help_="submitted but not yet completed")
        if counts["ttfts"]:
            p.add("dpt_ttft_seconds", counts["ttft_p50_s"],
                  {"quantile": "0.5"},
                  help_="time-to-first-token from journal completions")
            p.add("dpt_ttft_seconds", counts["ttft_p95_s"],
                  {"quantile": "0.95"})
        p.add("dpt_affinity_hits_total", counts["affinity_hits"],
              help_="placements won by a warm advertised prefix")
        p.add("dpt_scale_events_total", counts["scale_ups"],
              {"dir": "up"},
              help_="autoscaler structural changes from the journal")
        p.add("dpt_scale_events_total", counts["scale_downs"],
              {"dir": "down"})
    agg = goodput.aggregate_serving(fleet_dir)
    if agg["attempts"]:
        p.add("dpt_serving_accounted_frac", agg["accounted_frac"])
        for cat in ("serving_s", "drain_s", "replay_s", "paid_idle_s",
                    "swap_s", "downtime_s", "lost_s"):
            p.add("dpt_serving_seconds", agg[cat],
                  {"category": cat[:-2]},
                  help_="fleet serving ledger decomposition (seconds)")


def prometheus_lines(d: str, now: Optional[float] = None) -> List[str]:
    """Prometheus-textfile snapshot of a run or fleet dir (node_exporter
    textfile-collector format; every metric is a point-in-time gauge)."""
    now = time.time() if now is None else now
    p = _Prom()
    if is_fleet_dir(d):
        _prom_fleet(p, d, now)
    else:
        _prom_run(p, d, now)
    return p.lines()


# --------------------------------------------------------------------- CLI

def write_outputs(d: str, out: str = "", prom: str = "") -> dict:
    """Write the Perfetto JSON (and optionally the Prometheus snapshot);
    returns a summary dict (also the CLI's stdout line)."""
    out = out or os.path.join(d, "trace.json")
    payload = chrome_trace(d)
    with open(out, "w") as f:
        json.dump(payload, f)
    summary = {"dir": os.path.abspath(d),
               "kind": "fleet" if is_fleet_dir(d) else "run",
               "trace_json": os.path.abspath(out),
               "events": len(payload["traceEvents"])}
    if prom:
        lines = prometheus_lines(d)
        with open(prom, "w") as f:
            f.write("\n".join(lines) + "\n")
        summary["prometheus"] = os.path.abspath(prom)
        summary["metrics"] = len(lines)
    return summary


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Export a run/fleet dir's artifacts as one "
                    "Perfetto-loadable timeline (+ optional Prometheus "
                    "textfile snapshot). Load the JSON at "
                    "https://ui.perfetto.dev or chrome://tracing.")
    ap.add_argument("dir", help="run dir (training) or fleet dir (serving)")
    ap.add_argument("--out", default="",
                    help="output JSON path (default <dir>/trace.json)")
    ap.add_argument("--prom", default="",
                    help="also write a Prometheus textfile snapshot here")
    ns = ap.parse_args(argv)
    summary = write_outputs(ns.dir, ns.out, ns.prom)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
