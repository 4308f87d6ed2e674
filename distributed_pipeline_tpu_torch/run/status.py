"""Live run/fleet status: a read-only aggregator over the telemetry files.

Tails the artifacts every layer already writes — per-rank beacons,
``attempts.jsonl``, per-replica ``ready.json``/``serving`` snapshots, the
router ``journal.jsonl`` — and prints a fleet-wide status table: per-rank
or per-replica health, step/tick progress, goodput, in-flight requests,
and TTFT percentiles. NEVER imports jax (it must be runnable next to a
wedged run without competing for the machine), never writes into the run
dir, and reads with the same torn-tolerant readers the goodput fold uses,
so a mid-write beacon or a killed router's half line can't crash it.

    python -m distributed_pipeline_tpu_torch.run.status <run_or_fleet_dir>
    python -m distributed_pipeline_tpu_torch.run.status <dir> --watch 2
    python -m distributed_pipeline_tpu_torch.run.status <dir> --export t.json \
        --prom metrics.prom          # one-shot Perfetto + Prometheus dump
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, List, Optional

from ..chaos import goodput
from ..obs import export as export_lib
from ..obs import ledger as ledger_lib

__all__ = ["fleet_status", "main", "pipeline_status", "render",
           "run_status", "status"]


def _num(v: Any, ndigits: int) -> Optional[float]:
    """round() when the value is a real number, None otherwise (missing
    telemetry renders as '-' in the table, never a fabricated 0)."""
    return round(float(v), ndigits) if isinstance(v, (int, float)) else None


def _age(now: float, t: Any) -> Optional[float]:
    try:
        return max(0.0, now - float(t)) if t else None
    except (TypeError, ValueError):
        return None


# ------------------------------------------------------------ training run

def run_status(run_dir: str, now: Optional[float] = None,
               stale_s: float = 10.0) -> dict:
    """Training-run snapshot: one row per rank beacon (latest step,
    in-attempt steps/s, goodput) + attempt summary + the goodput fold —
    and, when the run carries a perf ledger (``--cost_ledger``), the
    train step's MFU with its roofline gap decomposition."""
    now = time.time() if now is None else now
    rows = []
    for rank, b in sorted(goodput.read_beacons(run_dir).items()):
        age = _age(now, b.get("t"))
        gp = b.get("goodput") if isinstance(b.get("goodput"), dict) else {}
        # in-attempt rate from the beacon's own facts: steps this attempt
        # advanced over its accounted wall (both written by the trainer)
        sps = None
        try:
            advanced = int(b.get("step", 0)) - int(b.get("start_step", 0))
            wall = float(gp.get("wall_s") or 0.0)
            if advanced > 0 and wall > 0:
                sps = round(advanced / wall, 4)
        except (TypeError, ValueError):
            pass
        rows.append({
            "rank": rank,
            "attempt": b.get("attempt"),
            "step": b.get("step"),
            "steps_per_s": sps,
            "beacon_age_s": round(age, 1) if age is not None else None,
            "state": ("stale" if age is not None and age > stale_s
                      else "advancing"),
            "goodput": gp.get("goodput"),
            "steady_recompiles": b.get("steady_recompile_count"),
        })
    attempts = goodput.read_attempts(run_dir)
    agg = goodput.aggregate_run(run_dir) if (attempts or rows) else None
    snap = {
        "kind": "run",
        "dir": os.path.abspath(run_dir),
        "step": max((r["step"] for r in rows
                     if isinstance(r.get("step"), int)), default=None),
        "ranks": rows,
        "attempts": len(attempts),
        "last_rc": attempts[-1].get("rc") if attempts else None,
        "goodput": (round(agg["goodput"], 4) if agg else None),
        "accounted_frac": (round(agg["accounted_frac"], 4) if agg
                           else None),
    }
    led = ledger_lib.read_ledger(run_dir)
    tr = (led or {}).get("programs", {}).get("train_step")
    if tr and "mfu" in tr:
        snap["mfu"] = round(tr["mfu"], 4)
        snap["mfu_gaps"] = {k: round(tr.get(k, 0.0), 4)
                            for k in ledger_lib.GAP_TERMS}
        snap["collective_bytes_per_step"] = tr.get(
            "collective_bytes_per_step")
        snap["padding_waste_frac"] = round(
            tr.get("padding_waste_frac", 0.0), 4)
    return snap


# ------------------------------------------------------------ MPMD pipeline

def pipeline_status(run_dir: str, now: Optional[float] = None,
                    stale_s: float = 10.0) -> dict:
    """MPMD pipeline snapshot: one row per STAGE — each stage
    is its own supervised launcher ring, so health is per-stage: ready
    announce (attempt + params_step), beacon liveness, per-stage goodput
    including the link_wait share, and the ring's attempt count. The
    bottom line folds the whole pipeline with the per-stage goodput
    aggregator (chaos/goodput.py)."""
    now = time.time() if now is None else now
    try:
        with open(os.path.join(run_dir, "mpmd_config.json")) as f:
            cfg = json.load(f)
    except (OSError, ValueError):
        cfg = {}
    rows = []
    for sd in goodput.list_stage_dirs(run_dir):
        sid = goodput.stage_id(sd)
        try:
            with open(os.path.join(sd, "ready.json")) as f:
                ready = json.load(f)
        except (OSError, ValueError):
            ready = None
        b = goodput.read_beacons(sd).get(0) or {}
        age = _age(now, b.get("t"))
        if ready is None and not b:
            state = "init"
        elif age is not None and age > stale_s:
            state = "stale"
        elif ready is None:
            state = "starting"
        else:
            state = "advancing"
        gp = b.get("goodput") if isinstance(b.get("goodput"), dict) else {}
        # stage beacons carry the raw HostGoodput decomposition; the
        # ratio is useful step time over this attempt's wall
        ratio = None
        try:
            wall = float(gp.get("wall_s") or 0.0)
            if wall > 0:
                ratio = round(float(gp.get("useful_step_s", 0.0)) / wall, 4)
        except (TypeError, ValueError):
            pass
        rows.append({
            "stage": sid,
            "state": state,
            "attempt": b.get("attempt", ready.get("attempt")
                             if ready else None),
            "params_step": ready.get("params_step") if ready else None,
            "step": b.get("step"),
            "beacon_age_s": round(age, 1) if age is not None else None,
            "link_wait_s": gp.get("link_wait_s"),
            "goodput": ratio,
            "steady_recompiles": b.get("steady_recompile_count"),
            "attempts": len(goodput.read_attempts(sd)),
        })
    agg = goodput.aggregate_run(run_dir) if rows else None
    return {
        "kind": "pipeline",
        "dir": os.path.abspath(run_dir),
        "n_stages": cfg.get("n_stages", len(rows)),
        "schedule": cfg.get("schedule"),
        "step": min((r["params_step"] for r in rows
                     if isinstance(r.get("params_step"), int)),
                    default=None),
        "stages": rows,
        "goodput": (round(agg["goodput"], 4) if agg else None),
        "link_wait_s": (round(agg.get("link_wait_s", 0.0), 4) if agg
                        else None),
        "accounted_frac": (round(agg["accounted_frac"], 4) if agg
                           else None),
    }


# ------------------------------------------------------------ serving fleet

def fleet_status(fleet_dir: str, now: Optional[float] = None,
                 stale_s: float = 10.0) -> dict:
    """Fleet snapshot: per-replica health (ready/stale/init), serving
    version + attempt, the LIVE serving-time decomposition from each
    beacon, and router-journal request/TTFT counters."""
    from ..serving.transport import ReplicaPaths, read_json_file

    now = time.time() if now is None else now
    rows = []
    for rd in goodput.list_replica_dirs(fleet_dir):
        rid = goodput.replica_id(rd)
        paths = ReplicaPaths.at(rd, rid)
        ready = read_json_file(paths.ready_path)
        b = goodput.read_beacons(rd).get(0) or {}
        age = _age(now, b.get("t"))
        snap = b.get("serving") if isinstance(b.get("serving"), dict) else {}
        if ready is None and not b:
            state = "init"
        elif age is not None and age > stale_s:
            state = "stale"
        elif ready is None:
            state = "starting"
        else:
            state = "ready"
        # per-replica roofline (the replica's --cost_ledger snapshot in
        # its own run dir): decode-phase MFU live
        led = ledger_lib.read_ledger(rd)
        dec = (led or {}).get("programs", {}).get("serve_decode") or {}
        ph, pm = b.get("prefix_hits"), b.get("prefix_misses")
        hit_rate = None
        if isinstance(ph, int) and isinstance(pm, int) and ph + pm > 0:
            hit_rate = round(ph / (ph + pm), 4)
        rows.append({
            "replica": rid,
            "state": state,
            "attempt": b.get("attempt", ready.get("attempt")
                             if ready else None),
            "params_step": ready.get("params_step") if ready else None,
            "tick": b.get("step"),
            "beacon_age_s": round(age, 1) if age is not None else None,
            "serving_s": snap.get("serving_s"),
            "drain_s": snap.get("drain_s"),
            "swap_s": snap.get("swap_s"),
            "prefix_hit_rate": hit_rate,
            "mfu": (round(float(dec["mfu"]), 4)
                    if isinstance(dec.get("mfu"), (int, float))
                    else None),
            # decode is memory-bound: this one gap term IS the kernel
            # headroom (ops/flash_decode.py), so the fleet table shows it
            # per replica next to the MFU it explains
            "mfu_gap_memory_bound": (
                round(float(dec["mfu_gap_memory_bound"]), 4)
                if isinstance(dec.get("mfu_gap_memory_bound"),
                              (int, float)) else None),
            "tokens_per_s": (round(float(dec["tokens_per_s"]), 1)
                             if isinstance(dec.get("tokens_per_s"),
                                           (int, float)) else None),
            # speculative gauges: ledger row when --cost_ledger
            # is on, else the live beacon extras — None when not serving
            # speculatively, so the column reads '-' instead of lying 0
            "accept_rate": _num(dec.get("accept_rate",
                                        b.get("accept_rate")), 4),
            "accepted_tokens_per_s": _num(
                dec.get("accepted_tokens_per_s",
                        b.get("accepted_tokens_per_s")), 1),
            "attempts": len(goodput.read_attempts(rd)),
        })
    events = goodput.read_journal(goodput.serving_journal_path(fleet_dir))
    # one owner for the journal fold (obs.export.journal_counts): the
    # status table and the Prometheus snapshot can never disagree
    counts = export_lib.journal_counts(events)
    for row in rows:
        row["in_flight"] = counts["assigned"].get(row["replica"], 0)
    return {
        "kind": "fleet",
        "dir": os.path.abspath(fleet_dir),
        "replicas": rows,
        **{k: v for k, v in counts.items()
           if k not in ("assigned", "ttfts")},
    }


def status(d: str, now: Optional[float] = None,
           stale_s: float = 10.0) -> dict:
    if export_lib.is_fleet_dir(d):
        return fleet_status(d, now, stale_s)
    if (os.path.exists(os.path.join(d, "mpmd_config.json"))
            or goodput.list_stage_dirs(d)):
        return pipeline_status(d, now, stale_s)
    return run_status(d, now, stale_s)


# -------------------------------------------------------------- rendering

def _table(headers: List[str], rows: List[List[Any]]) -> str:
    cells = [[("-" if v is None else str(v)) for v in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*row) for row in cells]
    return "\n".join(lines)


def render(snap: dict) -> str:
    out = [f"[{snap['kind']}] {snap['dir']}"]
    if snap["kind"] == "fleet":
        headers = ["replica", "state", "attempt", "params_step", "tick",
                   "beacon_age_s", "in_flight", "serving_s", "drain_s",
                   "swap_s", "prefix_hit_rate", "mfu",
                   "mfu_gap_memory_bound", "tokens_per_s", "accept_rate",
                   "accepted_tokens_per_s", "attempts"]
        out.append(_table(headers, [[r.get(h) for h in headers]
                                    for r in snap["replicas"]]))
        out.append(
            f"requests: {snap['submitted']} submitted / "
            f"{snap['completed']} completed / {snap['in_flight']} in "
            f"flight / {snap['replayed']} replayed   "
            f"ttft p50={snap['ttft_p50_s']}s p95={snap['ttft_p95_s']}s")
    elif snap["kind"] == "pipeline":
        headers = ["stage", "state", "attempt", "params_step", "step",
                   "beacon_age_s", "link_wait_s", "goodput",
                   "steady_recompiles", "attempts"]
        out.append(_table(headers, [[r.get(h) for h in headers]
                                    for r in snap["stages"]]))
        out.append(
            f"pipeline: {snap['n_stages']} stages ({snap['schedule']})   "
            f"done step: {snap['step']}   goodput: {snap['goodput']} "
            f"(accounted {snap['accounted_frac']}, "
            f"link_wait {snap['link_wait_s']}s)")
    else:
        headers = ["rank", "state", "attempt", "step", "steps_per_s",
                   "beacon_age_s", "goodput", "steady_recompiles"]
        out.append(_table(headers, [[r.get(h) for h in headers]
                                    for r in snap["ranks"]]))
        out.append(f"attempts: {snap['attempts']} (last rc "
                   f"{snap['last_rc']})   run goodput: {snap['goodput']} "
                   f"(accounted {snap['accounted_frac']})")
        if snap.get("mfu") is not None:
            gaps = snap.get("mfu_gaps") or {}
            out.append(
                f"mfu: {snap['mfu']}   gaps: "
                + "  ".join(f"{k.replace('mfu_gap_', '')}="
                            f"{gaps.get(k)}" for k in gaps)
                + f"   collective_bytes/step: "
                  f"{snap.get('collective_bytes_per_step')}"
                  f"   padding_waste: {snap.get('padding_waste_frac')}")
    return "\n".join(out)


# --------------------------------------------------------------------- CLI

def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Live, read-only run/fleet status from the telemetry "
                    "files (beacons, attempts.jsonl, ready.json, the "
                    "router journal). No jax import, no writes into the "
                    "run dir.")
    ap.add_argument("dir", help="run dir (training) or fleet dir (serving)")
    ap.add_argument("--watch", type=float, default=0.0, metavar="S",
                    help="refresh every S seconds until interrupted "
                         "(0 = print once)")
    ap.add_argument("--stale_s", type=float, default=10.0,
                    help="beacon age that flags a rank/replica as stale")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the snapshot as one JSON line instead of "
                         "the table")
    ap.add_argument("--export", default="", metavar="PATH",
                    help="also write the Perfetto timeline JSON "
                         "(obs.export) to PATH and exit")
    ap.add_argument("--prom", default="", metavar="PATH",
                    help="also write a Prometheus textfile snapshot to "
                         "PATH")
    ns = ap.parse_args(argv)
    if ns.export:
        summary = export_lib.write_outputs(
            ns.dir, out=ns.export, prom=ns.prom)
        print(json.dumps(summary))
        return summary
    if ns.prom:
        lines = export_lib.prometheus_lines(ns.dir)
        with open(ns.prom, "w") as f:
            f.write("\n".join(lines) + "\n")
        summary = {"dir": os.path.abspath(ns.dir),
                   "prometheus": os.path.abspath(ns.prom),
                   "metrics": len(lines)}
        print(json.dumps(summary))
        return summary
    while True:
        snap = status(ns.dir, stale_s=ns.stale_s)
        print(json.dumps(snap) if ns.as_json else render(snap), flush=True)
        if ns.watch <= 0:
            return snap
        try:
            time.sleep(ns.watch)
        except KeyboardInterrupt:
            return snap
        if not ns.as_json:
            print("", file=sys.stdout)


if __name__ == "__main__":
    main()
