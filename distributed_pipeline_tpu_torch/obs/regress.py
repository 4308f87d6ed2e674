"""Bench-history regression sentinel: newest run vs a trailing baseline.

``bench.py`` appends every leg row to a persistent ``bench_history.jsonl``
(stamped with a per-run ``run_id``), so the bench trajectory is a time
series instead of a pile of disconnected artifacts. This CLI compares the
NEWEST recorded run against the mean of a trailing baseline window of
prior runs, per leg, on the metrics that define the perf contract::

    python -m distributed_pipeline_tpu_torch.obs.regress                  # table
    python -m distributed_pipeline_tpu_torch.obs.regress --json           # machine
    python -m distributed_pipeline_tpu_torch.obs.regress --band_pct 3 \
        --baseline_runs 3 --history bench_history.jsonl

Per leg, per metric, the verdict is ``improved`` / ``flat`` /
``regressed`` against the established ±3% noise band (the same band every
paired-A/B acceptance in this repo uses; direction-aware — ``mfu`` up is
good, ``peak_live_bytes`` up is bad, and ``recompile_count`` regresses on
ANY increase: steady recompiles are a 0-contract, not a noisy rate). A
leg that ERRORED in the newest run but carried data in the baseline is a
regression too — a leg silently dying must not read as "no data, no
problem" — while a budget/sigterm ``skipped`` marker is the bench's
documented normal mode and simply yields no comparison. Exit code 1 when anything regressed (the CI wiring: a
lint-marked test pins this), 0 otherwise — including the not-enough-
history case, which reports itself honestly instead of blocking a young
repo's CI.

Output: one machine-readable JSON line on stdout, the human table on
stderr (the bench stdout contract). Reads through the shared torn-tail
``chaos.goodput.read_journal`` owner; never writes. Import-light: no
jax.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..chaos.goodput import read_journal

__all__ = ["METRICS", "compare_runs", "group_runs", "main", "render_table"]

# (metric key aliases in priority order, higher_is_better, zero_band)
# zero_band metrics regress on ANY adverse move (steady recompiles are a
# 0-contract); banded metrics use the ±band noise tolerance.
METRICS: Tuple[Tuple[str, Tuple[str, ...], bool, bool], ...] = (
    ("tokens_per_s", ("tokens_per_sec_per_chip",
                      "decode_tokens_per_s_per_chip"), True, False),
    ("mfu", ("mfu",), True, False),
    ("peak_live_bytes", ("peak_live_bytes",), False, False),
    ("recompile_count", ("recompile_count",
                         "steady_recompile_count"), False, True),
)


def _metric_value(row: Dict[str, Any], aliases: Tuple[str, ...]
                  ) -> Optional[float]:
    for k in aliases:
        v = row.get(k)
        if isinstance(v, bool) or v is None:
            continue
        try:
            return float(v)
        except (TypeError, ValueError):
            continue
    return None


def group_runs(rows: List[dict]) -> List[Tuple[str, Dict[str, dict]]]:
    """History rows -> ordered (run_id, {leg name: row}) groups. File
    order IS run order (append-only history); rows without a run_id
    (pre-sentinel histories) group under "unstamped" so old files still
    parse. Within a run the last row per leg wins (a re-run leg)."""
    runs: List[Tuple[str, Dict[str, dict]]] = []
    for row in rows:
        if not isinstance(row, dict) or not row.get("name"):
            continue
        rid = str(row.get("run_id") or "unstamped")
        if not runs or runs[-1][0] != rid:
            runs.append((rid, {}))
        runs[-1][1][str(row["name"])] = row
    return runs


def _usable(row: dict) -> bool:
    return "error" not in row and "skipped" not in row


def compare_runs(runs: List[Tuple[str, Dict[str, dict]]], *,
                 band_pct: float = 3.0,
                 baseline_runs: int = 3) -> Dict[str, Any]:
    """Newest run vs the mean of up to ``baseline_runs`` trailing prior
    runs. Returns the summary dict (per-leg per-metric verdicts + the
    overall verdict); see the module docstring for verdict semantics."""
    if len(runs) < 2:
        return {"verdict": "insufficient-history", "runs": len(runs),
                "needed": 2, "legs": {}}
    newest_id, newest = runs[-1]
    window = runs[-(baseline_runs + 1):-1]
    legs: Dict[str, Any] = {}
    band = band_pct / 100.0
    for name, row in newest.items():
        base_rows = [r[name] for _, r in window
                     if name in r and _usable(r[name])]
        if not base_rows:
            continue  # a brand-new leg has no baseline yet
        if "skipped" in row:
            # budget/sigterm skips are the bench's documented NORMAL
            # mode under BENCH_BUDGET_S — no data is no comparison, not
            # a regression (a gate that reddens on routine budget skips
            # would flap on every boundary leg)
            continue
        if not _usable(row):
            legs[name] = {"verdict": "regressed",
                          "reason": "leg errored in the newest run but "
                                    "has baseline data",
                          "metrics": {}}
            continue
        metrics: Dict[str, Any] = {}
        worst = "flat"
        any_improved = False
        for label, aliases, higher, zero_band in METRICS:
            new_v = _metric_value(row, aliases)
            base_vals = [v for v in
                         (_metric_value(r, aliases) for r in base_rows)
                         if v is not None]
            if new_v is None or not base_vals:
                continue
            base = sum(base_vals) / len(base_vals)
            delta = new_v - base
            delta_pct = (100.0 * delta / abs(base)) if base else None
            adverse = (delta < 0) if higher else (delta > 0)
            if zero_band:
                verdict = ("regressed" if adverse and delta != 0 else
                           "improved" if delta != 0 else "flat")
            elif base == 0:
                verdict = ("regressed" if adverse and abs(delta) > 0 else
                           "flat")
            else:
                frac = abs(delta) / abs(base)
                verdict = ("flat" if frac <= band else
                           "regressed" if adverse else "improved")
            metrics[label] = {"new": new_v, "baseline": base,
                              "delta_pct": (round(delta_pct, 2)
                                            if delta_pct is not None
                                            else None),
                              "verdict": verdict}
            if verdict == "regressed":
                worst = "regressed"
            elif verdict == "improved":
                any_improved = True
        legs[name] = {
            "verdict": ("regressed" if worst == "regressed" else
                        "improved" if any_improved else "flat"),
            "metrics": metrics,
        }
    n_reg = sum(1 for l in legs.values() if l["verdict"] == "regressed")
    return {
        "verdict": ("regressed" if n_reg else
                    "ok" if legs else "no-comparable-legs"),
        "newest_run": newest_id,
        "baseline_window": [rid for rid, _ in window],
        "band_pct": band_pct,
        "runs": len(runs),
        "regressed": n_reg,
        "legs": legs,
    }


def render_table(summary: Dict[str, Any]) -> str:
    """The human view: one line per leg-metric, verdicts spelled out."""
    if summary["verdict"] == "insufficient-history":
        return (f"bench history holds {summary['runs']} run(s); the "
                f"sentinel needs >= 2 to compare")
    lines = [f"newest run {summary['newest_run']} vs baseline window "
             f"{summary['baseline_window']} (band ±{summary['band_pct']}%)"]
    header = f"{'leg':<34} {'metric':<16} {'new':>14} {'baseline':>14} " \
             f"{'delta%':>8}  verdict"
    lines += [header, "-" * len(header)]
    for name, leg in sorted(summary["legs"].items()):
        if not leg["metrics"]:
            lines.append(f"{name:<34} {'-':<16} {'-':>14} {'-':>14} "
                         f"{'-':>8}  {leg['verdict']}"
                         + (f" ({leg.get('reason')})"
                            if leg.get("reason") else ""))
        for label, m in leg["metrics"].items():
            d = "-" if m["delta_pct"] is None else f"{m['delta_pct']:+.2f}"
            lines.append(
                f"{name:<34} {label:<16} {m['new']:>14.4g} "
                f"{m['baseline']:>14.4g} {d:>8}  {m['verdict']}")
        lines.append(f"{name:<34} {'=> ' + leg['verdict']}")
    lines.append(f"overall: {summary['verdict']} "
                 f"({summary['regressed']} leg(s) regressed)")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> Tuple[Dict[str, Any], int]:
    ap = argparse.ArgumentParser(
        description="Compare the newest bench run in bench_history.jsonl "
                    "against a trailing baseline window; exit 1 when any "
                    "leg regressed beyond the noise band.")
    ap.add_argument("--history", default="bench_history.jsonl",
                    help="append-only per-leg history bench.py writes")
    ap.add_argument("--band_pct", type=float, default=3.0,
                    help="noise band (±%%) for rate/bytes metrics")
    ap.add_argument("--baseline_runs", type=int, default=3,
                    help="trailing prior runs averaged into the baseline")
    ap.add_argument("--json", action="store_true", dest="json_only",
                    help="suppress the human table (JSON line only)")
    ns = ap.parse_args(argv)
    rows = read_journal(ns.history)
    summary = compare_runs(group_runs(rows), band_pct=ns.band_pct,
                           baseline_runs=ns.baseline_runs)
    summary["history"] = ns.history
    if not ns.json_only:
        print(render_table(summary), file=sys.stderr, flush=True)
    print(json.dumps(summary), flush=True)
    return summary, (1 if summary["verdict"] == "regressed" else 0)


if __name__ == "__main__":
    sys.exit(main()[1])
