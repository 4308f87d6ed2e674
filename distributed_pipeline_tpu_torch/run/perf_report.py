"""Roofline perf report: render a run dir's cost ledger.

``--cost_ledger`` runs snapshot their per-compiled-program roofline
attribution to ``<run_dir>/perf_ledger.json`` (obs/ledger.py). This CLI
turns that snapshot into the human answer to "where do the missing
FLOP-seconds go"::

    python -m distributed_pipeline_tpu_torch.run.perf_report <run_dir>
    python -m distributed_pipeline_tpu_torch.run.perf_report <run_dir> --json

One machine-readable JSON line on stdout (the full ledger + the checked
gap-sum identity per program), the attribution table on stderr. Exit 2
when the dir holds no ledger (a typo'd path must not read as "no gaps").
Read-only and import-light (no jax): safe to point at a live run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..obs import ledger as ledger_lib

__all__ = ["main", "render"]

_GAP_LABELS = (
    ("mfu_gap_host", "host (data/h2d/dispatch stalls)"),
    ("mfu_gap_comms", "comms (collective payload / ICI roofline)"),
    ("mfu_gap_memory_bound", "memory-bound (HBM traffic over ideal)"),
    ("mfu_gap_residual", "residual (unattributed)"),
)


def _fmt_bytes(n: Any) -> str:
    try:
        v = float(n)
    except (TypeError, ValueError):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024
    return "-"


def render(payload: Dict[str, Any]) -> str:
    lines: List[str] = []
    step = payload.get("step")
    lines.append(f"perf ledger @ step {step} "
                 f"({payload.get('n_devices')} x "
                 f"{payload.get('device_kind')})")
    for name, row in sorted((payload.get("programs") or {}).items()):
        lines.append(f"\n[{name}]")
        if "flops_per_execution" in row:
            lines.append(f"  xla flops/exec:    "
                         f"{row['flops_per_execution']:.4g}   "
                         f"bytes accessed: "
                         f"{_fmt_bytes(row.get('bytes_accessed'))}")
        coll = row.get("collectives") or {}
        if coll.get("counts"):
            parts = ", ".join(f"{op} x{n} "
                              f"({_fmt_bytes(coll['bytes'].get(op, 0))})"
                              for op, n in coll["counts"].items())
            lines.append(f"  collectives:       {parts}")
        if "mfu" not in row:
            if "padding_waste_frac" in row:
                lines.append(f"  padding waste:     "
                             f"{100 * row['padding_waste_frac']:.1f}%")
            continue
        lines.append(f"  mfu:               {row['mfu']:.4f}   "
                     f"(tokens/s {row.get('tokens_per_s', 0):.4g})")
        for key, label in _GAP_LABELS:
            lines.append(f"  {label + ':':<43}"
                         f"{100 * row.get(key, 0.0):6.2f}% of peak")
        lines.append(f"  padding waste:     "
                     f"{100 * row.get('padding_waste_frac', 0.0):.1f}% "
                     f"of step tokens")
        resid = abs(ledger_lib.gap_sum_identity(row) - 1.0)
        lines.append(f"  identity:          mfu + gaps - 1 = {resid:.2e}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None
         ) -> Tuple[Optional[Dict[str, Any]], int]:
    ap = argparse.ArgumentParser(
        description="Render a run dir's perf_ledger.json (the "
                    "--cost_ledger roofline attribution) as a human "
                    "report + one machine-readable JSON line.")
    ap.add_argument("dir", help="run dir holding perf_ledger.json")
    ap.add_argument("--json", action="store_true", dest="json_only",
                    help="suppress the human table (JSON line only)")
    ns = ap.parse_args(argv)
    payload = ledger_lib.read_ledger(ns.dir)
    if payload is None:
        print(f"no {ledger_lib.LEDGER_FILENAME} in {ns.dir} — run with "
              f"--cost_ledger true to produce one", file=sys.stderr)
        return None, 2
    summary = {
        "dir": os.path.abspath(ns.dir),
        **payload,
        "identity_residuals": {
            name: abs(ledger_lib.gap_sum_identity(row) - 1.0)
            for name, row in (payload.get("programs") or {}).items()
            if "mfu" in row},
    }
    if not ns.json_only:
        print(render(payload), file=sys.stderr, flush=True)
    print(json.dumps(summary), flush=True)
    return summary, 0


if __name__ == "__main__":
    sys.exit(main()[1])
