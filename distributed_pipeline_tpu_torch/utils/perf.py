"""Performance gauges: the ``EventStats`` part of
``distributed_pipeline_tpu/utils/perf.py`` (serving TTFT percentiles)."""

from __future__ import annotations

__all__ = ["EventStats"]


class EventStats:
    """Per-event latency accounting (e.g. serving time-to-first-token).

    ``add`` records one event's seconds; ``summary`` reports count, mean,
    p50, p95 (nearest-rank on the sorted sample), and max — all 0.0 when
    empty so downstream rows always carry every key."""

    def __init__(self) -> None:
        self._vals: list = []

    def add(self, seconds: float) -> None:
        self._vals.append(float(seconds))

    def summary(self) -> dict:
        if not self._vals:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "max": 0.0}
        v = sorted(self._vals)
        n = len(v)
        return {
            "count": n,
            "mean": sum(v) / n,
            "p50": v[(n - 1) // 2],
            "p95": v[min(n - 1, max(0, -(-95 * n // 100) - 1))],
            "max": v[-1],
        }
