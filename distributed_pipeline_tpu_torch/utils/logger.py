"""Metric logging: the key-value part of
``distributed_pipeline_tpu/utils/logger.py`` as an object the trainer owns
(no process-wide logger).

``logkv`` records a value for this dump (last write wins), ``logkv_mean``
averages every value logged between dumps, and ``dumpkvs`` writes the merged
row to ``log.txt`` (an aligned key | value table) and ``progress.csv`` in
the run directory - and to stdout when asked - then clears it. ``info``
writes a text line to the same text sinks.
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict
from typing import IO, Any, Dict, List, Optional

__all__ = ["Logger"]


def _table(kvs: Dict[str, Any]) -> str:
    rows = []
    for key, val in sorted(kvs.items()):
        valstr = (f"{val:<8.3g}" if isinstance(val, float) else str(val))
        key = key[:27] + "..." if len(key) > 30 else key
        rows.append((key, valstr[:30]))
    kw = max(len(k) for k, _ in rows)
    vw = max(len(v) for _, v in rows)
    dashes = "-" * (kw + vw + 7)
    lines = [dashes] + [f"| {k:<{kw}} | {v:<{vw}} |" for k, v in rows]
    return "\n".join(lines + [dashes]) + "\n"


class Logger:
    """Key-value metrics into ``<dir>/log.txt`` and ``<dir>/progress.csv``
    (no files when ``dir`` is empty), and stdout when ``stdout``. Call
    ``close`` when done."""

    def __init__(self, dir: str = "", stdout: bool = False) -> None:
        self.dir = dir
        self._vals: Dict[str, Any] = {}
        self._means: Dict[str, List[float]] = defaultdict(list)
        self._text: List[IO] = [sys.stdout] if stdout else []
        self._csv: Optional[IO] = None
        self._csv_keys: List[str] = []
        if dir:
            os.makedirs(dir, exist_ok=True)
            self._text.append(open(os.path.join(dir, "log.txt"), "at"))
            self._csv = open(os.path.join(dir, "progress.csv"), "a+t")
            self._csv.seek(0)
            header = self._csv.readline().strip("\n")
            self._csv_keys = header.split(",") if header else []
            self._csv.seek(0, os.SEEK_END)

    def logkv(self, key: str, val: Any) -> None:
        self._vals[key] = val

    def logkvs(self, d: Dict[str, Any]) -> None:
        for k, v in d.items():
            self.logkv(k, v)

    def logkv_mean(self, key: str, val: float) -> None:
        self._means[key].append(float(val))

    def logkvs_mean(self, d: Dict[str, float]) -> None:
        for k, v in d.items():
            self.logkv_mean(k, v)

    def dumpkvs(self) -> Dict[str, Any]:
        """Write the merged row to every sink and clear it; returns it."""
        d = dict(self._vals)
        d.update({k: sum(v) / len(v) for k, v in self._means.items() if v})
        self._vals.clear()
        self._means.clear()
        if not d:
            return d
        for f in self._text:
            f.write(_table(d))
            f.flush()
        if self._csv is not None:
            self._write_csv(d)
        return d

    def _write_csv(self, d: Dict[str, Any]) -> None:
        f = self._csv
        extra = sorted(set(d) - set(self._csv_keys))
        if extra:
            # a new key widens the header: rewrite the file with it
            self._csv_keys.extend(extra)
            f.seek(0)
            lines = f.readlines()
            f.seek(0)
            f.truncate()
            f.write(",".join(self._csv_keys) + "\n")
            for line in lines[1:]:
                f.write(line.rstrip("\n") + "," * len(extra) + "\n")
        f.write(",".join("" if d.get(k) is None else str(d[k])
                         for k in self._csv_keys) + "\n")
        f.flush()

    def info(self, *args: Any) -> None:
        for f in self._text:
            f.write(" ".join(map(str, args)) + "\n")
            f.flush()

    def close(self) -> None:
        for f in self._text:
            if f is not sys.stdout:
                f.close()
        if self._csv is not None:
            self._csv.close()
        self._text, self._csv = [], None
