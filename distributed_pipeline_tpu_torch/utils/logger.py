"""Metric logging: the key-value part of
``distributed_pipeline_tpu/utils/logger.py`` as an object the trainer owns
(no process-wide logger).

``logkv`` records a value for this dump (last write wins), ``logkv_mean``
averages every value logged between dumps, and ``dumpkvs`` writes the merged
row to ``log.txt`` (an aligned key | value table) and ``progress.csv`` in
the run directory - and to stdout when asked - then clears it. ``info``
writes a text line to the same text sinks.

Under several processes every rank logs: rank r > 0 writes
``log-rank{r:03d}.txt`` and ``progress-rank{r:03d}.csv`` (rank 0 alone
writes stdout, as the entry point asks), and a ``comm`` such as
``distributed_mean_comm()`` turns each dumped row into its count-weighted
mean across the ranks first.
"""

from __future__ import annotations

import os
import sys
import warnings
import zlib
from collections import defaultdict
from typing import IO, Any, Callable, Dict, List, Optional

__all__ = ["Logger", "distributed_mean_comm"]

# (row, counts per key) -> the row every rank writes
Comm = Callable[[Dict[str, Any], Dict[str, int]], Dict[str, Any]]


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


def distributed_mean_comm() -> Comm:
    """A comm averaging a dumped row's numeric values across the ranks,
    count-weighted like the reference's ``mpi_weighted_mean``: each rank
    contributes ``(value * count, count)`` per key and the row holds
    ``sum(v * c) / sum(c)``. The ranks first agree on the key set (a hash
    of the sorted keys); when the sets differ, each keeps its local values
    with a warning. One ``all_gather_object`` a dump; the identity
    single-process."""

    def comm(d: Dict[str, Any], counts: Dict[str, int]) -> Dict[str, Any]:
        from ..parallel import dist
        if dist.get_world_size() == 1:
            return d
        keys = sorted(k for k, v in d.items()
                      if isinstance(v, (int, float)) and not
                      isinstance(v, bool))
        # a key logged with logkv counts 1, one logged absent 0
        cnt = [float(counts.get(k, 1)) for k in keys]
        mine = (zlib.crc32(",".join(keys).encode()), len(keys),
                [float(d[k]) * c for k, c in zip(keys, cnt)], cnt)
        rows = dist.all_gather_object(mine)
        if any(r[:2] != mine[:2] for r in rows):
            warnings.warn("distributed_mean: metric key sets differ across "
                          "ranks; keeping this rank's values")
            return d
        out = dict(d)
        for j, k in enumerate(keys):
            num = sum(r[2][j] for r in rows)
            den = sum(r[3][j] for r in rows)
            out[k] = num / max(den, 1.0)
        return out

    return comm


class Logger:
    """Key-value metrics into ``<dir>/log{suffix}.txt`` and
    ``<dir>/progress{suffix}.csv`` (no files when ``dir`` is empty; the
    suffix is ``-rank{r:03d}`` for ``rank`` r > 0), and stdout when
    ``stdout``. ``comm(row, counts)``, when given, maps each dumped row
    (see ``distributed_mean_comm``). Call ``close`` when done."""

    def __init__(self, dir: str = "", stdout: bool = False,
                 comm: Optional[Comm] = None, rank: int = 0) -> None:
        self.dir = dir
        self.comm = comm
        self._vals: Dict[str, Any] = {}
        self._means: Dict[str, List[float]] = defaultdict(list)
        self._absent: set = set()
        self._text: List[IO] = [sys.stdout] if stdout else []
        self._csv: Optional[IO] = None
        self._csv_keys: List[str] = []
        if dir:
            suffix = f"-rank{rank:03d}" if rank > 0 else ""
            os.makedirs(dir, exist_ok=True)
            self._text.append(open(os.path.join(dir, f"log{suffix}.txt"),
                                   "at"))
            self._csv = open(os.path.join(dir, f"progress{suffix}.csv"),
                             "a+t")
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

    def logkv_absent(self, key: str) -> None:
        """This rank has no value for ``key`` in the next row, which other
        ranks log: it joins the row's key set with weight 0 in the ranks'
        mean (``distributed_mean_comm``), so the row carries the others'
        value. Without a comm the key is left out of the row."""
        self._absent.add(key)

    def dumpkvs(self) -> Dict[str, Any]:
        """Write the merged row (through ``comm`` when set) to every sink
        and clear it; returns it. Under a comm every rank must dump
        together."""
        d = dict(self._vals)
        d.update({k: sum(v) / len(v) for k, v in self._means.items() if v})
        counts = {k: len(v) for k, v in self._means.items() if v}
        absent = self._absent - set(d)
        self._vals.clear()
        self._means.clear()
        self._absent.clear()
        if self.comm is not None:
            d.update({k: 0.0 for k in absent})
            counts.update({k: 0 for k in absent})
            d = self.comm(d, counts)
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
