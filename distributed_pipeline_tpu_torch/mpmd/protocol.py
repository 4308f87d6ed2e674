"""MPMD stage-process protocol: dirs, beacons, snapshots, schedules. The
port of ``distributed_pipeline_tpu/mpmd/protocol.py``.

Torch-free by the same rule as ``serving/fleet.py``: the pipeline driver
and the launcher-adjacent readers must find every file without a torch
import — only stage WORKERS (mpmd/stage_worker.py) pay one.

Layout under a pipeline run dir (all names owned here or in
chaos/goodput.py)::

    run_dir/
      mpmd_config.json          # the driver's config handed to stages
      stage_{k}/                # per-stage launcher-ring run dir
        attempts.jsonl          #   (launcher) per-attempt records
        .progress_rank0.json    #   (worker) per-step beacon
        goodput_attempt*.json   #   (worker) clean-exit sidecar
        ready.json              #   (worker) ready announce per attempt
        snapshots/state_*.npz   #   (worker) post-step state snapshots
        logs/                   #   (launcher) worker logs
      links/
        act_{s}_{s+1}/          # fwd activations, stage s -> s+1
        grad_{s+1}_{s}/         # bwd cotangents, stage s+1 -> s
        cmd_{s}/                # driver -> stage s control frames
        res_{s}/                # stage s -> driver results

The per-step protocol is host-driven two-phase: the driver broadcasts
``{"op": "step"}`` on every cmd link, stages run their local microbatch
schedule (:func:`schedule_for`) moving activations/grads over the data
links, exchange tied-embedding grads through the driver where the family
requires it, apply their slice's optimizer update, snapshot, and answer
``{"op": "done"}`` on their res link. Recovery: the driver observes a
stage ring's restart as a ready-file ATTEMPT BUMP, broadcasts
``{"op": "rewind"}`` with a new epoch, every stage reloads its own local
snapshot at the rewind step (a FILE operation — the surviving stages'
processes never restart), and the epoch filter in mpmd/link.py drops
every in-flight pre-rewind frame.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..chaos import goodput as goodput_lib
from ..obs import trace as trace_lib

__all__ = [
    "HostGoodput", "StagePaths", "StageProtocol", "schedule_for",
    "link_dir", "data_links_for_stage", "read_ready",
    "save_snapshot", "load_snapshot", "newest_snapshot_step",
    "config_path", "write_config", "read_config",
]

_SNAP_RE = re.compile(r"state_(\d{6})\.npz$")


def config_path(run_dir: str) -> str:
    return os.path.join(run_dir, "mpmd_config.json")


def write_config(run_dir: str, cfg: dict) -> None:
    os.makedirs(run_dir, exist_ok=True)
    tmp = config_path(run_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cfg, f, indent=1)
    os.replace(tmp, config_path(run_dir))


def read_config(run_dir: str) -> dict:
    with open(config_path(run_dir)) as f:
        return json.load(f)


def link_dir(run_dir: str, kind: str, a: int, b: Optional[int] = None) -> str:
    """One link directory. ``kind`` is ``act``/``grad`` (a -> b data
    links) or ``cmd``/``res`` (driver control links for stage ``a``)."""
    name = f"{kind}_{a}" if b is None else f"{kind}_{a}_{b}"
    return os.path.join(run_dir, "links", name)


def data_links_for_stage(run_dir: str, stage: int, n_stages: int
                         ) -> Dict[str, Optional[str]]:
    """The four data-link dirs as seen FROM one stage (None at the
    pipeline boundaries): activations in/out, gradients in/out."""
    return {
        "act_in": (link_dir(run_dir, "act", stage - 1, stage)
                   if stage > 0 else None),
        "act_out": (link_dir(run_dir, "act", stage, stage + 1)
                    if stage < n_stages - 1 else None),
        "grad_in": (link_dir(run_dir, "grad", stage + 1, stage)
                    if stage < n_stages - 1 else None),
        "grad_out": (link_dir(run_dir, "grad", stage, stage - 1)
                     if stage > 0 else None),
    }


def schedule_for(stage: int, n_stages: int, n_mb: int,
                 kind: str = "1f1b") -> List[Tuple[str, int]]:
    """Stage-local microbatch op order: ``[("F", m), ("B", m), ...]``.

    ``1f1b``: ``n_stages - 1 - stage`` warmup forwards, then the steady
    one-forward-one-backward alternation, then cooldown backwards — the
    activation stash never exceeds the warmup depth, which is what the
    link capacity backpressures to. ``gpipe``: all forwards then all
    backwards (stash = n_mb). Order only changes memory/overlap, never
    the summed loss/grads (each microbatch contributes independently
    under the global-denominator chunking)."""
    if kind not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown mpmd schedule {kind!r}")
    if kind == "gpipe":
        return ([("F", m) for m in range(n_mb)]
                + [("B", m) for m in range(n_mb)])
    warm = min(n_mb, n_stages - 1 - stage)
    ops: List[Tuple[str, int]] = [("F", m) for m in range(warm)]
    b = 0
    for f in range(warm, n_mb):
        ops.append(("F", f))
        ops.append(("B", b))
        b += 1
    ops.extend(("B", m) for m in range(b, n_mb))
    return ops


class HostGoodput:
    """Torch-free twin of ``utils/perf.GoodputTracker`` for MPMD processes
    (the driver keeps a ledger without a torch import, and a stage
    worker's host-side categories need no device). Same summary contract: wall
    anchored at DPT_SPAWN_T when the launcher stamped it, exclusive
    categories, ``useful_step_s`` is the residual — so
    ``chaos.goodput.aggregate_run`` folds these snapshots exactly like
    trainer ones, including the new ``link_wait_s`` category."""

    CATEGORIES = goodput_lib._CATEGORIES

    def __init__(self) -> None:
        spawn = os.environ.get("DPT_SPAWN_T", "")
        try:
            self._t0 = float(spawn)
        except ValueError:
            self._t0 = time.time()
        self._cats = {c: 0.0 for c in self.CATEGORIES}

    def add(self, cat: str, seconds: float) -> None:
        self._cats[cat] += max(0.0, float(seconds))

    @contextlib.contextmanager
    def timed(self, cat: str):
        watch = trace_lib.Stopwatch()
        try:
            yield
        finally:
            self.add(cat, watch.lap_s())

    def summary(self) -> Dict[str, float]:
        wall = max(time.time() - self._t0, 0.0)
        out = {"wall_s": wall}
        out.update(self._cats)
        out["useful_step_s"] = max(0.0, wall - sum(self._cats.values()))
        return out


class StagePaths:
    """Filesystem layout for one stage's run dir (chaos.goodput owns the
    ``stage_{k}`` naming; this class owns what lives inside)."""

    def __init__(self, run_dir: str, stage: int) -> None:
        self.run_dir = run_dir
        self.stage = int(stage)
        self.root = goodput_lib.stage_dir(run_dir, stage)
        self.log_dir = os.path.join(self.root, "logs")
        self.snap_dir = os.path.join(self.root, "snapshots")
        self.ready_path = os.path.join(self.root, "ready.json")
        self.stop_path = os.path.join(self.root, "stop")

    def ensure(self) -> "StagePaths":
        for d in (self.root, self.log_dir, self.snap_dir):
            os.makedirs(d, exist_ok=True)
        return self


def _write_json_atomic(path: str, payload: dict) -> None:
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload))
    os.replace(tmp, path)


def read_ready(paths: StagePaths) -> Optional[dict]:
    try:
        with open(paths.ready_path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


class StageProtocol:
    """One stage worker's side of the driver protocol: beacons (liveness
    + flight recorder, harvested by the stage's OWN launcher ring),
    ready announces (the driver's restart detector), goodput sidecars,
    and the DPT_RUN_DIR_FILE handshake pointing the launcher at the
    stage dir."""

    def __init__(self, paths: StagePaths, *, n_stages: int,
                 trace_armed: Optional[bool] = None) -> None:
        self.paths = paths.ensure()
        self.stage = paths.stage
        self.n_stages = int(n_stages)
        self.attempt = int(os.environ.get("DPT_ATTEMPT") or 0)
        self.goodput = HostGoodput()
        self.start_step = 0
        self._recompiles = (0, 0)  # (total, steady) — set by the worker
        self.tracer = trace_lib.tracer_for(
            paths.root, 0, armed=trace_armed,
            proc=f"stage{self.stage}.rank0")
        handshake = os.environ.get("DPT_RUN_DIR_FILE", "")
        if handshake:
            try:
                with open(handshake, "w") as f:
                    f.write(os.path.abspath(paths.root))
            except OSError:
                pass

    def set_recompiles(self, total: int, steady: int) -> None:
        self._recompiles = (int(total), int(steady))

    def write_beacon(self, step: int, extra: Optional[dict] = None) -> None:
        payload = {
            "step": int(step),
            "start_step": int(self.start_step),
            "t": time.time(),
            "attempt": self.attempt,
            "rank": 0,
            "stage": self.stage,
            "recompile_count": self._recompiles[0],
            "steady_recompile_count": self._recompiles[1],
            "goodput": {k: round(v, 6)
                        for k, v in self.goodput.summary().items()},
        }
        if extra:
            payload.update(extra)
        try:
            _write_json_atomic(
                goodput_lib.beacon_path(self.paths.root, 0), payload)
        except OSError:
            pass  # beacon is telemetry: never fail a step

    def announce_ready(self, params_step: int) -> None:
        """(Re-)announce this attempt's restored/applied step. The driver
        reads the ATTEMPT BUMP as 'this stage's ring restarted it' and
        the min over ``params_step`` as the rewind target, so workers
        re-announce after every optimizer apply, not just at startup."""
        try:
            _write_json_atomic(self.paths.ready_path, {
                "stage": self.stage, "attempt": self.attempt,
                "params_step": int(params_step), "t": time.time()})
        except OSError:
            pass

    def stop_requested(self) -> bool:
        return os.path.exists(self.paths.stop_path)

    def write_sidecar(self, end_step: int,
                      extra: Optional[dict] = None) -> None:
        payload = {
            "attempt": self.attempt,
            "stage": self.stage,
            "steps": [int(self.start_step), int(end_step)],
            "recompile_count": self._recompiles[0],
            "steady_recompile_count": self._recompiles[1],
            **{k: round(v, 6) for k, v in self.goodput.summary().items()},
        }
        if extra:
            payload.update(extra)
        try:
            with open(goodput_lib.goodput_record_path(
                    self.paths.root, self.attempt), "w") as f:
                f.write(json.dumps(payload))
        except OSError:
            pass


# ----------------------------------------------------------- snapshots
# Per-stage state snapshots: flat {path: array} dicts as atomic-rename
# npz (the link frame format reused at rest). numpy-only so the torch-free
# test worker (tests/_torch_port_mpmd_child.py) snapshots through the same
# code.

def save_snapshot(snap_dir: str, step: int,
                  flat: Dict[str, np.ndarray], *, keep: int = 8) -> str:
    os.makedirs(snap_dir, exist_ok=True)
    final = os.path.join(snap_dir, f"state_{step:06d}.npz")
    tmp = final + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
    steps = sorted(_snapshot_steps(snap_dir))
    for old in steps[:-keep]:
        try:
            os.unlink(os.path.join(snap_dir, f"state_{old:06d}.npz"))
        except OSError:
            pass
    return final


def _snapshot_steps(snap_dir: str) -> List[int]:
    try:
        names = os.listdir(snap_dir)
    except OSError:
        return []
    return [int(m.group(1)) for m in (_SNAP_RE.match(n) for n in names)
            if m]


def load_snapshot(snap_dir: str, step: int
                  ) -> Optional[Dict[str, np.ndarray]]:
    path = os.path.join(snap_dir, f"state_{step:06d}.npz")
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        return None  # missing or torn (killed mid-tmp never lands here)


def newest_snapshot_step(snap_dir: str) -> int:
    """Highest LOADABLE snapshot step (walks back past a corrupt newest,
    as the checkpoint restore does), 0 when none — step 0 is the
    deterministic from-seed init every stage can always rebuild."""
    for step in sorted(_snapshot_steps(snap_dir), reverse=True):
        if load_snapshot(snap_dir, step) is not None:
            return step
    return 0
