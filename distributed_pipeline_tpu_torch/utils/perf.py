"""Performance gauges: the port's part of
``distributed_pipeline_tpu/utils/perf.py`` - ``EventStats`` (serving TTFT
percentiles), ``StepTimer``, ``EventTimer``, the training and decode FLOP counts and
``mfu``, ``active_param_count`` (the parameters a token runs through
under top-k MoE routing), the sanitizer's ``RecompileMonitor``,
``SanitizeReport`` and ``sync_allowed``, the training loop's
``StallBreakdown`` and ``GoodputTracker`` (the JAX classes, same
categories and arithmetic) and ``peak_live_bytes`` - plus the published
rates of the cards the port targets (``CARDS``). No TPU peak is carried
over: MFU here is always against a card's own data sheet."""

from __future__ import annotations

import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

__all__ = ["EventStats", "StepTimer", "EventTimer", "CARDS", "card_rates",
           "transformer_train_flops_per_token",
           "transformer_decode_flops_per_token", "mfu",
           "active_param_count", "RecompileMonitor",
           "SanitizeReport", "SANITIZE_REPORT_NAME", "sync_allowed",
           "StallBreakdown", "GoodputTracker", "peak_live_bytes",
           "PROFILE_WINDOW", "parse_profile_steps"]

# Published rates of the cards this port targets (NVIDIA data sheets; dense,
# no sparsity): HBM bytes/s, bf16 tensor-core flop/s and f32 flop/s outside
# the tensor cores, matched on the name nvidia-smi and
# torch.cuda.get_device_name report.
CARDS = {
    "H100 80GB HBM3": (3.35e12, 989e12, 67e12),  # H100 SXM
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H200": (4.8e12, 989e12, 67e12),
}


def card_rates(name: str) -> Tuple[float, float, float]:
    """(memory bytes/s, dense bf16 flop/s, f32 flop/s) of the card
    ``name``; raises for a card without published rates here."""
    for key, rates in CARDS.items():
        if key in name:
            return rates
    raise ValueError(f"no published rates for the card {name!r}; known: "
                     f"{sorted(CARDS)}")


def transformer_train_flops_per_token(n_params: int, n_layers: int,
                                      hidden: int, seq_len: int) -> float:
    """fwd+bwd FLOPs per trained token: the 6N weight-matmul term plus the
    12*l*h*s attention term (score and value matmuls, forward 4lhs, x3 with
    the backward) - the JAX package's accounting."""
    return 6.0 * n_params + 12.0 * n_layers * hidden * seq_len


def transformer_decode_flops_per_token(n_params: int) -> float:
    """Forward-only FLOPs per decoded token: the 2N weight-matmul term, the
    JAX package's serving roofline numerator."""
    return 2.0 * n_params


def mfu(tokens_per_sec: float, flops_per_token: float, device_name: str,
        n_devices: int = 1) -> float:
    """Model FLOPs utilization against the card's published dense bf16
    peak (``card_rates``; raises for an unknown card)."""
    peak = card_rates(device_name)[1]
    return tokens_per_sec * flops_per_token / (peak * n_devices)


def active_param_count(params: Mapping[str, Any], n_params: int, *,
                       moe_experts: int = 0, moe_top_k: int = 2) -> int:
    """The parameters active per token: a top-k routed MoE block runs
    ``moe_top_k`` of its ``moe_experts`` expert MLPs, so the inactive
    experts' share of the expert weights (a tensor under a ``moe`` module
    whose leading dim, or second dim when it has 3 or more, is
    ``moe_experts``) comes off ``n_params``, as the JAX function counts.
    ``params`` maps names to tensors (a ``state_dict``, or
    ``named_parameters``). Dense models, and ``top_k >= experts``, return
    ``n_params``."""
    if moe_experts <= moe_top_k:
        return n_params
    expert = sum(
        int(p.numel()) for name, p in params.items()
        if "moe" in name.split(".") and p.dim() >= 2
        and (p.shape[0] == moe_experts
             or (p.dim() >= 3 and p.shape[1] == moe_experts)))
    return n_params - round(expert * (moe_experts - moe_top_k)
                            / moe_experts)


class StepTimer:
    """Wall-clock step timing that skips the first ``warmup`` steps (first
    use of each kernel and allocator path). ``lap()`` returns (steps/s,
    tokens/s) over the window since the last call; call it after the step's
    work is complete (a synchronize) or accept a step of skew. ``steps``
    counts every tick."""

    def __init__(self, tokens_per_step: float, warmup: int = 2):
        self.tokens_per_step = tokens_per_step
        self.warmup = warmup
        self.steps = 0
        self._t0: Optional[float] = None
        self._window_steps = 0

    def tick(self) -> None:
        self.steps += 1
        if self.steps == self.warmup:
            self._t0 = time.perf_counter()
            self._window_steps = 0
        elif self.steps > self.warmup:
            self._window_steps += 1

    def lap(self) -> Tuple[float, float]:
        if self._t0 is None or self._window_steps == 0:
            return 0.0, 0.0
        dt = time.perf_counter() - self._t0
        sps = self._window_steps / max(dt, 1e-9)
        self._t0 = time.perf_counter()
        self._window_steps = 0
        return sps, sps * self.tokens_per_step


class EventTimer:
    """Seconds and calls of one kind of timed call (a collective): CUDA
    events around each call on the current stream, read later so the call
    waits for nothing, or the host's clock on the CPU. ``seconds`` sums
    the ``drained`` calls: ``poll()`` adds the pairs that have completed
    and keeps the rest (no wait), ``drain()`` waits for every pair."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.calls = 0
        self.drained = 0
        self._events: List[tuple] = []

    @contextlib.contextmanager
    def measure(self, device) -> Iterator[None]:
        if device.type == "cuda":
            import torch
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            yield
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.seconds += time.perf_counter() - t0
            self.drained += 1
        self.calls += 1

    def poll(self) -> None:
        """Add the completed pairs' times into ``seconds``, oldest first,
        up to the first pair still pending; never waits."""
        done = 0
        for start, end in self._events:
            if not end.query():
                break
            self.seconds += start.elapsed_time(end) / 1e3
            done += 1
        del self._events[:done]
        self.drained += done

    def drain(self) -> None:
        """Add every recorded pair's time into ``seconds``, waiting for
        the pending ones."""
        for start, end in self._events:
            end.synchronize()
            self.seconds += start.elapsed_time(end) / 1e3
        self.drained += len(self._events)
        self._events.clear()

    @property
    def seconds_per_call(self) -> float:
        """The mean over the drained calls (0 before any)."""
        return self.seconds / self.drained if self.drained else 0.0


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


class RecompileMonitor:
    """Counts the serving engines' CUDA-graph captures, the port's compiles:
    the ``recompile_count`` gauge behind ``--sanitize``. An engine calls
    :meth:`note` after each capture. ``count`` is the total; ``sites``
    keeps (with ``capture_sites``) where in the port each capture was
    triggered, with its ordinal, for the sanitizer's report."""

    _MAX_SITES = 16

    def __init__(self, capture_sites: bool = False) -> None:
        self.count = 0
        self.last = ""
        self.sites: List[Dict[str, Any]] = []
        self._capture_sites = capture_sites

    def note(self, name: str, seconds: float) -> None:
        self.count += 1
        self.last = f"captured {name} in {seconds:.3f} s"
        if self._capture_sites and len(self.sites) < self._MAX_SITES:
            site = _user_site(traceback.extract_stack())
            if site is not None:
                site["detail"] = self.last
                site["ordinal"] = self.count
                self.sites.append(site)


SANITIZE_REPORT_NAME = "sanitize_report.json"

_THIS_FILE = os.path.abspath(__file__)
_STDLIB_DIR = os.path.dirname(os.path.abspath(contextlib.__file__))


def _user_site(frames) -> Optional[Dict[str, Any]]:
    """Deepest frame of the port's own code (not torch or site-packages,
    not the stdlib, not this module)."""
    for fr in reversed(list(frames)):
        fn = fr.filename or ""
        if (not fn or fn.startswith("<")
                or "site-packages" in fn or "dist-packages" in fn
                or "importlib" in fn
                or os.path.abspath(fn) == _THIS_FILE
                or fn.startswith(_STDLIB_DIR)):
            continue
        return {"path": os.path.abspath(fn), "line": int(fr.lineno or 1),
                "func": fr.name or "?", "snippet": (fr.line or "")[:200]}
    return None


class SanitizeReport:
    """The runtime sanitizer's evidence, in the JAX package's
    ``sanitize_report.json`` schema: ``{"version": 1, "violations": [...]}``
    with each violation ``{kind, path, line, func, snippet, detail}``.
    ``kind`` keeps the JAX names: ``transfer_guard`` (a dispatch
    synchronized with the host under ``set_sync_debug_mode("error")``,
    the port's transfer guard) and ``steady_recompile`` (a CUDA graph was
    captured after steady state). :meth:`write` never raises."""

    VERSION = 1
    # PyTorch's message when set_sync_debug_mode("error") refuses a sync
    _TRIP = "synchronizing CUDA operation"

    def __init__(self) -> None:
        self.violations: List[Dict[str, Any]] = []

    def record(self, kind: str, detail: str,
               site: Optional[Dict[str, Any]] = None) -> None:
        if site is None:  # {} means "explicitly no location"
            site = _user_site(traceback.extract_stack()) or {}
        self.violations.append({
            "kind": kind,
            "path": site.get("path", ""),
            "line": site.get("line", 0),
            "func": site.get("func", ""),
            "snippet": site.get("snippet", ""),
            "detail": detail[:500],
        })

    @classmethod
    def _is_trip(cls, exc: BaseException) -> bool:
        return cls._TRIP in str(exc)

    @contextlib.contextmanager
    def watch(self):
        """Record a guard trip's evidence (site: the deepest port frame of
        the raising traceback) as it propagates; the error is re-raised."""
        try:
            yield
        except Exception as e:
            if self._is_trip(e):
                self.record("transfer_guard", detail=str(e)[:500],
                            site=_user_site(
                                traceback.extract_tb(e.__traceback__)))
            raise

    def note_recompiles(self, monitor: RecompileMonitor,
                        steady_after: int) -> None:
        """Every capture past the first ``steady_after`` becomes a
        ``steady_recompile`` violation."""
        for site in monitor.sites:
            if site.get("ordinal", 0) <= steady_after:
                continue
            self.record("steady_recompile",
                        detail=f"CUDA graph capture after steady state "
                               f"({site.get('detail', '')})", site=site)
        if not monitor.sites and monitor.count > steady_after:
            self.record("steady_recompile",
                        detail=f"{monitor.count - steady_after} capture(s) "
                               f"after steady state ({monitor.last})",
                        site={})

    def write(self, out_dir: str) -> str:
        """Atomic best-effort sidecar write; returns the path ("" on any
        failure)."""
        if not out_dir or "://" in out_dir:
            return ""
        path = os.path.join(out_dir, SANITIZE_REPORT_NAME)
        try:
            os.makedirs(out_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"version": self.VERSION,
                           "violations": self.violations}, f, indent=1)
            os.replace(tmp, path)
            return path
        except OSError:
            return ""


@contextlib.contextmanager
def sync_allowed(device) -> Iterator[None]:
    """Lift the sanitizer's guard (``torch.cuda.set_sync_debug_mode``) for
    an intended host<->device transfer inside a guarded region - a
    collective that gloo stages through host memory, say - and restore it
    after; nothing happens off CUDA or when no guard is set. The JAX guard
    likewise keeps explicit transfers legal."""
    if getattr(device, "type", device) != "cuda":
        yield
        return
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    if prev == 0:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def peak_live_bytes(device=None) -> int:
    """Peak device allocation of this process on ``device`` (a CUDA
    device; default the current one), ``torch.cuda.max_memory_allocated``;
    0 on the CPU or without CUDA - the gauge is then "unavailable", not
    "empty"."""
    if device is not None and getattr(device, "type", device) != "cuda":
        return 0
    import torch
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.max_memory_allocated(device))


class StallBreakdown:
    """Per-step stall accounting: WHERE the host loop's wall time goes
    (the JAX class). Four gauges, attributed by the trainer and the
    device-prefetch wrapper:

    * ``data_wait_s``   - blocked on the host iterator;
    * ``h2d_wait_s``    - placing the batch on the device (the prefetch
      wrapper's pinned copy, or the step's own copy without prefetch);
    * ``dispatch_s``    - issuing the step: the eager forward, backward
      and update launches (the host's share of the step; with
      ``dispatch_lag`` >= 1 it overlaps the previous step's device work);
    * ``device_step_s`` - trailing: from a step's dispatch returning to its
      metrics being fetched ``dispatch_lag`` steps later (an upper bound
      on device execution; it includes queue wait).

    ``add`` accumulates; ``lap`` returns the window's per-step means and
    resets it; ``totals`` is cumulative; ``sums`` the cumulative seconds.
    Gauges with no samples report 0.0."""

    GAUGES = ("data_wait_s", "h2d_wait_s", "dispatch_s", "device_step_s")

    def __init__(self) -> None:
        self._win = {g: [0.0, 0] for g in self.GAUGES}   # [sum, count]
        self._tot = {g: [0.0, 0] for g in self.GAUGES}

    def add(self, gauge: str, seconds: float) -> None:
        for acc in (self._win[gauge], self._tot[gauge]):
            acc[0] += seconds
            acc[1] += 1

    @staticmethod
    def _means(accs) -> dict:
        return {g: (s / n if n else 0.0) for g, (s, n) in accs.items()}

    def lap(self) -> dict:
        """Per-step means since the last lap; resets the window."""
        out = self._means(self._win)
        self._win = {g: [0.0, 0] for g in self.GAUGES}
        return out

    def totals(self) -> dict:
        """Cumulative per-step means since construction."""
        return self._means(self._tot)

    def sums(self) -> dict:
        """Cumulative SECONDS per gauge since construction (not means) -
        the goodput decomposition needs absolute time, not rates."""
        return {g: s for g, (s, _) in self._tot.items()}


class GoodputTracker:
    """A training attempt's wall time decomposed into where it went (the
    JAX class): ``goodput`` = useful-step time / wall time.

    Categories are EXCLUSIVE overheads, attributed by the trainer:

    * ``startup_s``   - process spawn -> ``TrainLoop`` construction
      (interpreter, torch import, process-group init; known only under
      the launcher, which stamps the spawn wall clock into ``DPT_SPAWN_T``);
    * ``setup_s``     - construction minus restore and compile (state
      init, the model);
    * ``restore_s``   - checkpoint discovery and restore, the walk-back
      over corrupt checkpoints included;
    * ``compile_s``   - the first use of the kernel library
      (``ops/_build.py``: the nvcc build on a cold tree, the load on a
      warm one);
    * ``save_s``      - blocking checkpoint-save time;
    * ``data_stall_s``- blocked on the input pipeline (attributed at
      summary time from the ``StallBreakdown`` sums);
    * ``recompute_s`` - re-running steps a previous attempt had already
      passed.

    ``hang_s`` - the window a wedged attempt burned before the launcher's
    watchdog killed it - is not here: a hung process cannot attribute its
    own waste, so the launcher books it into the attempt record, and
    ``chaos.goodput.aggregate_run`` folds it. ``useful_step_s`` is the
    residual, wall minus the overheads, so every second is accounted by
    construction. ``base_s`` moves the wall origin before construction
    (the startup share, measured on another clock)."""

    CATEGORIES = ("startup_s", "setup_s", "restore_s", "compile_s",
                  "save_s", "data_stall_s", "recompute_s")

    def __init__(self, t0: Optional[float] = None) -> None:
        self._t0 = time.perf_counter() if t0 is None else t0
        self.base_s = 0.0
        self._acc = {c: 0.0 for c in self.CATEGORIES}

    def add(self, category: str, seconds: float) -> None:
        self._acc[category] += max(0.0, seconds)

    def get(self, category: str) -> float:
        return self._acc[category]

    def wall_s(self) -> float:
        return self.base_s + (time.perf_counter() - self._t0)

    def summary(self, extra: Optional[dict] = None) -> dict:
        """Point-in-time decomposition. ``extra`` merges categories whose
        running total lives elsewhere (the trainer passes the
        StallBreakdown's ``data_stall_s`` sum here)."""
        acc = dict(self._acc)
        for k, v in (extra or {}).items():
            acc[k] = acc.get(k, 0.0) + max(0.0, v)
        wall = self.wall_s()
        overhead = sum(acc.values())
        useful = max(0.0, wall - overhead)
        return {
            "wall_s": wall,
            "useful_step_s": useful,
            "goodput": (useful / wall) if wall > 0 else 0.0,
            **acc,
        }


# the profiler's default window: loop steps [3, 8), past the first use of
# each kernel and allocator path
PROFILE_WINDOW = (3, 8)


def parse_profile_steps(profile_steps: str) -> Tuple[int, int]:
    """``"A:B"`` -> the profiler window ``(A, B)`` of loop steps counted
    from loop entry, ``[A, B)``; empty -> ``PROFILE_WINDOW``. Raises
    ``ValueError`` with the JAX trainer's messages."""
    if not profile_steps:
        return PROFILE_WINDOW
    try:
        a, b = (int(x) for x in profile_steps.split(":"))
    except ValueError:
        raise ValueError(f"profile_steps must be 'A:B' loop-step ints, got "
                         f"{profile_steps!r}") from None
    if not 0 <= a < b:
        raise ValueError(f"profile_steps window must satisfy 0 <= A < B, "
                         f"got {profile_steps!r}")
    return a, b
