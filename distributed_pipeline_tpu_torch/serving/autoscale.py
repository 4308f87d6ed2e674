"""SLO-driven autoscaler: replica capacity that tracks live traffic.

The control loop reads two live signals every :meth:`AutoScaler.step` —
the router's pending backlog and the p95 TTFT over a trailing window of
COMPLETED requests — and compares them against the SLO target:

* SCALE UP when the fleet is visibly behind (backlog per ready replica
  above ``up_backlog``, or windowed p95 TTFT above ``slo_ttft_s``), via
  :meth:`~.fleet.ServingFleet.add_replica` — the existing elastic
  supervision + warmup-before-ready machinery means the new replica
  takes zero traffic until its compile/warmup is done, so a scale-up can
  never make latency WORSE while it boots.
* SCALE DOWN when the fleet is idle (zero backlog AND p95 below
  ``down_frac * slo_ttft_s`` — the hysteresis band: the down threshold
  sits strictly below the up threshold so bursty traffic can't flap the
  fleet), via the hot-swap DRAIN path: stop placement on the victim,
  wait for its outstanding work to finish, then stop flag + retire. The
  victim must already be IDLE (zero outstanding) — a fleet whose every
  ready replica holds in-flight work is busy, not cold, no matter what
  the completion window says — so the drain is normally instant and
  scale-down never triggers a replay.

Both directions share a ``cooldown_s`` clamp (one structural change per
cooldown) and are journaled (``{"ev": "scale", ...}``) + span-traced, so
the decision trail survives in the same durable artifact as every
request.

``paid_idle`` accounting: replica-seconds that were UP but UNNEEDED —
ready replicas beyond ``min_replicas`` sitting with zero outstanding
work while the queue is empty. Accrued here (the only component that
knows "unneeded"), journaled as ``{"ev": "paid_idle", ...}`` deltas, and
re-booked out of ``serving`` by ``chaos.goodput.aggregate_serving`` the
same way replay is — ``accounted_frac`` stays 1.0 by construction. It is
the autoscaler's own report card: a perfect scaler drives it to ~0.

Import-light (stdlib only): runs in the torch-free fleet process, beside
the router, driven from the same poll loop that steps hot-swaps.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from ..obs import trace as trace_lib

__all__ = ["AutoScaler"]


def _p95(values: List[float]) -> Optional[float]:
    if not values:
        return None
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(0.95 * len(vals)))]


class AutoScaler:
    """Drive with :meth:`step` from the fleet poll loop; call
    :meth:`close` before the final goodput fold so accrued-but-unflushed
    ``paid_idle`` reaches the journal."""

    def __init__(self, fleet, router, *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 slo_ttft_s: float = 10.0,
                 up_backlog: float = 2.0,
                 down_frac: float = 0.5,
                 cooldown_s: float = 5.0,
                 window_s: float = 30.0,
                 drain_timeout_s: float = 60.0,
                 journal_path: Optional[str] = None,
                 tracer=None) -> None:
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min ({min_replicas}) <= max ({max_replicas})")
        if not 0.0 <= down_frac < 1.0:
            raise ValueError(f"down_frac must be in [0, 1), got {down_frac}"
                             " — the hysteresis band would invert")
        self.fleet = fleet
        self.router = router
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.slo_ttft_s = slo_ttft_s
        self.up_backlog = up_backlog
        self.down_frac = down_frac
        self.cooldown_s = cooldown_s
        self.window_s = window_s
        self.drain_timeout_s = drain_timeout_s
        self.journal_path = (journal_path if journal_path is not None
                             else router.journal_path)
        self.tracer = tracer if tracer is not None else trace_lib.NULL
        self.scale_ups = 0
        self.scale_downs = 0
        self.paid_idle_s = 0.0          # journaled total
        self._unflushed: Dict[int, float] = {}   # rid -> accrued idle s
        self._last_scale_mono: Optional[float] = None
        self._last_step_mono: Optional[float] = None
        self._last_flush_mono = time.monotonic()
        self._draining_rid: Optional[int] = None
        self._drain_t0: Optional[float] = None

    # ------------------------------------------------------------- journal

    def _journal(self, event: dict) -> None:
        try:
            with open(self.journal_path, "a") as f:
                f.write(json.dumps(event) + "\n")
        except OSError:
            pass  # telemetry degrades, scaling still works

    def _flush_idle(self, now: float) -> None:
        for rid, idle in sorted(self._unflushed.items()):
            if idle > 0.0:
                self._journal({"ev": "paid_idle", "replica": rid,
                               "idle_s": round(idle, 6), "t": now})
                self.paid_idle_s += idle
        self._unflushed.clear()
        self._last_flush_mono = time.monotonic()

    # ---------------------------------------------------------------- step

    def _active(self) -> List[int]:
        return [rid for rid in self.router.clients
                if not self.router.down(rid)]

    def _capacity(self) -> int:
        """Replicas that count against ``max_replicas``: everything not
        down, PLUS down replicas whose supervising ring is still alive
        (crash-looping — the restart budget may bring them back). A
        retired or budget-exhausted replica is down with a dead ring and
        stops counting, so a drain never eats scale-up headroom and a
        permanently dead replica can be replaced."""
        return sum(1 for rid in self.router.clients
                   if not self.router.down(rid) or self.fleet.alive(rid))

    def _ready_active(self) -> List[int]:
        ready = set(self.fleet.ready_replicas())
        return [rid for rid in self._active() if rid in ready]

    def _cooled(self, mono: float) -> bool:
        return (self._last_scale_mono is None
                or mono - self._last_scale_mono >= self.cooldown_s)

    def step(self, now: Optional[float] = None) -> None:
        """One control decision (at most one structural change per call,
        and none while a hot-swap roll owns the drain machinery)."""
        now = time.time() if now is None else now
        mono = time.monotonic()
        dt = (0.0 if self._last_step_mono is None
              else max(0.0, mono - self._last_step_mono))
        self._last_step_mono = mono

        ready = self._ready_active()
        backlog = self.router.backlog

        # paid_idle accrual: ready replicas beyond the floor, idle, with
        # nothing queued — capacity nobody needed this interval. Charged
        # to the highest rids (the ones a scale-down would pick).
        if dt > 0.0 and backlog == 0:
            idle = sorted((r for r in ready
                           if self.router.outstanding(r) == 0),
                          reverse=True)
            for rid in idle[:max(0, len(ready) - self.min_replicas)]:
                self._unflushed[rid] = self._unflushed.get(rid, 0.0) + dt
        if self._unflushed and mono - self._last_flush_mono >= 2.0:
            self._flush_idle(now)

        if getattr(self.fleet, "swap_active", False):
            return

        # finish an in-progress drain-down before any new decision
        if self._draining_rid is not None:
            rid = self._draining_rid
            timed_out = (self._drain_t0 is not None
                         and mono - self._drain_t0 > self.drain_timeout_s)
            if (not self.fleet.alive(rid) or self.router.down(rid)
                    or self.router.outstanding(rid) == 0 or timed_out):
                self.fleet.stop_replica(rid)
                self.router.retire(rid)
                self.scale_downs += 1
                self._draining_rid = None
                self._drain_t0 = None
                self._last_scale_mono = mono
                self._journal({"ev": "scale", "dir": "down",
                               "replica": rid, "t": now,
                               "drained": not timed_out,
                               "n_active": len(self._active())})
                if self.tracer.enabled:
                    self.tracer.instant("scale_down", "autoscale",
                                        args={"replica": rid,
                                              "drained": not timed_out})
            return

        n_active = len(self._active())
        p95 = _p95(self.router.recent_ttfts(self.window_s, now))
        n_ready = max(1, len(ready))

        hot = (backlog > self.up_backlog * n_ready
               or (p95 is not None and p95 > self.slo_ttft_s))
        # the ceiling counts supervised capacity (``_capacity``), not
        # just healthy replicas: a crash-looping fleet is hot (backlog
        # grows, nothing ready) but its down replicas still own restart
        # budget — gating on healthy-only spawned a fresh ring every
        # cooldown for as long as an outage lasted (caught live: 13
        # scale-ups, 14 replica dirs, with max_replicas=2)
        if hot and self._capacity() < self.max_replicas and self._cooled(mono):
            rid = self.fleet.add_replica()
            self.router.add_client(rid, self.fleet.client(rid))
            self.scale_ups += 1
            self._last_scale_mono = mono
            reason = ("backlog" if backlog > self.up_backlog * n_ready
                      else "ttft_p95")
            self._journal({"ev": "scale", "dir": "up", "replica": rid,
                           "t": now, "reason": reason,
                           "backlog": backlog,
                           "ttft_p95_s": p95,
                           "n_active": n_active + 1})
            if self.tracer.enabled:
                self.tracer.instant("scale_up", "autoscale",
                                    args={"replica": rid, "reason": reason,
                                          "backlog": backlog})
            return

        cold = (backlog == 0
                and (p95 is None or p95 < self.down_frac * self.slo_ttft_s))
        if cold and n_active > self.min_replicas and self._cooled(mono):
            # victim: the highest-rid IDLE ready replica. Requiring an
            # idle victim also keeps a warming fleet honest — right
            # after startup p95 is None with everything in flight, and
            # busy replicas must not drain on that empty signal. The
            # drain-first machinery stays as the guard for work placed
            # in the same poll round (draining gates placement at once).
            victims = [r for r in ready
                       if not self.router.draining(r)
                       and self.router.outstanding(r) == 0]
            if not victims:
                return
            victim = max(victims)
            self.router.set_draining(victim, True)
            self._draining_rid = victim
            self._drain_t0 = mono

    # --------------------------------------------------------------- close

    def close(self, now: Optional[float] = None) -> None:
        """Flush accrued paid_idle and un-drain any half-finished victim
        (shutdown interrupts the drain; the fleet-wide stop takes over)."""
        if self._draining_rid is not None:
            self.router.set_draining(self._draining_rid, False)
            self._draining_rid = None
        self._flush_idle(time.time() if now is None else now)

    def summary(self) -> dict:
        return {
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "paid_idle_s": round(
                self.paid_idle_s + sum(self._unflushed.values()), 4),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "n_active": len(self._active()),
        }
