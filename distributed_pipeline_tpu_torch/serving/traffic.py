"""Arrival-process traffic generation for serving runs: a copy of
``distributed_pipeline_tpu/serving/traffic.py`` (numpy only).

Seeded, deterministic arrival processes for wall-clock serving:

* ``poisson`` — homogeneous Poisson at ``rate_rps`` (i.i.d. exponential
  inter-arrivals);
* ``bursty``  — groups of ``burst_size`` near-simultaneous arrivals every
  ``burst_every_s`` seconds (each request jittered by a small exponential
  inside its burst);
* ``diurnal`` — a non-homogeneous Poisson whose rate ramps sinusoidally
  between ``diurnal_floor * rate_rps`` and ``rate_rps`` over
  ``diurnal_period_s``, generated by thinning.

The same ``(process, rate, seed, ...)`` gives the same schedule and
prompts in any process (``numpy.random.default_rng`` / PCG64 is a fixed
algorithm), and the same as the JAX package's generator, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["TrafficRequest", "TrafficGenerator", "PROCESSES"]

PROCESSES = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One generated arrival: offset (seconds from stream start), prompt
    token ids, and the generation budget."""

    t: float
    prompt: np.ndarray
    max_new_tokens: int


class TrafficGenerator:
    """Seeded arrival-process + prompt generator.

    ``schedule(n)`` returns the first ``n`` arrival offsets (sorted,
    seconds); ``requests(n, ...)`` pairs them with deterministic prompts.
    A fresh rng is constructed per call from the seed, so repeated calls
    (and calls in different processes) yield identical output.
    """

    def __init__(self, process: str = "poisson", rate_rps: float = 8.0,
                 seed: int = 0, *, burst_every_s: float = 2.0,
                 burst_size: int = 8, diurnal_period_s: float = 30.0,
                 diurnal_floor: float = 0.2) -> None:
        if process not in PROCESSES:
            raise ValueError(f"unknown traffic process {process!r} "
                             f"(expected one of {PROCESSES})")
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        if process == "bursty" and (burst_size < 1 or burst_every_s <= 0):
            raise ValueError("bursty traffic needs burst_size >= 1 and "
                             "burst_every_s > 0")
        if process == "diurnal" and not 0.0 <= diurnal_floor <= 1.0:
            raise ValueError(f"diurnal_floor must be in [0, 1], got "
                             f"{diurnal_floor}")
        self.process = process
        self.rate_rps = float(rate_rps)
        self.seed = int(seed)
        self.burst_every_s = float(burst_every_s)
        self.burst_size = int(burst_size)
        self.diurnal_period_s = float(diurnal_period_s)
        self.diurnal_floor = float(diurnal_floor)

    # ------------------------------------------------------------ schedule

    def _rng(self, stream: int) -> np.random.Generator:
        # independent substreams (arrivals vs prompts) off one seed: the
        # prompt content must not change when the caller asks for a
        # different n of arrivals, and vice versa
        return np.random.default_rng((self.seed, stream))

    def schedule(self, n: int) -> np.ndarray:
        """First ``n`` arrival offsets in seconds, sorted ascending."""
        if n <= 0:
            return np.zeros((0,), np.float64)
        rng = self._rng(0)
        if self.process == "poisson":
            t = np.cumsum(rng.exponential(1.0 / self.rate_rps, n))
        elif self.process == "bursty":
            # burst b lands at b * burst_every_s; members jitter forward
            # by a small exponential (mean = 1% of the burst gap) so
            # intra-burst order is defined but the herd stays a herd
            burst = np.arange(n) // self.burst_size
            t = (burst * self.burst_every_s
                 + rng.exponential(self.burst_every_s / 100.0, n))
            t = np.sort(t)
        else:  # diurnal: non-homogeneous Poisson by thinning
            lam_max = self.rate_rps
            floor = self.diurnal_floor
            out: List[float] = []
            t_cur = 0.0
            # thinning needs an unbounded proposal stream; draw in blocks
            while len(out) < n:
                gaps = rng.exponential(1.0 / lam_max, 2 * n + 16)
                accept = rng.uniform(size=gaps.shape[0])
                for g, u in zip(gaps, accept):
                    t_cur += float(g)
                    phase = 2.0 * np.pi * t_cur / self.diurnal_period_s
                    lam = lam_max * (floor + (1.0 - floor)
                                     * 0.5 * (1.0 - np.cos(phase)))
                    if u * lam_max <= lam:
                        out.append(t_cur)
                        if len(out) == n:
                            break
            t = np.asarray(out, np.float64)
        return np.asarray(t, np.float64)

    # ------------------------------------------------------------ requests

    def requests(self, n: int, *, vocab_size: int, prompt_len: int,
                 max_new_tokens: int,
                 prompt_len_jitter: int = 0,
                 shared_prefix_len: int = 0) -> List[TrafficRequest]:
        """``n`` arrivals with deterministic prompts.

        ``prompt_len_jitter`` uniformly shortens prompts by up to that
        many tokens (never below 1); ``shared_prefix_len`` makes every
        prompt open with the SAME token run — the prefix-cache workload
        (real fleets share system prompts). Token ids stay in
        ``[4, vocab_size)`` like the serve entry's synthetic prompts.
        """
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        sched = self.schedule(n)
        rng = self._rng(1)
        lo = 4 if vocab_size > 4 else 0
        prefix = rng.integers(lo, vocab_size,
                              (max(0, shared_prefix_len),)).astype(np.int32)
        out: List[TrafficRequest] = []
        for i in range(n):
            plen = prompt_len
            if prompt_len_jitter > 0:
                plen = max(1, prompt_len
                           - int(rng.integers(0, prompt_len_jitter + 1)))
            body = rng.integers(lo, vocab_size,
                                (max(0, plen - prefix.shape[0]),))
            prompt = np.concatenate(
                [prefix[:plen], body.astype(np.int32)])
            out.append(TrafficRequest(t=float(sched[i]), prompt=prompt,
                                      max_new_tokens=max_new_tokens))
        return out

    def describe(self) -> str:
        base = f"{self.process}@{self.rate_rps:g}rps seed={self.seed}"
        if self.process == "bursty":
            base += (f" burst={self.burst_size}"
                     f"/{self.burst_every_s:g}s")
        if self.process == "diurnal":
            base += (f" period={self.diurnal_period_s:g}s"
                     f" floor={self.diurnal_floor:g}")
        return base


def make_generator(process: str, rate_rps: float, seed: int,
                   burst_every_s: float = 2.0, burst_size: int = 8,
                   diurnal_period_s: float = 30.0,
                   diurnal_floor: float = 0.2
                   ) -> Optional[TrafficGenerator]:
    """Config-level convenience: ``process == "steps"`` (the legacy
    scheduler-step arrival knob) maps to None — the caller keeps its old
    path — anything else builds a :class:`TrafficGenerator`."""
    if process == "steps":
        return None
    return TrafficGenerator(process, rate_rps, seed,
                            burst_every_s=burst_every_s,
                            burst_size=burst_size,
                            diurnal_period_s=diurnal_period_s,
                            diurnal_floor=diurnal_floor)
