"""Performance gauges: the port's part of
``distributed_pipeline_tpu/utils/perf.py`` - ``EventStats`` (serving TTFT
percentiles), ``StepTimer``, the training FLOP count and ``mfu`` - plus the
published rates of the cards the port targets (``CARDS``). No TPU peak is
carried over: MFU here is always against a card's own data sheet."""

from __future__ import annotations

import time
from typing import Optional, Tuple

__all__ = ["EventStats", "StepTimer", "CARDS", "card_rates",
           "transformer_train_flops_per_token", "mfu"]

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


def mfu(tokens_per_sec: float, flops_per_token: float, device_name: str,
        n_devices: int = 1) -> float:
    """Model FLOPs utilization against the card's published dense bf16
    peak (``card_rates``; raises for an unknown card)."""
    peak = card_rates(device_name)[1]
    return tokens_per_sec * flops_per_token / (peak * n_devices)


class StepTimer:
    """Wall-clock step timing that skips the first ``warmup`` steps (first
    use of each kernel and allocator path). ``lap()`` returns (steps/s,
    tokens/s) over the window since the last call; call it after the step's
    work is complete (a synchronize) or accept a step of skew."""

    def __init__(self, tokens_per_step: float, warmup: int = 2):
        self.tokens_per_step = tokens_per_step
        self.warmup = warmup
        self._steps = 0
        self._t0: Optional[float] = None
        self._window_steps = 0

    def tick(self) -> None:
        self._steps += 1
        if self._steps == self.warmup:
            self._t0 = time.perf_counter()
            self._window_steps = 0
        elif self._steps > self.warmup:
            self._window_steps += 1

    def lap(self) -> Tuple[float, float]:
        if self._t0 is None or self._window_steps == 0:
            return 0.0, 0.0
        dt = time.perf_counter() - self._t0
        sps = self._window_steps / max(dt, 1e-9)
        self._t0 = time.perf_counter()
        self._window_steps = 0
        return sps, sps * self.tokens_per_step


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
