"""Per-phase cost ledger and roofline MFU-gap attribution: the port of
``distributed_pipeline_tpu/obs/ledger.py``.

Two layers are copies of the JAX module's stdlib parts, with the same
names and arithmetic:

* **attribution** — :func:`roofline_attribution` folds a phase's FLOPs and
  bytes with the analytic ``flops_per_token`` and the measured tokens/s
  into one row::

      mfu + mfu_gap_host + mfu_gap_comms + mfu_gap_memory_bound
          + mfu_gap_residual == 1        (exactly, by construction)

  each gap term a component's estimated share of step wall time, capped
  in trust order (host, comms, memory), the residual the exact rest;
* **persistence** — :func:`write_ledger` / :func:`read_ledger` keep one
  ``perf_ledger.json`` per run dir (atomic replace).

The third, **extraction**, cannot be copied: the JAX module reads XLA's
``cost_analysis()`` off a compiled executable, and neither a CUDA graph
nor an eager step has such accounting. :class:`ServeCensus` and
:class:`TrainCensus` count the phases instead, from the model's shapes
and the kernels' own byte counts. :class:`PaddingMeter` is the JAX class
(the ``padding_waste_frac`` of a training row). The serving census, per
execution:

* FLOPs: every matmul's ``2 * m * n * k`` — per token the 12 D^2 weights
  of each layer's QKV, output and MLP products and the D x V tied head —
  plus attention's score and value products, ``4 * D`` a key a layer
  (prefill: the dense arm's full [Lp, Lp] square per row; decode and
  verify: each slot's live keys at each step or link);
* bytes: the weights as the forward reads them (each f32 master once,
  and in a 16-bit compute dtype the cast's write and the GEMM's read of
  the copy: 8 bytes a weight in bf16, 4 in f32); the attention kernels'
  own counts, ``decode_hbm_bytes(step_table=False)`` a decode step and
  ``span_hbm_bytes`` a verify, per layer (the prefill's dense attention
  reads its local k/v, counted with the activations below: not at all);
  the K/V writes (int8 pools: each written page read and written whole by
  rescale-on-grow, a verify's O(pool) re-expression read and written
  once); the logits written once. Activations between kernels are not
  counted, so the figure is a floor.

The training census, per optimizer step (:class:`TrainCensus`):

* FLOPs: ``transformer_train_flops_per_token`` times the step's tokens,
  the analytic number the JAX ``train_step`` row carries;
* bytes: the fused update's ``update_hbm_bytes``; the weights as each
  microbatch's forward and its backward read them (the f32 masters, and
  in a 16-bit compute dtype the cast's copy written and read: 8 bytes a
  weight a pass in bf16, 4 in f32); ``flash_hbm_bytes`` for each flash
  launch the step makes. Activations are not counted, so the figure is a
  floor;
* ``collective_bytes_per_step``: the flat gradient's all-reduce payload
  (4 bytes a parameter) under several ranks, plus the bytes the ring's
  shifts sent under sequence parallelism (``parallel/dist.py``
  ``ring_shift_bytes``); 0 for one process.

The bandwidth table keeps the port's cards (``utils/perf.CARDS``) and the
CPU row that keeps CPU test attributions finite; no TPU rate is carried
over.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np

from ..utils.perf import CARDS

__all__ = [
    "LEDGER_FILENAME", "GAP_TERMS", "ServeCensus", "TrainCensus",
    "PaddingMeter", "attribution_columns",
    "device_bandwidths", "device_peak_flops", "gap_sum_identity",
    "ledger_path", "read_ledger", "roofline_attribution", "write_ledger",
]

LEDGER_FILENAME = "perf_ledger.json"

# the attribution row's gap terms, in attribution (= trust) order
GAP_TERMS = ("mfu_gap_host", "mfu_gap_comms", "mfu_gap_memory_bound",
             "mfu_gap_residual")

# NVLink bytes/s a card moves to its peers (NVIDIA data sheets: "H100
# Tensor Core GPU" — SXM 900 GB/s, NVL and PCIe 600 GB/s by NVLink bridge;
# "H200 Tensor Core GPU" — 900 GB/s), matched like CARDS
_NVLINK = {"H100 80GB HBM3": 9.0e11, "H100 NVL": 6.0e11,
           "H100 PCIe": 6.0e11, "H200": 9.0e11}

# (device-name substring, memory bytes/s, interconnect bytes/s): the port's
# cards, memory rates from utils/perf.CARDS; then the JAX module's CPU row
_BANDWIDTHS = tuple((name.lower(), rates[0], _NVLINK[name])
                    for name, rates in CARDS.items()) + (
    ("cpu", 2.0e10, 1.0e10),)

# the JAX module's CPU peak (utils/perf._PEAK_FLOPS), which keeps CPU
# attributions finite and small
_CPU_PEAK_FLOPS = 1e11


def device_bandwidths(device_kind: str = "cpu") -> Dict[str, float]:
    """Memory and interconnect bytes/s of a device, by the name
    ``torch.cuda.get_device_name`` gives (or "cpu"): the roofline
    denominators. The JAX key name ``ici_bytes_per_s`` is kept."""
    kind = (device_kind or "cpu").lower()
    for key, hbm, link in _BANDWIDTHS:
        if key in kind:
            return {"hbm_bytes_per_s": hbm, "ici_bytes_per_s": link}
    return {"hbm_bytes_per_s": 2.0e10, "ici_bytes_per_s": 1.0e10}


def device_peak_flops(device_kind: str = "cpu") -> float:
    """Dense bf16 peak of a card in ``utils/perf.CARDS``; the JAX
    module's CPU constant for anything else."""
    for name, rates in CARDS.items():
        if name.lower() in (device_kind or "").lower():
            return rates[1]
    return _CPU_PEAK_FLOPS


def roofline_attribution(*, tokens_per_s: float, flops_per_token: float,
                         peak_flops: float, n_devices: int,
                         steps_per_s: float = 0.0,
                         collective_bytes_per_step: float = 0.0,
                         bytes_accessed: float = 0.0,
                         host_stall_s_per_step: float = 0.0,
                         device_kind: str = "cpu",
                         padding_waste_frac: float = 0.0
                         ) -> Dict[str, float]:
    """The roofline MFU-gap decomposition for one phase (the JAX
    function, line for line). ``mfu`` is MEASURED (achieved model FLOP/s
    over peak); each gap term is a component's estimated share of
    per-step wall time, capped in trust order (host -> comms -> memory);
    ``mfu_gap_residual`` is the exact remainder. With no per-step wall
    clock (``steps_per_s`` 0) every modeled term is 0 and the whole gap
    lands in the residual."""
    bw = device_bandwidths(device_kind)
    mfu = 0.0
    if peak_flops > 0 and n_devices > 0:
        mfu = tokens_per_s * flops_per_token / (peak_flops * n_devices)
    mfu = min(max(mfu, 0.0), 1.0)
    gap = 1.0 - mfu
    step_s = 1.0 / steps_per_s if steps_per_s > 0 else 0.0
    host_frac = comms_frac = mem_frac = 0.0
    if step_s > 0:
        host_frac = max(0.0, host_stall_s_per_step) / step_s
        comms_frac = (max(0.0, collective_bytes_per_step)
                      / bw["ici_bytes_per_s"]) / step_s
        ideal_s = 0.0
        if peak_flops > 0 and n_devices > 0 and tokens_per_s > 0:
            ideal_s = (tokens_per_s * flops_per_token * step_s
                       / (peak_flops * n_devices))
        mem_s = max(0.0, bytes_accessed / bw["hbm_bytes_per_s"] - ideal_s)
        mem_frac = mem_s / step_s
    gap_host = min(gap, host_frac)
    gap_comms = min(gap - gap_host, comms_frac)
    gap_mem = min(gap - gap_host - gap_comms, mem_frac)
    gap_residual = gap - gap_host - gap_comms - gap_mem
    return {
        "mfu": mfu,
        "mfu_gap_host": gap_host,
        "mfu_gap_comms": gap_comms,
        "mfu_gap_memory_bound": gap_mem,
        "mfu_gap_residual": gap_residual,
        "collective_bytes_per_step": float(
            max(0.0, collective_bytes_per_step)),
        "padding_waste_frac": min(max(float(padding_waste_frac), 0.0), 1.0),
    }


def attribution_columns(row: Dict[str, Any]) -> Dict[str, Any]:
    """The bench-row subset of a ledger row: ``mfu`` (unrounded), the four
    gap terms, the collective payload and the padding waste."""
    keys = ("mfu",) + GAP_TERMS + ("collective_bytes_per_step",
                                   "padding_waste_frac")
    return {k: row[k] for k in keys if k in row}


def gap_sum_identity(row: Dict[str, Any]) -> float:
    """``mfu + sum(gap terms)`` — 1.0 within float precision for any row
    :func:`roofline_attribution` produced."""
    return float(row.get("mfu", 0.0)) + sum(
        float(row.get(k, 0.0)) for k in GAP_TERMS)


# ------------------------------------------------------------ census

class ServeCensus:
    """FLOPs and bytes of the serving phases, per execution, counted from
    the model's shapes and the kernels' byte counts (module docstring).
    The scheduler calls :meth:`prefill`, :meth:`decode` and
    :meth:`verify` at each dispatch with the host's mirror of the state;
    :meth:`cost` gives a phase's mean per execution."""

    def __init__(self, *, num_layers: int, hidden: int, heads: int,
                 vocab: int, compute_bytes: int, kv_quant: str,
                 page_size: int, max_pages: int) -> None:
        self.L, self.D, self.H, self.V = num_layers, hidden, heads, vocab
        self.cb = compute_bytes
        self.quant = kv_quant == "int8"
        self.kvb = 1 if self.quant else compute_bytes
        self.ps = page_size
        self.max_pages = max_pages
        self.matmul_params = 12 * hidden * hidden * num_layers \
            + hidden * vocab
        # the f32 masters, and in a 16-bit dtype the cast's copy written and
        # read
        self.weight_bytes = self.matmul_params * (
            4 if compute_bytes >= 4 else 4 + 2 * compute_bytes)
        self._sums: Dict[str, list] = {}

    def _add(self, phase: str, flops: float, nbytes: float) -> None:
        acc = self._sums.setdefault(phase, [0.0, 0.0, 0])
        acc[0] += flops
        acc[1] += nbytes
        acc[2] += 1

    def _tokens(self, n: int) -> tuple:
        """Matmul FLOPs, weight and logits bytes of ``n`` tokens through
        one forward."""
        return (2.0 * n * self.matmul_params,
                self.weight_bytes + n * self.V * self.cb)

    def prefill(self, batch: int, length: int) -> None:
        n = batch * length
        flops, nbytes = self._tokens(n)
        flops += 4.0 * self.D * self.L * batch * length * length
        nbytes += 2 * n * self.D * self.kvb * self.L          # K, V writes
        self._add("prefill", flops, nbytes)

    def decode(self, block_table: np.ndarray, positions: np.ndarray,
               span: int) -> None:
        """``positions`` [S]: each slot's position before the dispatch
        (its inactive slots at 0, one trash page)."""
        from ..ops.flash_decode import decode_hbm_bytes
        S = positions.shape[0]
        dh = self.D // self.H
        flops = nbytes = 0.0
        for i in range(span):
            pos = positions + i
            f, b = self._tokens(S)
            flops += f + 4.0 * self.D * self.L * float((pos + 1).sum())
            nbytes += b + self.L * decode_hbm_bytes(
                block_table, pos, self.ps, self.H, dh, self.cb,
                quantized=self.quant, step_table=False)
            if self.quant:   # each written page read and written whole
                nbytes += 2 * 2 * S * self.ps * self.D * self.L
            else:
                nbytes += 2 * S * self.D * self.kvb * self.L
        self._add("decode", flops, nbytes)

    def verify(self, block_table: np.ndarray, positions: np.ndarray,
               links: int) -> None:
        """``positions`` [S]: each slot's first link's position."""
        from ..ops.flash_decode import span_hbm_bytes
        S = positions.shape[0]
        dh = self.D // self.H
        pos = positions[:, None] + np.arange(links)[None, :]
        flops, nbytes = self._tokens(S * links)
        flops += 4.0 * self.D * self.L * float((pos + 1).sum())
        nbytes += self.L * span_hbm_bytes(block_table, pos, self.ps, self.H,
                                          dh, self.cb, quantized=self.quant)
        if self.quant:   # the O(pool) re-expression, K and V
            nbytes += 2 * 2 * self.max_pages * self.ps * self.D * self.L
        else:
            nbytes += 2 * S * links * self.D * self.kvb * self.L
        self._add("verify", flops, nbytes)

    def cost(self, phase: str) -> Dict[str, float]:
        """``flops_per_execution`` and ``bytes_accessed`` (the JAX keys):
        the phase's mean per execution, zeros before its first."""
        flops, nbytes, n = self._sums.get(phase, (0.0, 0.0, 0))
        return {"flops_per_execution": flops / n if n else 0.0,
                "bytes_accessed": nbytes / n if n else 0.0}

    def reset(self) -> None:
        self._sums.clear()


class TrainCensus:
    """FLOPs and bytes of one optimizer step, counted from the model's
    shapes and the kernels' byte counts (module docstring).
    ``flash_shape`` is ``(B, H, L, Dh, has_mask)`` of the step's flash
    launches (a microbatch's attention on this rank); :meth:`cost` takes
    the launches and ring-shift bytes the step made, as the trainer
    counts them. ``update_elems`` is the range the rank's update covers
    (its ZeRO-1 shard; default all of the parameters)."""

    def __init__(self, *, n_params: int, num_layers: int, hidden: int,
                 seq_len: int, tokens_per_step: int, n_micro: int,
                 compute_bytes: int, n_ema_rates: int, world: int,
                 flash_shape: tuple,
                 update_elems: Optional[int] = None) -> None:
        from ..ops.fused_update import update_hbm_bytes
        from ..utils.perf import transformer_train_flops_per_token
        self.flops_per_token = transformer_train_flops_per_token(
            n_params, num_layers, hidden, seq_len)
        self.tokens_per_step = tokens_per_step
        self.compute_bytes = compute_bytes
        self.flash_shape = flash_shape
        weight_pass = n_params * (4 if compute_bytes >= 4
                                  else 4 + 2 * compute_bytes)
        # the update runs over the rank's owned range (ZeRO-1's shard)
        update_elems = n_params if update_elems is None else update_elems
        self.base_bytes = (update_hbm_bytes([update_elems], n_ema_rates,
                                            per_leaf_scalars=False)
                           + 2 * n_micro * weight_pass)
        self.allreduce_bytes = 4.0 * n_params if world > 1 else 0.0

    def cost(self, flash_forward: float = 0.0, flash_backward: float = 0.0,
             ring_shift_bytes: float = 0.0) -> Dict[str, float]:
        """``flops_per_execution``, ``bytes_accessed`` and
        ``collective_bytes_per_step`` (the JAX keys) of a step that made
        ``flash_forward`` / ``flash_backward`` launches and sent
        ``ring_shift_bytes`` over the sequence ring."""
        from ..ops.flash_attention import flash_hbm_bytes
        B, H, L, Dh, has_mask = self.flash_shape
        nbytes = (self.base_bytes
                  + flash_forward * flash_hbm_bytes(
                      B, H, L, Dh, self.compute_bytes, has_mask)
                  + flash_backward * flash_hbm_bytes(
                      B, H, L, Dh, self.compute_bytes, has_mask,
                      backward=True))
        return {"flops_per_execution":
                    self.flops_per_token * self.tokens_per_step,
                "bytes_accessed": float(nbytes),
                "collective_bytes_per_step":
                    self.allreduce_bytes + ring_shift_bytes}


class PaddingMeter:
    """Active-vs-padded token accounting off the masks the data path
    already carries (``pad_mask``: 1 for real tokens; the JAX class).
    Thread-safe; ``frac`` is the cumulative padding-waste fraction — the
    share of step FLOPs spent on tokens that are pure padding."""

    def __init__(self) -> None:
        self._active = 0
        self._total = 0
        self._lock = threading.Lock()

    def add(self, active: int, total: int) -> None:
        with self._lock:
            self._active += int(active)
            self._total += int(total)

    @property
    def frac(self) -> float:
        with self._lock:
            if self._total <= 0:
                return 0.0
            return 1.0 - self._active / self._total


# ------------------------------------------------------------ persistence

def ledger_path(run_dir: str) -> str:
    return os.path.join(run_dir, LEDGER_FILENAME)


def write_ledger(run_dir: str, programs: Dict[str, Dict[str, Any]], *,
                 t: float, extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomically replace the run dir's ``perf_ledger.json``. An OSError is
    swallowed: the ledger must never fail the run it describes."""
    path = ledger_path(run_dir)
    payload = {"t": t, "programs": programs, **(extra or {})}
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except OSError:
        pass
    return path


def read_ledger(run_dir: str) -> Optional[Dict[str, Any]]:
    """The run dir's ledger snapshot, or None (absent, torn or garbled)."""
    try:
        with open(ledger_path(run_dir)) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None
