"""Serving settings: the fields of the JAX package's ``ServeSettings``
(``distributed_pipeline_tpu/config/serve.py``) as a dataclass with an
argparse bridge, the single replica's and the fleet's.

Every field is a ``--flag`` with the JAX package's name, default and
meaning; ``--device`` is the port's own (the JAX package picks its backend
from the environment). ``DEFERRED`` maps an option that the parser accepts
but the port does not serve yet to the ROADMAP item that brings it; every
option is served now, so it is empty.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["ServeSettings", "DEFERRED", "create_parser", "parse_settings"]

# option -> (the only value served now, the ROADMAP item that brings more)
DEFERRED: Dict[str, Tuple[object, str]] = {}

_TRUE = {"true", "t", "1", "yes", "y", "on"}
_FALSE = {"false", "f", "0", "no", "n", "off"}


def _bool(value: str) -> bool:
    v = str(value).strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def _f(default, help: str, choices: Optional[Sequence] = None):
    return dataclasses.field(default=default,
                             metadata={"help": help, "choices": choices})


@dataclasses.dataclass
class ServeSettings:
    """Continuous-batching decode service over a port run directory."""

    checkpoint_path: str = _f("", "run directory (training_args.json + "
                                  "model_NNNNNN.pt)")
    step: int = _f(0, "checkpoint step to load (0 = newest)")
    device: str = _f("", "torch device; empty = cuda (the run fails "
                         "without CUDA unless 'cpu' is asked for)")

    decode_slots: int = _f(8, "decode batch size: decode always runs at "
                              "this many slots (inactive slots are masked)")
    page_size: int = _f(16, "tokens per KV-cache page")
    max_pages: int = _f(0, "total pages in the per-layer KV pool (incl. the "
                           "reserved trash page); 0 = full residency "
                           "(decode_slots * ceil(max_len/page_size) + 1)")
    max_prompt_len: int = _f(0, "prefill length — prompts pad up to it "
                                "(0 = max_len/2)")
    max_len: int = _f(0, "longest prompt+generation per slot "
                         "(0 = the model's seq_len)")
    max_new_tokens: int = _f(64, "generation budget per request")
    prefill_batch: int = _f(0, "prompts prefilled per admission dispatch "
                               "(0 = min(decode_slots, 8))")
    decode_span: int = _f(4, "tokens generated per decode dispatch; a "
                             "request ending mid-span wastes up to span-1 "
                             "slot-steps")
    dispatch_lag: int = _f(2, "decode dispatches kept in flight before the "
                              "host fetches tokens")

    temperature: float = _f(0.0, "0 = greedy; > 0 samples")
    top_k: int = _f(0, "restrict sampling to the k most likely tokens")
    top_p: float = _f(0.0, "nucleus sampling mass (0 = off)")
    seed: int = _f(0, "sampling and synthetic-workload seed")
    eos_id: int = _f(-1, "finish a request early at this token id "
                         "(-1 = off)")

    prompt_file: str = _f("", "JSONL requests, one {\"prompt_ids\": [...]} "
                              "per line (optional \"max_new_tokens\"); "
                              "empty = synthetic workload")
    synthetic_requests: int = _f(32, "synthetic workload: request count")
    synthetic_prompt_len: int = _f(0, "synthetic prompt length "
                                      "(0 = max_prompt_len)")
    arrival_every_steps: int = _f(0, "synthetic-arrival knob "
                                     "(traffic='steps' only): enqueue one "
                                     "request every N scheduler steps "
                                     "(0 = all queued at start)")
    out: str = _f("", "write per-request JSONL results here")
    decode_impl: str = _f("auto", "decode-step attention: 'cuda' = the "
                                  "flash-decode kernel, 'torch' = the plain "
                                  "gather version, 'auto' = the kernel for "
                                  "CUDA tensors", ("auto", "cuda", "torch"))
    kv_quant: str = _f("fp", "paged KV storage: 'fp' = the model's dtype, "
                             "'int8' = int8 pages with per-page f32 scales "
                             "(about half the pool bytes)", ("fp", "int8"))
    spec_tokens: int = _f(0, "speculative decoding: draft K tokens a round "
                             "and verify them in ONE target forward; "
                             "greedy output is token-identical to the "
                             "non-speculative path. 0 = off")
    spec_draft: str = _f("ngram", "draft source: 'ngram' = prompt lookup "
                                  "on the host (no model work); 'model' = "
                                  "an early-exit engine over the target's "
                                  "first draft_layers blocks (weights "
                                  "shared)", ("ngram", "model"))
    draft_layers: int = _f(2, "spec_draft='model': how many leading target "
                              "blocks the draft model keeps")

    prefix_cache: bool = _f(False, "shared-prefix KV page reuse: requests "
                                   "whose prompts open with the same token "
                                   "run share the paged-KV pages holding "
                                   "that prefix (refcounted; evicted LRU "
                                   "under pool pressure)")
    serve_quant: str = _f("off", "quantize the WEIGHTS at load "
                                 "(serving/quantize.py): int8 storage "
                                 "round-trip with per-channel scales and a "
                                 "round-trip error guard", ("off", "int8"))
    cost_ledger: bool = _f(False, "per-phase cost ledger (obs/ledger.py): "
                                  "FLOPs/bytes census of the prefill/decode "
                                  "phases and the roofline MFU-gap "
                                  "attribution in the summary")
    sanitize: bool = _f(False, "runtime sanitizer: count CUDA graph "
                               "captures (recompile_count must stay 0 "
                               "after the first token) and refuse host "
                               "syncs inside engine dispatches; writes "
                               "sanitize_report.json beside the checkpoint")
    trace: bool = _f(False, "span tracing: instruments fleet mode "
                            "(--replicas; span files in the fleet dir); "
                            "the single-replica path prints a notice and "
                            "ignores it")
    traffic: str = _f("steps", "arrival process: 'steps' keeps the "
                               "scheduler-step cadence; poisson/bursty/"
                               "diurnal are seeded wall-clock processes "
                               "(serving/traffic.py)",
                      ("steps", "poisson", "bursty", "diurnal"))
    rate_rps: float = _f(8.0, "mean arrival rate (requests/second) for the "
                              "wall-clock traffic processes")
    burst_every_s: float = _f(2.0, "bursty traffic: seconds between bursts")
    burst_size: int = _f(8, "bursty traffic: arrivals per burst")
    diurnal_period_s: float = _f(30.0, "diurnal traffic: ramp period (a "
                                       "compressed day/night cycle)")
    diurnal_floor: float = _f(0.2, "diurnal traffic: trough rate as a "
                                   "fraction of rate_rps")
    shared_prefix_len: int = _f(0, "synthetic prompts open with this many "
                                   "SHARED tokens (the prefix-cache "
                                   "workload; 0 = fully random prompts)")

    ema: str = _f("", "EMA rate to serve (ema_{rate}_NNNNNN.pt); empty = "
                      "raw params")

    # ----------------------------------------------------------- fleet
    replicas: int = _f(0, "serve through a fleet of N replicas (each its "
                          "own supervised worker process behind the "
                          "request router) instead of one in-process "
                          "server; 0 = single-replica path")
    fleet_dir: str = _f("", "fleet working dir (journal + per-replica run "
                            "dirs); empty = <checkpoint_path>/fleet")
    fleet_worker_dir: str = _f("", "INTERNAL: run as a fleet replica worker "
                                   "against this replica dir (set by the "
                                   "fleet supervisor)")
    replica_id: int = _f(-1, "INTERNAL: this worker's replica index")
    replica_platform: str = _f("auto", "the replica workers' device: "
                                       "'auto' passes on this process's "
                                       "--device; 'cpu' or 'cuda' "
                                       "overrides it",
                               ("auto", "cpu", "cuda"))
    hang_timeout_s: float = _f(10.0, "per-replica hang watchdog: a replica "
                                     "whose beacons freeze this long is "
                                     "SIGKILLed and its in-flight requests "
                                     "replay on a sibling; must exceed the "
                                     "slowest legitimate tick + swap-"
                                     "restore gap. 0 disables")
    fleet_max_restarts: int = _f(3, "per-replica restart budget (sliding "
                                    "window, launcher semantics)")
    fleet_backoff_s: float = _f(0.25, "per-replica restart backoff base")
    stale_beacon_s: float = _f(10.0, "router health gate: stop placing NEW "
                                     "requests on a replica whose newest "
                                     "beacon is older than this")
    fleet_deadline_s: float = _f(300.0, "hard wall-clock cap on the fleet "
                                        "run; anything unfinished is "
                                        "reported dropped (acceptance is "
                                        "zero)")
    chaos_plan: str = _f("", "serving chaos schedule (JSON / @file; kinds "
                             "kill_replica / stall_replica / "
                             "corrupt_swap_checkpoint); also honors the "
                             "DPT_CHAOS_PLAN env")
    serve_transport: str = _f("file", "replica data-plane transport: "
                                      "'file' = atomic-rename mailboxes + "
                                      "beacon-mtime liveness; 'socket' = "
                                      "length-prefixed JSON frames over "
                                      "TCP + heartbeat liveness. The ctrl "
                                      "plane (ready/swap/stop/beacons) "
                                      "stays file-based either way",
                              ("file", "socket"))
    route_affinity: bool = _f(False, "prefix-affinity routing: place each "
                                     "request on the replica whose "
                                     "advertised prefix-cache index "
                                     "matches the most leading page-"
                                     "aligned prompt blocks (least-loaded "
                                     "on ties/cold prefixes); pair with "
                                     "--prefix_cache")

    # ------------------------------------------------------- autoscale
    autoscale: bool = _f(False, "SLO-driven autoscaler (serving/"
                                "autoscale.py): grow the replica set when "
                                "backlog/TTFT breach the SLO, shrink it "
                                "via the drain path when idle; --replicas "
                                "is the INITIAL size")
    autoscale_min: int = _f(1, "autoscaler floor (never drain below this "
                               "many active replicas)")
    autoscale_max: int = _f(0, "autoscaler ceiling (0 = the initial "
                               "--replicas count, i.e. scale-down only)")
    autoscale_slo_ttft_s: float = _f(10.0, "the TTFT SLO target: windowed "
                                           "p95 above this (or backlog "
                                           "above autoscale_up_backlog per "
                                           "ready replica) scales UP")
    autoscale_up_backlog: float = _f(2.0, "scale-up pressure threshold: "
                                          "pending requests per ready "
                                          "replica")
    autoscale_down_frac: float = _f(0.5, "hysteresis band: scale DOWN only "
                                         "when backlog is zero and "
                                         "windowed p95 TTFT sits below "
                                         "down_frac * slo")
    autoscale_cooldown_s: float = _f(5.0, "minimum seconds between "
                                          "structural changes (either "
                                          "direction)")
    autoscale_window_s: float = _f(30.0, "trailing window over completed "
                                         "requests feeding the p95-TTFT "
                                         "signal")

    # -------------------------------------------------- disaggregation
    disagg: int = _f(0, "disaggregated prefill/decode serving (mpmd/"
                        "disagg.py): the --replicas workers become PREFILL-"
                        "only workers that stream each admitted request's "
                        "paged-KV pages + first token over a StageLink to "
                        "a separately supervised DECODE ring; value = "
                        "decode ring count (only 1 is supported); 0 = "
                        "colocated")
    disagg_role: str = _f("", "INTERNAL: 'prefill' or 'decode' — set on "
                              "the worker argv by the disaggregated fleet "
                              "parent")
    disagg_links: str = _f("", "INTERNAL: StageLink directory shared by "
                               "the prefill and decode workers")
    disagg_peers: int = _f(0, "INTERNAL: number of prefill workers whose "
                              "kv/tok links the decode worker polls")

    # -------------------------------------------------------- hot-swap
    swap_after_requests: int = _f(0, "trigger a zero-downtime checkpoint "
                                     "hot-swap once this many requests "
                                     "have completed (0 = no swap)")
    swap_step: int = _f(0, "hot-swap target step (0 = newest finalized "
                           "checkpoint at swap time)")
    drain_timeout_s: float = _f(60.0, "hot-swap: max wait for one "
                                      "replica's outstanding requests to "
                                      "finish before the swap aborts")
    swap_timeout_s: float = _f(120.0, "hot-swap: max wait for one replica "
                                      "to load + ack the new checkpoint")

    def __post_init__(self) -> None:
        if self.spec_tokens < 0:
            raise ValueError(f"--spec_tokens must be >= 0, got "
                             f"{self.spec_tokens}")
        for name, (served, item) in DEFERRED.items():
            if getattr(self, name) != served:
                raise ValueError(
                    f"--{name} {getattr(self, name)} is not served by this "
                    f"port yet (only {served!r}); it comes with {item}")


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=ServeSettings.__doc__, allow_abbrev=False,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    for f in dataclasses.fields(ServeSettings):
        kw = {"default": f.default, "help": f.metadata["help"]}
        if f.type in ("bool", bool):
            kw.update(type=_bool, metavar="{true,false}")
        else:
            kw["type"] = {"int": int, "float": float}.get(f.type, str)
        if f.metadata["choices"]:
            kw["choices"] = list(f.metadata["choices"])
        p.add_argument(f"--{f.name}", required=f.name == "checkpoint_path",
                       **kw)
    return p


def parse_settings(argv: Optional[Sequence[str]] = None) -> ServeSettings:
    """argv -> settings; a deferred option exits through ``parser.error``
    (status 2) with the ROADMAP item in the message."""
    parser = create_parser()
    ns = parser.parse_args(argv)
    try:
        return ServeSettings(**vars(ns))
    except ValueError as e:
        parser.error(str(e))
        raise  # parser.error exits; this keeps type checkers informed
