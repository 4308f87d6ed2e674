"""Serving settings: the single-replica fields of the JAX package's
``ServeSettings`` (``distributed_pipeline_tpu/config/serve.py``) as a
dataclass with an argparse bridge.

Every field is a ``--flag`` with the JAX package's name and default. Flags
of options this port does not serve yet are accepted by the parser so that a
JAX command line reads the same, but any value other than the default fails
at parse time with the ROADMAP item that brings it.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["ServeSettings", "DEFERRED", "create_parser", "parse_settings"]

# option -> (the only value served now, the ROADMAP item that brings more)
DEFERRED: Dict[str, Tuple[object, str]] = {
    "prefix_cache": (False, "ROADMAP A.4 (prefix cache)"),
    "serve_quant": ("off", "ROADMAP A.4 (int8 serving weights)"),
    "cost_ledger": (False, "ROADMAP A.4 (cost ledger)"),
    "sanitize": (False, "ROADMAP A.4 (sanitizer, CUDA graphs)"),
    "trace": (False, "ROADMAP A.4 (span tracing)"),
    "replicas": (0, "ROADMAP A.5 (serving fleet)"),
    "disagg": (0, "ROADMAP A.5 (disaggregated prefill/decode)"),
    "traffic": ("steps", "ROADMAP A.5 (wall-clock traffic processes)"),
    "ema": ("", "ROADMAP A.5 (EMA weights, orbax run-dir import)"),
}

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
    arrival_every_steps: int = _f(0, "enqueue one request every N scheduler "
                                     "steps (0 = all queued at start)")
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

    # options of the JAX server that later slices bring (DEFERRED)
    prefix_cache: bool = _f(False, "shared-prefix KV page reuse")
    serve_quant: str = _f("off", "quantize serving weights", ("off", "int8"))
    cost_ledger: bool = _f(False, "per-phase cost ledger")
    sanitize: bool = _f(False, "runtime sanitizer")
    trace: bool = _f(False, "span tracing")
    replicas: int = _f(0, "serve through a fleet of N replicas")
    disagg: int = _f(0, "disaggregated prefill/decode serving")
    traffic: str = _f("steps", "arrival process",
                      ("steps", "poisson", "bursty", "diurnal"))
    ema: str = _f("", "EMA rate to serve; empty = raw params")

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
