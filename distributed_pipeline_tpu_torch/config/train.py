"""Training settings: the single-GPU fields of the JAX package's
``TrainSettings`` (``distributed_pipeline_tpu/config/train.py``) as a
dataclass with an argparse bridge and a mutually exclusive
``--config_json``.

Every field is a ``--flag`` with the JAX package's name and default (except
``model_family``, whose only value here is ``gpt2``, and ``dataset``,
``synthetic-lm``). Flags of options this port does not train yet are
accepted so that a JAX command line reads the same, but any value other than
the default fails at parse time with the ROADMAP item that brings it.
``--device`` is the port's own: empty means CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional, Sequence, Tuple

from ..data import DATASETS

__all__ = ["TrainSettings", "DEFERRED", "create_parser", "parse_settings"]

# option -> (the only value trained now, the ROADMAP item that brings more)
DEFERRED: Dict[str, Tuple[object, str]] = {
    "remat": (False, "ROADMAP A.8 (activation rematerialization)"),
    "moe_experts": (0, "ROADMAP A.8 (mixture of experts)"),
    "scan_layers": (False, "ROADMAP A.9 (stacked layers, pipeline)"),
    "pp_chunks": (4, "ROADMAP A.9 (pipeline parallelism)"),
    "pp_schedule": ("1f1b", "ROADMAP A.9 (pipeline parallelism)"),
    "pp_virtual": (2, "ROADMAP A.9 (pipeline parallelism)"),
    "fsdp": (1, "ROADMAP A.8 (multi-GPU meshes)"),
    "tensor": (1, "ROADMAP A.8 (multi-GPU meshes)"),
    "sequence": (1, "ROADMAP A.8 (multi-GPU meshes, ring attention)"),
    "expert": (1, "ROADMAP A.8 (multi-GPU meshes)"),
    "pipe": (1, "ROADMAP A.9 (pipeline parallelism)"),
    "shard_optimizer": (False, "ROADMAP A.8 (ZeRO-1)"),
    "partition_rules": ("", "ROADMAP A.8 (partition rules)"),
    "auto_tune": (False, "ROADMAP A.10 (auto-tuner)"),
    "trace": (False, "ROADMAP A.10 (span tracing)"),
    "cost_ledger": (False, "ROADMAP A.10 (cost ledger)"),
    "sanitize": (False, "ROADMAP A.10 (sanitizer)"),
    "chaos_plan": ("", "ROADMAP A.10 (chaos harness)"),
    "profile_dir": ("", "ROADMAP A.10 (profiler window)"),
    "eval_decode": (False, "ROADMAP A.7 (decoders)"),
    "mpmd": (False, "ROADMAP A.9 (MPMD pipeline)"),
    "data_dir": ("", "ROADMAP A.7 (jsonl corpora)"),
}
_FAMILIES = {"diffuseq": "ROADMAP A.7 (DiffuSeq training)"}

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
class TrainSettings:
    """Single-GPU training of a port model."""

    # loop and optimizer (the JAX GeneralSettings)
    lr: float = _f(1e-4, "learning rate")
    batch_size: int = _f(2048, "batch size per optimizer step")
    microbatch: int = _f(64, "microbatch size; -1 = batch_size")
    learning_steps: int = _f(320000, "total optimizer steps")
    log_interval: int = _f(50, "steps between metric dumps")
    save_interval: int = _f(10000, "steps between checkpoints")
    eval_interval: int = _f(1000, "steps between eval passes")
    ema_rate: str = _f("0.5,0.9,0.99", "comma-separated EMA decay rates")
    seed: int = _f(102, "global RNG seed")
    resume_checkpoint: str = _f("", "explicit model_NNNNNN.pt to resume "
                                    "from (empty = newest in the run dir)")
    checkpoint_path: str = _f("", "run/checkpoint directory "
                                  "(auto-generated if empty)")
    gradient_clipping: float = _f(-1.0, "global-norm gradient clip; <=0 "
                                        "disables")
    weight_decay: float = _f(0.0, "AdamW decoupled weight decay")
    warmup_steps: int = _f(0, "linear LR warmup steps before the anneal")
    dispatch_lag: int = _f(1, "fetch/log step N-k's device scalars while "
                              "step N runs; 0 = eager")
    # data
    dataset: str = _f("synthetic-lm", "dataset name", DATASETS)
    data_dir: str = _f("", "dataset directory (empty = synthetic data)")
    data_loader_workers: int = _f(2, "host-side loader threads")
    # model
    model_family: str = _f("gpt2", "model family", ("gpt2", "diffuseq"))
    model_size: str = _f("base", "preset size",
                         ("base", "large", "xl", "medium"))
    vocab_size: int = _f(8192, "vocabulary size")
    seq_len: int = _f(128, "sequence length")
    hidden_size: int = _f(0, "override hidden size; 0 = preset")
    num_layers: int = _f(0, "override layer count; 0 = preset")
    num_heads: int = _f(0, "override head count; 0 = preset")
    dtype: str = _f("bfloat16", "activation/compute dtype",
                    ("bfloat16", "float32"))
    attention_impl: str = _f(
        "auto", "attention: 'xla' = dense, 'cuda' (or 'pallas') = the flash "
                "kernels, 'torch' = their plain version, 'auto' = flash for "
                "CUDA tensors from L >= 1024, dense otherwise",
        ("auto", "xla", "cuda", "pallas", "torch", "ring"))
    fused_update: str = _f(
        "auto", "optimizer+EMA update: 'true' = the fused CUDA kernel, "
                "'false' = its plain version (separate torch ops), 'auto' = "
                "the kernel for CUDA tensors", ("auto", "true", "false"))
    device: str = _f("", "torch device; empty = cuda (the run fails "
                         "without CUDA unless 'cpu' is asked for)")

    # options of the JAX trainer that later slices bring (DEFERRED)
    remat: bool = _f(False, "rematerialize each block")
    moe_experts: int = _f(0, "mixture-of-experts expert count")
    scan_layers: bool = _f(False, "stacked layer weights")
    pp_chunks: int = _f(4, "pipeline microchunks")
    pp_schedule: str = _f("1f1b", "pipeline schedule",
                          ("1f1b", "gpipe", "interleaved"))
    pp_virtual: int = _f(2, "virtual pipeline stages per device")
    dp: int = _f(-1, "data-parallel axis size (-1 or 1: one GPU)")
    fsdp: int = _f(1, "FSDP axis size")
    tensor: int = _f(1, "tensor-parallel axis size")
    sequence: int = _f(1, "sequence-parallel axis size")
    expert: int = _f(1, "expert-parallel axis size")
    pipe: int = _f(1, "pipeline-parallel axis size")
    shard_optimizer: bool = _f(False, "ZeRO-1 optimizer-state sharding")
    partition_rules: str = _f("", "parameter partition-rule override")
    auto_tune: bool = _f(False, "inline sharding auto-tuner")
    trace: bool = _f(False, "span tracing")
    cost_ledger: bool = _f(False, "per-program cost ledger")
    sanitize: bool = _f(False, "runtime sanitizer")
    chaos_plan: str = _f("", "fault-injection schedule")
    profile_dir: str = _f("", "profiler trace directory")
    eval_decode: bool = _f(False, "decode a validation batch at each eval")
    mpmd: bool = _f(False, "MPMD pipeline training")

    def __post_init__(self) -> None:
        if self.model_family in _FAMILIES:
            raise ValueError(f"--model_family {self.model_family} is not "
                             f"trained by this port yet; it comes with "
                             f"{_FAMILIES[self.model_family]}")
        for name, (served, item) in DEFERRED.items():
            if getattr(self, name) != served:
                raise ValueError(
                    f"--{name} {getattr(self, name)} is not trained by this "
                    f"port yet (only {served!r}); it comes with {item}")
        if self.dp not in (-1, 1):
            raise ValueError(f"--dp {self.dp}: this port trains on one GPU "
                             f"(dp -1 or 1); multi-GPU is ROADMAP A.8")
        if self.attention_impl == "ring":
            raise ValueError("--attention_impl ring is not trained by this "
                             "port yet; it comes with ROADMAP A.8 (ring "
                             "attention)")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_TYPES = {"int": int, "float": float, "str": str}


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=TrainSettings.__doc__, allow_abbrev=False,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    for f in dataclasses.fields(TrainSettings):
        kw = {"default": f.default, "help": f.metadata["help"]}
        if f.type in ("bool", bool):
            kw.update(type=_bool, metavar="{true,false}")
        else:
            kw["type"] = _TYPES.get(f.type, str)
        if f.metadata["choices"]:
            kw["choices"] = list(f.metadata["choices"])
        p.add_argument(f"--{f.name}", **kw)
    p.add_argument("--config_json", default=None,
                   help="JSON settings file; mutually exclusive with every "
                        "flag but --device")
    return p


def parse_settings(argv: Optional[Sequence[str]] = None) -> TrainSettings:
    """argv -> settings. ``--config_json`` takes the whole configuration
    from the file (its ``device`` key yields to ``--device``); any other
    flag beside it, or a deferred option, exits through ``parser.error``
    (status 2) with the reason."""
    import sys
    parser = create_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    ns = vars(parser.parse_args(argv))
    config_json = ns.pop("config_json")
    try:
        if config_json:
            given = sorted({tok.split("=")[0][2:] for tok in argv
                            if tok.startswith("--")}
                           - {"config_json", "device"})
            if given:
                parser.error("--config_json is mutually exclusive with "
                             "individual flags (got: "
                             + ", ".join("--" + k for k in given) + ")")
            with open(config_json) as f:
                values = json.load(f)
            if not isinstance(values, dict):
                parser.error(f"{config_json}: expected a JSON object")
            if ns["device"]:
                values["device"] = ns["device"]
            return TrainSettings(**values)
        return TrainSettings(**ns)
    except (TypeError, ValueError) as e:
        parser.error(str(e))
        raise  # parser.error exits; this keeps type checkers informed
