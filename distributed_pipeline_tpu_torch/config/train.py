"""Training settings: the fields of the JAX package's ``TrainSettings``
(``distributed_pipeline_tpu/config/train.py``) that this port trains, as a
dataclass with an argparse bridge and a mutually exclusive
``--config_json``. ``--sequence`` is the sequence-parallel group size
(ring attention over L/sequence slices), ``--fsdp`` the parameter-sharding
axis and ``--dp`` the data-parallel axis (-1: ``WORLD_SIZE / (fsdp *
sequence)``; the axes' product must equal ``WORLD_SIZE``, 1 for one
process: ``parallel/mesh.resolve_axis_sizes``). ``--shard_optimizer``
shards the weight-update state over the data axis (ZeRO-1) and
``--partition_rules`` overrides the model's rule table (inline JSON,
``@file`` or a path; a tuner artifact's mesh and ``shard_optimizer`` fold
in through ``run/train.apply_tuned_layout``). Sharding with ``--sequence >
1`` is refused (ROADMAP A.8g). ``--scan_layers`` stacks the layer weights
and ``--pipe S`` makes each S consecutive ranks one pipeline
(``--pp_schedule`` gpipe, 1f1b or interleaved over ``--pp_chunks`` chunks a
microbatch, ``--pp_virtual`` slices a rank under interleaved). The pipe
composes with ``--fsdp`` (ZeRO-3 inside a stage), ``--shard_optimizer``
and ``--sequence`` (a ring inside a stage, on the GPipe stream), and an
MoE model stacks into the JAX ``MoEScanBlocks``; MoE under a pipe
composes with the data axis only (the JAX ``moe_stacked_specs``
refusal). ``--mpmd`` trains the stacked layers as ``--mpmd_stages``
processes, one supervised ring a stage, under a host driver
(``run/train.py``, ``mpmd/``); it needs ``--scan_layers true``, the 1f1b
or gpipe schedule and ``--learning_steps > 0``, and refuses ``--pipe``,
an MoE model (the JAX stages are dense) and a sub-mesh inside a stage
(``--dp``, ``--fsdp``, ``--sequence`` > 1, ``--shard_optimizer``: a JAX
stage is one process on one device, ROADMAP C.19).

Every field is a ``--flag`` with the JAX package's name, default and
choices, so the port trains what the JAX package trains with no flags:
DiffuSeq on the synthetic seq2seq stream. Flags of options this port does
not train yet are accepted so that a JAX command line reads the same, but
any value other than the default fails at parse time with the ROADMAP item
that brings it. ``--device`` is the port's own: empty means CUDA. Parsing
imports no torch: the ``--mpmd`` driver parses its settings torch-free.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional, Sequence, Tuple

from ..chaos.plan import ChaosPlan
from ..parallel.mesh import resolve_axis_sizes
from ..parallel.partition import load_partition_artifact
from ..utils.perf import parse_profile_steps

__all__ = ["TrainSettings", "DEFERRED", "PIPE_NEEDS_SCAN", "MPMD_SUBMESH",
           "MPMD_DENSE", "MPMD_DROPS", "NOISE_SCHEDULES", "pipe_refusal",
           "mpmd_refusal", "create_parser", "parse_settings"]

# the schedules models/diffusion.named_beta_schedule builds (named here:
# parsing imports no torch)
NOISE_SCHEDULES = ("sqrt", "cosine", "linear")

# option -> (the only value trained now, the ROADMAP item that brings more)
DEFERRED: Dict[str, Tuple[object, str]] = {
    "tensor": (1, "ROADMAP A.8g (tensor and expert parallelism)"),
    "expert": (1, "ROADMAP A.8g (tensor and expert parallelism)"),
    "auto_tune": (False, "ROADMAP A.10 (auto-tuner)"),
    "auto_tune_budget_s": (60.0, "ROADMAP A.10 (auto-tuner)"),
}
# the JAX entry point's refusal of a pipe axis over named blocks
PIPE_NEEDS_SCAN = ("--pipe > 1 requires --scan_layers true (stacked layer "
                   "weights are what shard into pipeline stages); without "
                   "it the pipe axis would only replicate work")
# compilation_cache_dir names an XLA cache; PyTorch runs eagerly and
# compiles nothing across runs, so only the JAX default and "off" (both
# meaning "nothing to cache" here) are accepted
COMPILATION_CACHE_DIRS = ("auto", "off")
# what an MPMD stage does not hold: more than one process of its own (a
# JAX stage is one process on one device; ROADMAP C.19)
MPMD_SUBMESH = ("ROADMAP C.19 (an MPMD stage is one process on one device, "
                "as the JAX stages are)")
# the JAX MPMD stages slice the dense stacked blocks only
MPMD_DENSE = ("--mpmd with --moe_experts > 0: the JAX MPMD stages slice the "
              "dense stacked blocks (mpmd/stage_math.py), not MoE groups")
# what the MPMD stages leave out, as the JAX stages do (each runs
# optax.adamw over its slice at a constant rate and snapshots into its
# own dir): under --mpmd these options are refused unless at their
# default
MPMD_DROPS = {
    "ema_rate": "the stages keep no EMA",
    "warmup_steps": "the stages run a constant learning rate",
    "gradient_clipping": "the stages clip no gradient",
    "fused_update": "a stage's AdamW is its slice's plain update",
    "microbatch": "--pp_chunks splits the batch",
    "save_interval": "every stage snapshots each step into its own dir",
    "resume_checkpoint": "a stage resumes from its own snapshots",
}


def pipe_refusal(pipe: int, scan_layers: bool, fsdp: int = 1,
                 sequence: int = 1, moe_experts: int = 0) -> str:
    """Why this composition of the pipe axis and the stacked layers is
    not trained, or "" when it is: the JAX refusals (a pipe over named
    blocks; MoE stages beside any axis but data, the JAX
    ``moe_stacked_specs`` message)."""
    if pipe > 1 and not scan_layers:
        return PIPE_NEEDS_SCAN
    if pipe > 1 and moe_experts > 0:
        for ax, n in (("fsdp", fsdp), ("sequence", sequence)):
            if n > 1:
                return (f"MoE x pipe composes with the data axis only "
                        f"(v1); mesh has {ax}={n}")
    return ""


def mpmd_refusal(s: "TrainSettings") -> str:
    """Why ``--mpmd`` is not trained with these settings, or "" when it is
    (or when ``--mpmd`` is off): the JAX entry point's refusals, then the
    sub-mesh a stage would need."""
    if not s.mpmd:
        return ""
    if not s.scan_layers:
        return ("--mpmd requires --scan_layers true (stages slice the "
                "stacked layer dim)")
    if s.pp_schedule not in ("1f1b", "gpipe"):
        return ("--mpmd runs the host-driven 1f1b or gpipe schedule; "
                "interleaved virtual stages are a single-program schedule "
                "(models/schedule_1f1b.py) — drop --mpmd or switch "
                "schedules")
    if s.learning_steps <= 0:
        return ("--mpmd needs --learning_steps > 0 (the host driver runs a "
                "bounded schedule)")
    if s.pipe > 1:
        return ("--pipe is the in-program pipeline axis; under --mpmd "
                "stages are separate processes — set --mpmd_stages instead")
    if s.mpmd_stages < 2:
        return f"--mpmd_stages {s.mpmd_stages}: an MPMD pipeline needs >= 2"
    if s.moe_experts > 0:
        return MPMD_DENSE
    for bad, what in ((s.dp > 1, "--dp > 1"), (s.fsdp > 1, "--fsdp > 1"),
                      (s.sequence > 1, "--sequence > 1"),
                      (s.shard_optimizer, "--shard_optimizer")):
        if bad:
            return f"--mpmd with {what} is refused: {MPMD_SUBMESH}"
    defaults = {f.name: f.default for f in dataclasses.fields(s)}
    for name, why in MPMD_DROPS.items():
        if getattr(s, name) != defaults[name]:
            return (f"--mpmd ignores --{name} ({why}): leave it at its "
                    f"default, {defaults[name]!r}")
    return ""


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
    """Training of a port model, data-parallel over the ranks."""

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
    keep_checkpoints: int = _f(0, "retain only the newest N checkpoint "
                                  "steps (model, EMA and opt files pruned "
                                  "together); 0 = keep all")
    debug_nans: bool = _f(False, "check every step's metrics, gradients "
                                 "and parameters and raise "
                                 "FloatingPointError at the first "
                                 "non-finite one (one host sync a step; "
                                 "debug runs only)")
    prefetch_depth: int = _f(2, "input prefetch depth: keep N batches in "
                                "pinned host memory, copied to the device "
                                "on a side stream while the current step "
                                "runs; 0 disables (the data order is "
                                "identical either way)")
    compilation_cache_dir: str = _f("auto", "the JAX package's XLA "
                                            "compilation cache; nothing is "
                                            "compiled across runs here, so "
                                            "only 'auto' and 'off' are "
                                            "accepted")
    eval_decode: bool = _f(False, "decode a validation batch at every eval "
                                  "interval and log decode_acc")
    eval_decode_sample_steps: int = _f(32, "reverse-diffusion steps for eval "
                                           "decoding (diffuseq only)")
    # data
    dataset: str = _f("synthetic-seq2seq", "dataset name: synthetic-lm|lm|"
                                           "gpt2 = the causal-LM stream, any "
                                           "other = the seq2seq stream")
    data_dir: str = _f("", "dataset directory (empty = synthetic data)")
    data_loader_workers: int = _f(2, "host-side loader threads")
    # model
    model_family: str = _f("diffuseq", "model family", ("diffuseq", "gpt2"))
    model_size: str = _f("base", "preset size",
                         ("base", "large", "xl", "medium"))
    vocab_size: int = _f(8192, "vocabulary size")
    seq_len: int = _f(128, "sequence length")
    hidden_size: int = _f(0, "override hidden size; 0 = preset")
    num_layers: int = _f(0, "override layer count; 0 = preset")
    num_heads: int = _f(0, "override head count; 0 = preset")
    diffusion_steps: int = _f(2000, "diffusion timesteps (diffuseq only)")
    noise_schedule: str = _f("sqrt", "diffusion noise schedule (diffuseq "
                                     "only)", NOISE_SCHEDULES)
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
    remat: bool = _f(False, "rematerialize (torch.utils.checkpoint) each "
                            "block: recompute it in the backward")
    moe_experts: int = _f(0, "mixture-of-experts: expert count (0 = dense "
                             "MLPs)")
    moe_top_k: int = _f(2, "MoE router top-k")
    moe_every: int = _f(2, "MoE replaces the MLP in every k-th block")
    moe_capacity_factor: float = _f(
        1.25, "MoE expert capacity = ceil(L/E * factor * top_k) slots; "
              "tokens over capacity fall through on the residual path")
    # the training tooling (utils/trainer.py)
    trace: bool = _f(False, "span tracing: restore/compile/step/eval/save "
                            "spans into trace_rank{r}.jsonl in the run dir "
                            "(DPT_TRACE=1 arms it too)")
    cost_ledger: bool = _f(False, "the train_step cost-ledger row (roofline "
                                  "MFU-gap terms) each log window, and "
                                  "perf_ledger.json in the run dir")
    sanitize: bool = _f(False, "run each step's dispatch and the eval "
                               "callbacks under "
                               "torch.cuda.set_sync_debug_mode('error'); a "
                               "host sync there raises and lands in "
                               "sanitize_report.json")
    chaos_plan: str = _f("", "fault-injection schedule: inline JSON, "
                             "@/path/to/plan.json or a bare path (kill, "
                             "crash_in_save, stall_data, stall_step, "
                             "slow_rank, corrupt_checkpoint); the "
                             "DPT_CHAOS_PLAN env var overrides; empty "
                             "disables")
    profile_dir: str = _f("", "capture a torch.profiler trace (CPU and CUDA "
                              "activity) of a few steps into this directory "
                              "(TensorBoard/Chrome format)")
    profile_steps: str = _f("", "profiler window 'A:B' of loop steps from "
                                "loop entry (with --profile_dir; empty = "
                                "3:8)")

    # stacked layers and the pipeline schedule
    scan_layers: bool = _f(False, "stacked layer weights (one module whose "
                                  "weights carry a leading [num_layers] "
                                  "dim; what --pipe cuts into stages)")
    pp_chunks: int = _f(4, "pipeline chunks a microbatch (bubble "
                           "(S-1)/(chunks+S-1) under gpipe)")
    pp_schedule: str = _f(
        "1f1b", "pipeline schedule: 1f1b streams each chunk's backward as "
                "soon as its forward clears the last stage (a stash of at "
                "most 2S-1 chunk inputs, the stage forward recomputed in "
                "the backward); interleaved splits each rank into "
                "pp_virtual slices (V*min(chunks, 3S) stashed inputs); "
                "gpipe runs the forward stream, then autograd back "
                "through it (residuals grow with pp_chunks)",
        ("1f1b", "gpipe", "interleaved"))
    pp_virtual: int = _f(2, "virtual stage slices a rank under "
                            "--pp_schedule interleaved (num_layers must "
                            "divide by pipe * pp_virtual, pp_chunks by "
                            "pipe)")
    dp: int = _f(-1, "data-parallel axis size: -1 = WORLD_SIZE / "
                     "(fsdp * sequence), else dp * fsdp * sequence must "
                     "equal WORLD_SIZE (1 for one process)")
    fsdp: int = _f(1, "FSDP axis size: the parameters the rule table cuts "
                      "over fsdp, and their optimizer state, live 1/fsdp a "
                      "rank, gathered a block at a time")
    tensor: int = _f(1, "tensor-parallel axis size")
    sequence: int = _f(1, "sequence-parallel axis size: each group of "
                          "this many ranks splits L and rings its "
                          "attention")
    expert: int = _f(1, "expert-parallel axis size")
    pipe: int = _f(1, "pipeline-parallel axis size: each group of this "
                      "many consecutive ranks runs the stages of the "
                      "stacked layers (requires --scan_layers true)")
    shard_optimizer: bool = _f(False, "ZeRO-1: mu, nu and the EMA copies "
                                      "sharded over the data axis (one "
                                      "reduce-scatter and one all-gather "
                                      "a step)")
    partition_rules: str = _f("", "parameter partition-rule override: "
                                  "inline JSON, @/path.json or a path (a "
                                  "rule list or a tuner artifact)")
    auto_tune: bool = _f(False, "inline sharding auto-tuner")
    mpmd: bool = _f(
        False, "MPMD pipeline training (mpmd/): each stage runs as its OWN "
               "supervised process ring with its own restart budget and "
               "snapshots (stages are independently preemptible), a "
               "torch-free host driver broadcasts the --pp_schedule "
               "microbatch schedule, and activations/grads move over the "
               "StageLink transport instead of a collective; requires "
               "--scan_layers true; a stage runs AdamW over its slice at "
               "a constant --lr with no EMA, clipping or warmup; a "
               "stage is one process (dp/fsdp/sequence > 1 and "
               "shard_optimizer are refused, ROADMAP C.19) over dense "
               "blocks (no MoE)")
    auto_tune_budget_s: float = _f(60.0, "inline auto-tuner budget")
    scan_unroll: int = _f(0, "the JAX layer scan's unroll factor (<= 0 = "
                             "auto, else the factor), read as the JAX flag; "
                             "perf-only there, and the eager layer loop "
                             "runs the same for every value")
    mpmd_stages: int = _f(2, "MPMD stage count (process rings); "
                             "num_layers need not divide it — stages take "
                             "floor-balanced layer slices")
    mpmd_link_capacity: int = _f(8, "StageLink in-flight frame cap per "
                                    "direction (backpressure: a sender "
                                    "blocks past this and books the wait "
                                    "as link_wait)")
    mpmd_hang_timeout_s: float = _f(0.0, "per-stage beacon watchdog: a "
                                         "stage whose beacons freeze this "
                                         "long is SIGKILLed and restarted "
                                         "by ITS OWN ring (0 = off)")
    mpmd_max_restarts: int = _f(3, "per-stage restart budget (sliding "
                                   "window, launcher semantics)")

    def __post_init__(self) -> None:
        for name, (served, item) in DEFERRED.items():
            if getattr(self, name) != served:
                raise ValueError(
                    f"--{name} {getattr(self, name)} is not trained by this "
                    f"port yet (only {served!r}); it comes with {item}")
        if self.chaos_plan:
            ChaosPlan.parse(self.chaos_plan)
        parse_profile_steps(self.profile_steps)
        if self.compilation_cache_dir not in COMPILATION_CACHE_DIRS:
            raise ValueError(
                f"--compilation_cache_dir {self.compilation_cache_dir!r}: "
                f"the port runs PyTorch eagerly and has no XLA compilation "
                f"cache to keep; only {COMPILATION_CACHE_DIRS} are accepted")
        if self.keep_checkpoints < 0:
            raise ValueError(f"--keep_checkpoints must be >= 0, got "
                             f"{self.keep_checkpoints}")
        if self.prefetch_depth < 0:
            raise ValueError(f"--prefetch_depth must be >= 0, got "
                             f"{self.prefetch_depth}")
        if self.moe_experts > 0 and self.moe_every < 1:
            raise ValueError(f"moe_every must be >= 1, got "
                             f"{self.moe_every}")
        if self.sequence > 1 and self.attention_impl not in ("auto", "ring"):
            raise ValueError(f"--attention_impl {self.attention_impl} with "
                             f"--sequence > 1: each rank holds an "
                             f"L/sequence slice, and only the ring ('auto' "
                             f"or 'ring') attends across the slices")
        refused = mpmd_refusal(self)   # before the mesh's and pipe's checks
        if refused:
            raise ValueError(refused)
        if self.pipe > 1 and not self.scan_layers:
            raise ValueError(PIPE_NEEDS_SCAN)   # before the mesh's check
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if self.sequence < 1 or world % self.sequence:
            raise ValueError(f"--sequence {self.sequence} must divide the "
                             f"world size ({world})")
        try:
            resolve_axis_sizes(self.dp, self.fsdp, self.sequence,
                               self.tensor, self.expert, self.pipe,
                               n_devices=world)
        except ValueError as e:
            raise ValueError(f"--dp {self.dp} --fsdp {self.fsdp} --sequence "
                             f"{self.sequence} --pipe {self.pipe}: {e}; the "
                             f"mesh's axes must multiply to the world "
                             f"size") from None
        if self.sequence > 1 and (self.fsdp > 1 or self.shard_optimizer):
            raise ValueError(
                "--fsdp > 1 or --shard_optimizer with --sequence > 1 comes "
                "with ROADMAP A.8g (the gradient's sums over the sequence "
                "ranks and the data shards together)")
        if self.partition_rules:
            try:
                load_partition_artifact(self.partition_rules)
            except OSError as e:
                raise ValueError(f"--partition_rules {self.partition_rules!r}"
                                 f": {e}") from None
        if self.pp_chunks < 1 or self.pp_virtual < 1:
            raise ValueError(f"--pp_chunks and --pp_virtual must be >= 1, "
                             f"got {self.pp_chunks} and {self.pp_virtual}")
        refused = pipe_refusal(self.pipe, self.scan_layers, self.fsdp,
                               self.sequence, self.moe_experts)
        if refused:
            raise ValueError(refused)
        if self.seq_len % self.sequence:
            raise ValueError(f"--seq_len {self.seq_len} not divisible by "
                             f"--sequence {self.sequence}")

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
