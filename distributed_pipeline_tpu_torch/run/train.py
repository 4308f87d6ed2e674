"""Training entry point: the port of
``distributed_pipeline_tpu/run/train.py``.

    python -m distributed_pipeline_tpu_torch.run.train --config_json cfg.json
    python -m distributed_pipeline_tpu_torch.run.train --batch_size 256 \\
        --microbatch 64 ... [--device cpu]          # DiffuSeq (the default)
    python -m distributed_pipeline_tpu_torch.run.train --model_family gpt2 \\
        --dataset synthetic-lm --seq_len 1024 --batch_size 8 ...
    python -m distributed_pipeline_tpu_torch.run.train --distributed \\
        --nprocs 2 [--max_restarts 1] ...          # data-parallel ranks
    python -m distributed_pipeline_tpu_torch.run.train --distributed \\
        --nprocs 2 --sequence 2 ...                # one ring over L
    python -m distributed_pipeline_tpu_torch.run.train --distributed \\
        --nprocs 2 --shard_optimizer true ...      # ZeRO-1 (or --fsdp 2)
    python -m distributed_pipeline_tpu_torch.run.train --distributed \\
        --nprocs 2 --scan_layers true --pipe 2 ... # two pipeline stages
    python -m distributed_pipeline_tpu_torch.run.train --mpmd true \\
        --mpmd_stages 2 --scan_layers true ...     # MPMD stage processes

``--distributed --nprocs N`` relaunches this module as N supervised worker
processes (``parallel/launcher.py``) that form one ``torch.distributed``
group (``parallel/dist.py``: NCCL when every rank has a card of its own,
gloo on the CPU or when ranks share one); ``batch_size`` and
``microbatch`` are per rank. ``--sequence N`` makes each N consecutive
ranks one sequence group that reads the same rows, splits L N ways and
rings its attention (``parallel/ring.py``); the loader shards over the
``world / N`` data groups. ``--dp``, ``--fsdp`` and ``--sequence`` lay
the ranks out as the JAX mesh (``parallel/mesh.py``; the data and fsdp
ranks read distinct rows); ``--shard_optimizer`` and ``--fsdp`` shard the
training state (``utils/trainer.py``) by the model's rule table or
``--partition_rules``, whose tuner artifact folds its mesh and ZeRO-1 into
the settings first (``apply_tuned_layout``). ``--pipe S`` (with
``--scan_layers true``) makes each S consecutive ranks one pipeline that
reads the same rows, each rank a stage (``--pp_schedule``,
``--pp_chunks``, ``--pp_virtual``; ``utils/trainer.py``). Settings ->
process group ->
run dir (made by rank 0; every rank resolves the same one, the launcher
pinning ``DPT_RUN_TIMESTAMP``) -> logger (means across ranks at each
dump; rank 0 alone on stdout, rank r > 0 into ``-rank{r:03d}`` files) ->
``training_args.json`` -> model -> ``TrainLoop`` (which resumes from the
run dir's newest complete checkpoint) -> each rank's data shard
fast-forwarded past the global samples the checkpoint consumed ->
``run_loop`` -> ``train_summary.json`` (``train_summary-rank{r:03d}.json``
for rank r > 0): the rank's backend, device, kernel launches and plain
calls, all-reduce, reduce-scatter, all-gather and ring-shift seconds,
its (data index, sequence index, sequence size), the mesh, the layout
and the footprint, its pipe stage (index, schedule, chunks, V, layers
held, the 1F1B stash's peak, ``pipe_p2p_s_per_step`` and the exchange's
calls and bytes), throughput, peak device memory, the beacon's
seconds a step, the stall gauges' means, each save's copy and wait
seconds, the metrics of its newest 1000 steps and the SHA-256 of its
final flat parameters (equal on every rank of a healthy ring).

The training tooling rides the same path, as in the JAX entry point: a
chaos plan from ``DPT_CHAOS_PLAN`` or ``--chaos_plan`` (every rank's
injector anchored in the run dir), ``recompute_until_step`` from the run
dir's beacons (``beacon_max_step``), and ``--trace`` (else
``DPT_TRACE``), ``--cost_ledger``, ``--sanitize``, ``--profile_dir`` and
``--profile_steps`` into ``TrainLoop``.
``--eval_decode true`` adds the decode callback over one
held-out batch of at most 32 rows, as the JAX entry point does: DiffuSeq
samples ``--eval_decode_sample_steps`` reverse steps, GPT-2 continues the
second half of each row greedily (dense KV cache). Runs on
CUDA unless ``--device cpu`` is given, and raises when CUDA is missing.

``--mpmd true`` trains the stacked layers as ``--mpmd_stages`` processes
(``_mpmd_main``): this process is the torch-free host driver
(``mpmd/driver.py``), each stage one supervised ring of one process
(``mpmd/stage_worker.py``) on the run's device (on one card every stage
shares ``cuda:0``), activations and gradients moving stage to stage over
``FileStageLink``s under the run dir.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import (TYPE_CHECKING, Any, Callable, Dict, Optional, Sequence,
                    Tuple)

# the modules this file imports at its top import no torch: the launcher
# parent of ``--distributed --nprocs N`` only spawns and supervises the
# workers, and importing torch would hold every launch up by seconds. The
# torch-side modules are imported where training starts (``train``).
from ..chaos import CHAOS_PLAN_ENV, ChaosInjector, ChaosPlan
from ..chaos.goodput import beacon_max_step
from ..data import load_data_from_args, skip_batches_for_samples
from ..parallel.launcher import (RUN_TIMESTAMP_ENV, parse_and_autorun,
                                 parse_distributed_args)
from ..parallel.mesh import AXES, local_mesh_info
from ..parallel.partition import load_partition_artifact
from ..utils.logger import Logger, distributed_mean_comm

if TYPE_CHECKING:
    import torch

    from ..config.train import TrainSettings
    from ..utils.trainer import TrainLoop

__all__ = ["main", "train", "resolve_run_dir", "resume_sample_position",
           "eval_decode_callback", "mesh_flags_default", "apply_tuned_layout"]

# the steps of history a sidecar keeps
SIDECAR_HISTORY = 1000


def resolve_run_dir(args: TrainSettings) -> str:
    """``model_checkpoints/Run_{dataset}_lr{lr}_seed{seed}_{ts}`` unless
    ``checkpoint_path`` names one, as the JAX package resolves it; ``ts``
    is ``DPT_RUN_TIMESTAMP`` when set (the launcher pins it for every rank
    and every restart), else now."""
    if args.checkpoint_path:
        return args.checkpoint_path
    ts = (os.environ.get(RUN_TIMESTAMP_ENV)
          or time.strftime("%Y%m%d-%H%M%S"))
    return os.path.join("model_checkpoints",
                        f"Run_{args.dataset}_lr{args.lr}_seed{args.seed}_{ts}")


def mesh_flags_default(args) -> bool:
    """Whether the user left every mesh-axis flag at its default: the gate
    for applying a tuner artifact's mesh recommendation. An explicit
    ``--dp``/``--fsdp``/... is an instruction; the recommendation then
    only logs."""
    return (args.dp == -1 and args.fsdp == 1 and args.sequence == 1
            and args.tensor == 1 and args.expert == 1 and args.pipe == 1)


def apply_tuned_layout(args, artifact, n_devices: int, n_hosts: int = 1,
                       log: Callable[[str], None] = print):
    """Fold a tuner artifact (``load_partition_artifact``) into the
    settings, as the JAX entry point does: the mesh recommendation applies
    only when the mesh flags are at their defaults AND it fits the run (its
    product is the rank count, and the global microbatch divides over
    data x fsdp x expert); ZeRO-1 follows the default gate alone. A
    recommendation of tensor or expert > 1 is logged and not applied
    (ROADMAP A.8g); its pipe applies as the JAX entry point applies it,
    to a run with ``--scan_layers true`` (else it is logged). Returns the (possibly replaced) settings; the rules themselves go to
    the ``TrainLoop``."""
    if artifact is None:
        return args
    mesh_rec = artifact.get("mesh")
    updates = {}
    if mesh_rec:
        sizes = {a: int(mesh_rec.get(a, 1)) for a in AXES}
        product = 1
        for v in sizes.values():
            product *= v
        micro = args.microbatch if args.microbatch > 0 else args.batch_size
        dpf = sizes["data"] * sizes["fsdp"] * sizes["expert"]
        if not mesh_flags_default(args):
            log(f"tuned mesh recommendation {mesh_rec} NOT applied "
                f"(mesh flags set explicitly)")
        elif product != n_devices:
            log(f"tuned mesh recommendation {mesh_rec} NOT applied "
                f"(product {product} != {n_devices} devices — "
                f"artifact tuned for another device set)")
        elif (micro * max(n_hosts, 1)) % dpf:
            log(f"tuned mesh recommendation {mesh_rec} NOT applied "
                f"(global microbatch {micro * max(n_hosts, 1)} not "
                f"divisible by data x fsdp x expert = {dpf} — "
                f"artifact tuned at a different batch shape)")
        elif max(sizes["tensor"], sizes["expert"]) > 1:
            log(f"tuned mesh recommendation {mesh_rec} NOT applied "
                f"(tensor/expert parallelism comes with ROADMAP A.8g)")
        elif sizes["pipe"] > 1 and not args.scan_layers:
            log(f"tuned mesh recommendation {mesh_rec} NOT applied "
                f"(--pipe > 1 requires --scan_layers true)")
        else:
            updates.update(dp=sizes["data"], fsdp=sizes["fsdp"],
                           sequence=sizes["sequence"], pipe=sizes["pipe"])
            log(f"applying tuned mesh recommendation: {mesh_rec}")
    zero = artifact.get("shard_optimizer")
    if zero is not None and not args.shard_optimizer and zero:
        updates["shard_optimizer"] = True
        log("applying tuned ZeRO-1 recommendation (--shard_optimizer true)")
    return dataclasses.replace(args, **updates) if updates else args


def resume_sample_position(resume_step: int, meta: Optional[Dict[str, Any]],
                           batch_size: int, process_count: int
                           ) -> Tuple[int, int]:
    """``(skip_batches, consumed_samples)`` for the train stream's
    fast-forward, as the JAX entry point computes them: the position that
    survives a change of world size is the global samples consumed (the
    checkpoint's meta records the global batch). On the same global batch
    the skip is ``resume_step`` exactly; a checkpoint without
    ``global_batch`` counts as the same topology."""
    gb_now = batch_size * max(process_count, 1)
    saved_gb = (int(meta["global_batch"])
                if meta and meta.get("global_batch") else gb_now)
    consumed = (int(meta["samples"])
                if meta and meta.get("samples") is not None
                else resume_step * saved_gb)
    if saved_gb == gb_now:
        return resume_step, consumed
    return skip_batches_for_samples(resume_step * saved_gb, batch_size,
                                    process_count), consumed


def _write_summary(loop: TrainLoop, run_dir: str, device: torch.device
                   ) -> None:
    """This rank's sidecar (see the module doc), written at a clean
    exit."""
    import torch

    from ..ops import flash_attention, fused_update
    from ..parallel import dist
    loop.flush_metrics()
    ctx = loop.pipe_ctx
    out = {"rank": loop.rank, "world_size": loop.world,
           "backend": dist.backend(), "device": str(device),
           "devices_in_ring": loop.n_devices, "steps": loop.step,
           "global_batch": loop.global_batch,
           "data_index": loop.seq.data_index,
           "sequence_index": loop.seq.index, "sequence": loop.seq.size,
           "launches": {
               "flash_forward": flash_attention.forward_launch_count(),
               "flash_backward": flash_attention.backward_launch_count(),
               "fused_adamw_ema": fused_update.launch_count()},
           "lse_backward_launches":
               flash_attention.lse_backward_launch_count(),
           "plain_calls": {**{f"flash_{k}": v for k, v in
                              flash_attention.plain_call_counts().items()},
                           "fused_adamw_ema":
                               fused_update.plain_call_count()},
           "allreduce_calls": loop.allreduce_time.calls,
           "allreduce_s": loop.allreduce_time.seconds,
           "allreduce_s_per_step": loop.allreduce_s_per_step,
           "reduce_scatter_calls": loop.reduce_scatter_time.calls,
           "reduce_scatter_s_per_step": loop.reduce_scatter_s_per_step,
           "all_gather_calls": loop.all_gather_time.calls,
           "all_gather_s_per_step": loop.all_gather_s_per_step,
           "mesh": loop.mesh.shape, "shard_optimizer": loop.shard_optimizer,
           "layout": loop.shard.describe(),
           "fsdp_largest_unit_bytes": (loop.fsdp.largest_unit_bytes
                                       if loop.fsdp is not None else 0),
           "n_params": loop.n_params,
           "n_active_params": loop.n_active_params,
           "update_share": str(loop.update_share()),
           "fsdp_gathers": loop.fsdp.gathers if loop.fsdp else 0,
           "fsdp_gathered_bytes": (loop.fsdp.gathered_bytes
                                   if loop.fsdp else 0),
           "footprint": loop.footprint(),
           "ring_shift_calls": loop.shift_time.calls,
           "ring_shift_s_per_step": loop.ring_shift_s_per_step,
           "pipe": {"index": loop.pipe.index, "size": loop.pipe.size,
                    "schedule": ctx.schedule if ctx else "",
                    "chunks": ctx.chunks if ctx else 0,
                    "virtual": ctx.virtual if ctx else 0,
                    "layers": list(loop.shard.stage_layers),
                    "stash_peak": ctx.stash_peak if ctx else 0,
                    "f_slots": ctx.f_slots if ctx else 0,
                    "b_slots": ctx.b_slots if ctx else 0},
           "pipe_p2p_calls": loop.pipe_time.calls,
           "pipe_p2p_s_per_step": loop.pipe_p2p_s_per_step,
           "pipe_bytes": dist.pipe_bytes(),
           **loop.throughput,
           "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0),
           "beacon_s_per_step": loop.beacon_s / max(
               loop.step - loop.start_step, 1),
           "stall_means": loop.stalls.totals(),
           # each save's copy and wait seconds, and the metrics of the
           # newest steps this attempt ran (the rows a log interval dumps
           # trail them by dispatch_lag)
           "saves": loop.save_times,
           # each eval decode's value and its rows' digest
           "eval_decodes": loop.eval_decodes,
           "history": loop.history[-SIDECAR_HISTORY:],
           # the full parameters (gathered by every rank when sharded)
           "params_sha256": hashlib.sha256(
               loop.full_flat("params").cpu().numpy().tobytes()).hexdigest()}
    suffix = f"-rank{loop.rank:03d}" if loop.rank > 0 else ""
    path = os.path.join(run_dir, f"train_summary{suffix}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f, indent=1)
    os.replace(path + ".tmp", path)


def eval_decode_callback(args: TrainSettings) -> Callable[[TrainLoop], None]:
    """``--eval_decode``'s callback: one held-out batch of at most 32 rows
    (every rank, and every run with the same data flags, decodes the same
    one), decoded as ``make_decode_callback`` does."""
    from ..models.sampling import make_decode_callback
    settings = {k: v for k, v in args.to_dict().items() if k != "device"}
    decode_data = load_data_from_args(
        "valid", **{**settings, "deterministic": True,
                    "batch_size": min(args.batch_size, 32),
                    "num_loader_proc": 0, "data_loader_workers": 0,
                    "host_sharded": False})
    return make_decode_callback(decode_data,
                                sample_steps=args.eval_decode_sample_steps)


def train(args: TrainSettings, stdout: bool = True) -> TrainLoop:
    """Train with ``args`` to ``learning_steps``; returns the loop. Joins
    the process group the environment describes first (one process when
    there is none)."""
    from ..models import create_model_from_config
    from ..parallel import dist
    from ..utils.device import resolve_device
    from ..utils.trainer import TrainLoop
    device = resolve_device(args.device)
    dist.setup_dist(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    run_dir = resolve_run_dir(args)
    if rank == 0:
        os.makedirs(run_dir, exist_ok=True)
    dist.barrier("mkdir")
    logger = Logger(run_dir, stdout=stdout and rank == 0,
                    comm=distributed_mean_comm(), rank=rank)
    rules = None
    if args.partition_rules:
        # a tuner artifact's mesh and ZeRO-1 fold into the settings; every
        # rank is a host of its own rows
        artifact = load_partition_artifact(args.partition_rules)
        args = apply_tuned_layout(args, artifact, n_devices=world,
                                  n_hosts=world, log=logger.info)
        rules = artifact["rules"]
    settings = args.to_dict()
    settings.pop("device")  # where a run trained is not part of its config
    if rank == 0:
        with open(os.path.join(run_dir, "training_args.json"), "w") as f:
            json.dump(settings, f, indent=2)
        handshake = os.environ.get("DPT_RUN_DIR_FILE")
        if handshake:
            # the launcher appends its attempt records to this run dir
            with open(handshake, "w") as f:
                f.write(os.path.abspath(run_dir))
    chaos = None
    chaos_src = os.environ.get(CHAOS_PLAN_ENV) or args.chaos_plan
    if chaos_src:
        chaos = ChaosInjector(ChaosPlan.parse(chaos_src), rank=rank,
                              run_dir=run_dir)
        logger.info(f"chaos plan armed: {chaos.plan.describe()}")
    model = create_model_from_config(**settings, device=device)
    eval_callbacks = [eval_decode_callback(args)] if args.eval_decode else []
    loop = TrainLoop(
        model=model, data=None, batch_size=args.batch_size,
        microbatch=args.microbatch, lr=args.lr, ema_rate=args.ema_rate,
        log_interval=args.log_interval, eval_interval=args.eval_interval,
        save_interval=args.save_interval,
        resume_checkpoint=args.resume_checkpoint,
        gradient_clipping=args.gradient_clipping,
        weight_decay=args.weight_decay, learning_steps=args.learning_steps,
        warmup_steps=args.warmup_steps, checkpoint_dir=run_dir,
        seed=args.seed, dispatch_lag=args.dispatch_lag,
        fused_update=args.fused_update, eval_callbacks=eval_callbacks,
        keep_checkpoints=args.keep_checkpoints, debug_nans=args.debug_nans,
        prefetch_depth=args.prefetch_depth, sequence=args.sequence,
        dp=args.dp, fsdp=args.fsdp, shard_optimizer=args.shard_optimizer,
        partition_rules=rules, pipe=args.pipe, chaos=chaos,
        # steps an earlier attempt reached (its beacons) book as recompute
        recompute_until_step=beacon_max_step(run_dir),
        # None defers to DPT_TRACE, which the launcher passes to every rank
        trace=True if args.trace else None, cost_ledger=args.cost_ledger,
        sanitize=args.sanitize, profile_dir=args.profile_dir,
        profile_steps=args.profile_steps, logger=logger)
    # exact-order resume: skip the global samples the restored step
    # consumed (by this data group's shard)
    meta = loop.resume_meta or {}
    shard = loop.mesh.rows()
    train_skip, consumed = resume_sample_position(
        loop.step, meta, args.batch_size, shard[1])
    eval_skip = int(meta.get("eval_batches_consumed", 0))
    if loop.step:
        logger.info(f"resume at step {loop.step}: {consumed} global samples "
                    f"consumed; each rank skips {train_skip} batches of "
                    f"{args.batch_size}")
    data_args = {k: v for k, v in settings.items() if k != "batch_size"}
    loop.set_data(
        load_data_from_args("train", batch_size=args.batch_size,
                            skip_batches=train_skip, shard=shard,
                            **data_args),
        eval_data=load_data_from_args(
            "valid", batch_size=args.batch_size, skip_batches=eval_skip,
            shard=shard, **{**data_args, "deterministic": True}),
        eval_batches_consumed=eval_skip,
        samples_consumed=consumed if loop.step else None)
    logger.info(f"the parameter count is {loop.n_params} "
                f"({loop.n_params / 1e6:.1f}M), {loop.n_active_params} "
                f"active a token ({loop.n_active_params / 1e6:.1f}M); "
                f"device {device}; "
                f"fused update {loop.fused_update}; rank {rank} of {world}, "
                f"backend {dist.backend()}, data group "
                f"{loop.seq.data_index} of {loop.seq.dp}, sequence index "
                f"{loop.seq.index} of {loop.seq.size}, pipe stage "
                f"{loop.pipe.index} of {loop.pipe.size} (layers "
                f"{list(loop.shard.stage_layers)}), global batch "
                f"{loop.global_batch}; {local_mesh_info(loop.mesh)}, "
                f"ZeRO-1 {loop.shard.zero1}, layout "
                f"{json.dumps(loop.shard.describe())}")
    try:
        loop.run_loop()
        _write_summary(loop, run_dir, device)
    finally:
        logger.close()
    return loop


def _mpmd_main(args: TrainSettings) -> dict:
    """MPMD pipeline training: THIS process is the torch-free host driver.
    It writes the shared ``mpmd_config.json``, spawns one supervised
    launcher ring PER STAGE (each with its own restart budget, snapshots
    and beacon watchdog: stages are independently preemptible), and
    broadcasts the microbatch schedule over the StageLink command links.
    The stage workers (``mpmd/stage_worker.py``) own the torch math;
    activations and gradients move over the file-relay StageLink
    transport instead of a collective. The settings' refusals
    (``config/train.mpmd_refusal``) ran at parse time. Prints the JAX
    summary line and returns the driver's result."""
    from ..mpmd.driver import PipelineDriver

    ckpt_path = resolve_run_dir(args)
    os.makedirs(ckpt_path, exist_ok=True)
    flat = args.to_dict()
    device = flat.pop("device")  # where a run trained is not its config
    with open(os.path.join(ckpt_path, "training_args.json"), "w") as f:
        json.dump(flat, f, indent=2)
    if args.trace:
        # arm tracing pipeline-wide (the fleet parent's pattern): the env
        # rides the launcher's worker environment to every stage attempt,
        # so stage fwd/bwd spans carry the per-microbatch trace ids that
        # stitch the cross-process timeline
        from ..obs.trace import TRACE_ENV
        os.environ[TRACE_ENV] = "1"
    config = {
        "n_stages": args.mpmd_stages,
        "n_microbatches": args.pp_chunks,
        "schedule": args.pp_schedule,
        # create_model_from_config / load_data_from_args both swallow the
        # flat settings (the single-process path passes them too); the
        # loader gets batch_size on its own
        "model": flat,
        "data": {k: v for k, v in flat.items() if k != "batch_size"},
        "batch_size": args.batch_size,
        "seed": args.seed,
        "lr": args.lr,
        "weight_decay": args.weight_decay,
        "link_capacity": args.mpmd_link_capacity,
        # every stage's device ("" = CUDA)
        "device": device,
    }
    driver = PipelineDriver(
        ckpt_path, config, max_restarts=args.mpmd_max_restarts,
        hang_timeout_s=args.mpmd_hang_timeout_s,
        trace_armed=True if args.trace else None)
    try:
        result = driver.run(args.learning_steps)
    finally:
        driver.stop()
    driver.write_result(result)
    print(json.dumps({
        "mode": "mpmd", "stages": args.mpmd_stages,
        "schedule": args.pp_schedule, "steps": result["steps"],
        "final_loss": (result["losses"][-1] if result["losses"]
                       else None),
        "rewinds": result["rewinds"],
        "attempts_per_stage": result["attempts_per_stage"],
        "accounted_frac": result["goodput"].get("accounted_frac"),
    }), flush=True)
    return result


def _asks_mpmd(script_argv: Sequence[str]) -> bool:
    """Whether a command line (its flags, or its ``--config_json``) turns
    ``--mpmd`` on; read without building the settings, whose mesh checks
    need the ranks' world size."""
    from ..config.train import create_parser
    ns, _ = create_parser().parse_known_args(list(script_argv))
    if ns.config_json:
        with open(ns.config_json) as f:
            return bool(json.load(f).get("mpmd"))
    return bool(ns.mpmd)


def _parse_settings(argv: Sequence[str]) -> TrainSettings:
    from ..config.train import parse_settings
    return parse_settings(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Train from argv; ``--distributed --nprocs N`` runs this module as a
    supervised ring of N workers instead and exits with its code (that
    parent imports no torch; the workers do). ``--mpmd true`` runs the
    torch-free MPMD driver (``_mpmd_main``) and returns its result;
    under ``--distributed`` it is refused."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    dist_ns, script_argv = parse_distributed_args(argv)
    if dist_ns.distributed and _asks_mpmd(script_argv):
        from ..config.train import MPMD_SUBMESH
        raise SystemExit(f"--mpmd with --distributed is refused: "
                         f"{MPMD_SUBMESH}: each stage is a ring of one "
                         f"process of its own; drop --distributed")
    args = parse_and_autorun(_parse_settings, argv,
                             "distributed_pipeline_tpu_torch.run.train")
    if args.mpmd:
        return _mpmd_main(args)
    return train(args)


if __name__ == "__main__":
    main()
