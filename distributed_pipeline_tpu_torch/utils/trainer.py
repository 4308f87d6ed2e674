"""TrainLoop: the port of ``distributed_pipeline_tpu/utils/trainer.py``, on
one GPU (or the CPU, when asked) per process, data-parallel across the
processes of a ``torch.distributed`` group (``parallel/dist.py``).

The step is the JAX trainer's, written out eagerly:

* the microbatch loop: the family's ``compute_losses`` (``diffuseq_losses``
  or ``gpt2_losses``) forward and backward per microbatch, gradients summed
  and then **averaged** over the microbatches, metrics likewise
  (``micro_scan``). DiffuSeq's random draws come from a generator seeded
  from ``(seed, step, microbatch index)``, so a resumed run draws what an
  uninterrupted one would; eval passes draw from an offset stream
  (``0x7FFF0000 + step``), as the JAX trainer's do. The ``draws`` hook
  replaces that generator (the tests feed the JAX draws through it);
* ``grad_norm`` = the global L2 norm, then the clip
  ``min(1, clip / (gnorm + 1e-6))`` when ``gradient_clipping > 0``;
* the AdamW + EMA update of ``ops/fused_update.py`` in optax's op order,
  with ``lr`` from ``_lr_at`` (the reference's linear anneal after an
  optional warmup), through the fused CUDA kernel or its plain version.

State layout. Each state copy is ONE flat f32 buffer on the device: the
parameters (the model's ``nn.Parameter`` s are views into it), the
gradients (each parameter's ``.grad`` is a view, so autograd accumulates
into it in place), the Adam moments ``mu``/``nu``, and the EMA copies as one
``[R, n]`` buffer. The update is then one in-place launch per step, and the
step count and the ``(-lr, bc1, bc2)`` scalars stay device tensors, so the
host never waits on a step: metric scalars are fetched ``dispatch_lag``
steps late (all of one step in one copy), and flushed at eval, save and
exit. A log interval dumps the rows fetched so far and leaves the newest
``dispatch_lag`` steps in flight, as the JAX trainer does; the
all-reduce's and the ring's event pairs are read there only once they
have completed (``EventTimer.poll``).

``run_loop`` logs every ``log_interval`` steps (the step's metrics plus
``steps_per_sec``, ``tokens_per_sec``, ``tokens_per_sec_per_chip``,
``step_time_s`` and, on a GPU, ``mfu``; the stall gauges, ``goodput`` and
the footprint gauges), evaluates every ``eval_interval`` (then runs each
of ``eval_callbacks`` with the loop, as the JAX trainer does), saves every
``save_interval`` and once more at the end, keeping the newest
``keep_checkpoints`` steps when that is > 0. The loop's saves run in the
background (``utils/checkpoint.AsyncSaver``, the JAX trainer's
``save(wait=False)``): the device-to-host copy in the step loop, the files
on one writer thread, meta last; the loop waits for a save before the
next one, before pruning and at exit (also when it raises), and a
direct ``save()`` waits by default. ``prefetch_depth`` > 0 feeds
the step from ``data/device_prefetch.py`` (batches copied to the device
ahead of the step that reads them); ``debug_nans`` checks each step's
metrics, gradients and parameters on the host and raises
``FloatingPointError`` at the first non-finite one (the gradient and
parameters this rank holds, under a sharded state).

The training tooling (the JAX trainer's):

* **goodput** (``utils/perf.GoodputTracker``): ``DPT_SPAWN_T`` (the
  launcher's spawn stamp) gives ``startup_s``; construction minus restore
  and compile is ``setup_s``; the resume, walk-back included, is
  ``restore_s``; ``compile_s`` is the first use of the kernel library on
  a GPU (``ops/_build.py``: the nvcc build on a cold tree, the load on a
  warm one); a save's copy and scheduling, and each wait for a save in
  flight, are ``save_s`` (``save_times`` keeps both parts a save); the
  ``StallBreakdown``'s data and copy waits are ``data_stall_s``; steps
  up to ``recompute_until_step`` (an earlier attempt's, from the
  beacons) are ``recompute_s``. A step's
  slice is the wall time from the previous step's end to its own, less
  the saves between them;
* **beacons**: every rank atomically replaces ``progress_file`` every
  step (the JAX keys; by default ``.progress_rank{r}.json`` in the run
  dir whenever ``DPT_ATTEMPT`` is set): the launcher's hang watchdog and
  crash-loop probe, and a killed attempt's flight recorder. Rank 0
  writes ``goodput_attempt{A:03d}.json`` at a clean exit;
* **chaos** (``chaos/inject.py``): ``on_step`` at the top of
  ``run_step``, ``on_data`` before each batch pull (its seconds are
  ``data_wait_s``), ``on_save`` right after a save is scheduled
  (``crash_in_save`` tears the save in flight through ``tear_save``);
* **spans** (``obs/trace.py``, armed by ``trace`` or ``DPT_TRACE``):
  ``restore``, ``compile``, ``step``, ``eval`` and ``save`` (one for a
  save's copy and scheduling, one for each wait), booked from
  the seconds the goodput tracker gets, so the step spans sum to the
  step slices;
* **cost ledger** (``cost_ledger``): each log window computes the
  ``train_step`` row (``obs/ledger.TrainCensus`` through
  ``roofline_attribution``, over the window's rate and stall means), logs
  its gap terms and replaces ``perf_ledger.json`` (whose ``step`` is the
  newest step whose metrics were logged); once more at exit;
* **profiler window** (``profile_dir``): ``torch.profiler`` (CPU and
  CUDA activity) over loop steps ``[3, 8)`` or ``profile_steps`` "A:B",
  written by ``tensorboard_trace_handler`` into ``profile_dir``, flushed
  also when the run ends inside the window;
* **sanitizer** (``sanitize``): each step's dispatch (forward, backward,
  update) and the eval callbacks run under
  ``torch.cuda.set_sync_debug_mode("error")``; the intended transfers
  (the batch's placement, the lagged metric fetch, saves, gloo's
  host-staged collectives) stay outside it. A trip is recorded
  (``SanitizeReport.watch``) and re-raised; ``sanitize_report.json``
  (rank r > 0: ``rank{r:03d}/sanitize_report.json``) is written at exit
  and on the way down. The training step captures no CUDA graph, so
  ``recompile_count`` and ``steady_recompile_count`` are 0 by
  construction.

Data parallelism. Under a process group of P ranks each rank trains on its
shard (``batch_size`` rows a step; ``global_batch = batch_size * P``) and
the step is the JAX dp mesh's over the global batch, whose microbatch i is
rank 0's microbatch i, then rank 1's, and so on:

* the masked means of both losses take GLOBAL denominators: the
  microbatches' mask counts are summed over the ranks before the forward
  (one small all-reduce a step), and each rank's loss is its share
  ``sum(x * mask) / global_count``, so the gradients SUMMED over the ranks
  are those of the global mean;
* an MoE model's load-balance aux ``E * sum_e (F_e/n)(P_e/n)`` is not a
  sum of per-rank terms: the live-token counts ``n`` join that
  all-reduce, and after each microbatch's forward (before its
  ``backward()``) one all-reduce sums its ``[MoE blocks, E]`` expert
  counts ``F``; rank r's share is ``E * sum_e F_g,e * P_r,e / n_g**2``,
  which sums over the ranks to the global aux and has its gradient in
  ``P_r`` (``models/moe.py`` ``moe_aux``);
* after the microbatch loop, ONE all-reduce of the flat gradient buffer
  (every ``.grad`` is a view into it, so it covers the whole model; no
  ``DistributedDataParallel`` buckets), before ``grad_norm`` and the clip;
  the metric shares are summed the same way (a [microbatches, metrics]
  all-reduce), so every rank logs the global values;
* DiffuSeq's draws for microbatch i are drawn once for the global
  microbatch from the same seeded generator on every rank, and rank r
  takes rows ``r * microbatch : (r + 1) * microbatch`` (a ``draws`` hook
  returns the global microbatch's draws likewise);
* every rank starts from rank 0's parameters and EMA (``sync_params``);
  rank 0 alone writes and prunes checkpoints, then every rank passes a
  barrier; ``samples`` and ``tokens_per_sec`` count the global batch, and
  ``tokens_per_sec_per_chip`` divides by the distinct devices of the ring.

A process group of one rank runs the same path, and gives the losses of
no group at all bit for bit (a one-rank all-reduce is the identity).

Sequence parallelism (``sequence`` = sp > 1) splits the P ranks into
``dp = P / sp`` data groups of sp sequence ranks, in the JAX mesh's order
(``parallel/dist.py`` ``sequence_groups``): the ranks of a data group
read the same rows (``global_batch = batch_size * dp``), and each takes
its L/sp slice of every microbatch (``models.sequence_slice``; GPT-2's
last target of a slice is the next slice's first token). The step runs
inside ``parallel.ring.sequence_parallel``, so attention rings over the
group and positions start at the slice's offset. Every term of both
losses is a per-token masked mean, so the global denominators, the
metric shares and the one gradient all-reduce stay world-wide: local
counts and partial gradients summed over all ranks are the global ones.
DiffuSeq's draws are the global microbatch's, sliced by data index over
rows and by sequence index over the noise's positions (``t`` is one a
row). The ring's shifts are timed like the all-reduce
(``ring_shift_s_per_step``).

Sharded state (``dp``, ``fsdp``, ``shard_optimizer``, ``partition_rules``;
the JAX trainer's mesh axes and ZeRO-1). The ranks form a mesh
(``parallel/mesh.py``: rank r at its index in ``arange(world).reshape(dp,
fsdp, sequence, ...)``, a process group per data and fsdp group), and a
``parallel/partition.ShardLayout`` lays the flat buffers out:

* ``--fsdp F``: the leaves the rule table (the family's, or
  ``partition_rules``) cuts over fsdp at the run's sizes live 1/F on each
  fsdp rank, a contiguous range of each unit's cut leaves (ROADMAP C.17);
  the replicated leaves stay whole. The units (a block each, and the rest)
  are gathered around their forward and backward and their gradients
  reduce-scattered after every microbatch (``parallel/fsdp.py``); the
  replicated leaves' gradients are all-reduced over the fsdp group after
  the microbatch loop. The fsdp ranks read distinct rows, as data ranks do;
* ``--shard_optimizer`` (ZeRO-1): the rank's flat buffer is padded to a
  multiple of dp and the rank owns its data index's contiguous dp-th:
  ``mu``, ``nu`` and its own ``[R, owned]`` EMA buffer cover that range
  only (the fused kernel takes contiguous buffers, and a column slice of
  a shared ``[R, n]`` EMA would not be). After the microbatch loop ONE
  reduce-scatter over the data group sums the gradient into the owned
  range (a view of the gradient buffer); ``grad_norm`` is the owned
  ranges' squares summed over the ranks (the replicated leaves' divided
  by their copies); then the clip, ONE fused-update launch over the owned
  range, and ONE all-gather of the parameters over the data group. With
  two ranks the sums are a + b as the all-reduce's are, so losses and
  parameters are bitwise the unsharded run's; ``grad_norm`` differs by
  its sum order.

Every rank starts from its shard of rank 0's values. Checkpoints stay
layout-free: a save gathers each full state to rank 0 (every rank takes
part) and writes the usual files, and a resume under any dp, fsdp or
``shard_optimizer`` cuts its shard from them (``load_state``);
``full_flat``, ``ema_weights``, ``ema_state_dicts`` and the eval callbacks
(run inside ``full_weights``) gather likewise. Sharding with ``sequence >
1`` is refused (ROADMAP A.8g).

Pipeline parallelism (``pipe`` = S > 1, a stacked ``scan_layers`` model;
the JAX ``--pipe``). The pipe axis is the mesh's innermost, so each S
consecutive ranks are one pipe group that reads the same rows, and rank
r's stage index is its pipe coordinate. The ``ShardLayout`` gives each
rank the rows of its stage's layers of every stacked weight (first in its
flat buffers) and the rest of the model whole; every microbatch runs the
model's schedule (``pp_schedule``: gpipe, 1f1b or interleaved over
``pp_chunks`` chunks, ``models/schedule_1f1b.py``) inside
``pipeline.pipe_parallel``, which runs its own backward. Then:

* the stage slice's gradient is all-reduced over the data group (the
  ranks that hold the same stage), and the rest's over every rank (data x
  pipe), as the JAX engine psums it: the tied embedding's gradient is the
  sum of stage 0's embedding and the last stage's head;
* the loss shares (the last stage's loss terms, stage 0's DiffuSeq
  embedding-only terms, zeros elsewhere) are summed over every rank, so
  every rank logs the same loss; the global denominators are counted once
  a pipe group (its stage 0 contributes them);
* ``grad_norm`` sums the stage slices' squares over the pipe group and
  counts the rest once; the fused update runs once over the rank's flat
  buffers (its stage slice and the rest);
* DiffuSeq's draws are keyed by the row group: every pipe rank of a row
  group draws the same ``t`` and noise;
* checkpoints hold full stacked ``[num_layers, ...]`` tensors in layer
  order, gathered over the pipe group (``full_flat``), and a resume under
  any pipe size takes its stage's rows; a checkpoint of named blocks
  loads into a stacked model and the reverse (``convert.to_layout``);
* the exchange's seconds are ``pipe_p2p_s_per_step`` (CUDA events
  around each tick's exchange), its bytes ``dist.pipe_bytes()``, the
  most stage inputs the 1F1B stash held ``pipe_ctx.stash_peak``;
* the eval callbacks run inside ``full_weights``, which gathers the full
  stacked weights onto every rank (``models/sampling.py``'s decode
  callback decodes on each pipe group's stage 0 while the others wait).

The pipe composes with the rest of the mesh (the JAX ``stacked_specs``
and ``MoEScanBlocks._gpipe``):

* ``--fsdp F``: a stage's cut rows are the stage unit
  (``parallel/fsdp.py``: gathered once a microbatch and held across its
  ticks, or a layer at a time inside the checkpointed body under
  ``remat``; the gradient reduce-scattered back), and the fsdp ranks read
  distinct rows;
* ``--shard_optimizer``: the rank's flat buffer (its stage slice and the
  rest) is owned a data-th at a time, as without a pipe;
* ``--sequence sp``: the ranks a ring spans come from the mesh
  (``RankMesh.sequence_groups``: under a pipe they are not consecutive),
  and a stage's attention rings over them on the GPipe stream;
* an MoE model (``MoEScanBlocks``, {data, pipe} only) trains on the GPipe
  stream, each stage's aux from its groups' sums over every chunk with
  the counts summed over the stage's ranks;
* each range of the gradient sums over the ranks that hold it
  (``_reduce_staged_grads``), and ``grad_norm`` divides each range's
  squares by its copies.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from fractions import Fraction
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..chaos.goodput import beacon_path, goodput_record_path
from ..config.train import pipe_refusal
from ..convert import init_params as random_params
from ..convert import to_layout
from ..data.device_prefetch import prefetch_to_device
from ..models import (GlobalMoEStats, Model, compute_losses, finish_losses,
                      loss_count, moe_live_count, sequence_slice)
from ..models.diffuseq import Draws, rank_draws, seeded_generator
from ..models.pipeline import PipeContext, pipe_parallel
from ..obs import ledger as ledger_lib
from ..obs import trace as trace_lib
from ..ops import flash_attention
from ..ops.fused_update import (fused_adamw_ema, resolve_fused_update,
                                torch_fused_update, update_scalars)
from ..parallel import dist
from ..parallel.fsdp import FsdpUnits
from ..parallel.mesh import make_mesh
from ..parallel.partition import Rules, ShardLayout, rules_for_workload
from ..parallel.ring import sequence_parallel
from . import checkpoint as ckpt
from .logger import Logger
from .perf import (EventTimer, GoodputTracker, SanitizeReport,
                   StallBreakdown, StepTimer, active_param_count, mfu,
                   parse_profile_steps, peak_live_bytes)

__all__ = ["TrainLoop"]

StateDict = Dict[str, torch.Tensor]

class TrainLoop:
    """``TrainLoop(model=..., data=..., ...)`` then ``run_loop()`` (or
    ``run_step(batch)`` step by step). ``model`` is a :class:`DiffuSeqModel`
    or :class:`GPT2Model` on the device to train on; its weights come from
    ``init_params`` (a state dict), else from ``convert.init_params`` at
    ``seed``, unless a checkpoint is resumed. ``draws(step, i)``, when
    given, returns the (global) microbatch i's DiffuSeq draws at ``step``
    (a generator or ``{"t", "noise"}``) in place of the seeded generator.
    ``batch_size`` and ``microbatch`` are per rank (the rows of its data
    group); ``sequence`` is the sequence-parallel group size; ``dp``,
    ``fsdp``, ``shard_optimizer`` and ``partition_rules`` lay out the
    sharded state, and ``pipe`` the pipeline stages (the module
    docstring). ``chaos``
    (a ``ChaosInjector``), ``progress_file``, ``recompute_until_step``,
    ``trace`` (None defers to ``DPT_TRACE``), ``cost_ledger``,
    ``sanitize``, ``profile_dir`` and ``profile_steps`` are the tooling of
    the module docstring."""

    def __init__(self, *, model: Model,
                 data: Optional[Iterator[Dict[str, np.ndarray]]],
                 batch_size: int, microbatch: int = -1, lr: float = 1e-4,
                 ema_rate: str = "0.9999", log_interval: int = 50,
                 eval_interval: int = 1000, save_interval: int = 10000,
                 resume_checkpoint: str = "", gradient_clipping: float = -1.0,
                 weight_decay: float = 0.0, learning_steps: int = 0,
                 warmup_steps: int = 0,
                 eval_data: Optional[Iterator[Dict[str, np.ndarray]]] = None,
                 eval_callbacks: Sequence[Callable[["TrainLoop"], None]]
                 = (),
                 checkpoint_dir: str = "", seed: int = 102,
                 dispatch_lag: int = 0, fused_update: Any = "auto",
                 init_params: Optional[Mapping[str, torch.Tensor]] = None,
                 draws: Optional[Callable[[int, int], Draws]] = None,
                 keep_checkpoints: int = 0, debug_nans: bool = False,
                 prefetch_depth: int = 0, sequence: int = 1,
                 dp: int = -1, fsdp: int = 1, shard_optimizer: bool = False,
                 partition_rules: Optional[Rules] = None, pipe: int = 1,
                 chaos: Optional[Any] = None, progress_file: str = "",
                 recompute_until_step: int = 0,
                 trace: Optional[bool] = None, cost_ledger: bool = False,
                 sanitize: bool = False, profile_dir: str = "",
                 profile_steps: str = "",
                 logger: Optional[Logger] = None) -> None:
        # time-to-signal accounting starts here: everything up to the
        # first step (state init, restore, the kernels' first use) is
        # setup the user waits through
        self._construct_t0 = time.perf_counter()
        self.model = model
        self.keep_checkpoints = keep_checkpoints
        self.debug_nans = debug_nans
        self.prefetch_depth = prefetch_depth
        self.eval_data = eval_data
        self.eval_callbacks = tuple(eval_callbacks)
        self.seed = seed
        # the hook, or None for the seeded generator (a bound method kept
        # here would tie the loop into a reference cycle, and a deleted
        # loop would hold its device state until the cyclic collector ran)
        self._draws = draws
        self.batch_size = batch_size
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        # a group of one rank takes the collective path too
        self.distributed = dist.is_initialized()
        if sequence > 1 and (fsdp > 1 or shard_optimizer):
            raise ValueError(
                "--fsdp and --shard_optimizer with --sequence > 1 come with "
                "ROADMAP A.8g (the gradient's sums over the sequence ranks "
                "and the data shards together)")
        refused = pipe_refusal(pipe, model.scan_layers, fsdp,
                               sequence, model.moe_experts)
        if refused:
            raise ValueError(refused)
        self.mesh = make_mesh(dp=dp, fsdp=fsdp, sequence=sequence,
                              pipe=pipe)
        self.seq = self.mesh.sequence_groups()
        self.pipe = self.mesh.pipe_group()
        # the exchange's seconds (pipeline parallelism), read at each flush
        self.pipe_time = EventTimer()
        self.pipe_ctx: Optional[PipeContext] = None
        if pipe > 1:
            schedule = model.pp_schedule
            if model.moe_experts > 0 or sequence > 1:
                # the JAX routing: MoE stages and rings inside a stage
                # train on the GPipe stream whatever the request
                schedule = "gpipe"
            virtual = model.pp_virtual if schedule == "interleaved" else 1
            self.pipe_ctx = PipeContext(self.pipe, schedule,
                                        model.pp_chunks, max(virtual, 1),
                                        self.pipe_time)
        self.shard_optimizer = shard_optimizer
        self.partition_rules = (tuple(partition_rules)
                                if partition_rules else None)
        self.microbatch = microbatch if microbatch > 0 else batch_size
        if batch_size % self.microbatch:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"microbatch {self.microbatch}")
        # the rows a step reads: the rank's batch times the row groups
        # (the data, fsdp and expert ranks read distinct rows; every rank
        # reads its own microbatches, so the JAX check that the global
        # microbatch divides over them holds by construction)
        self.global_batch = batch_size * self.mesh.rows()[1]
        self.n_micro = batch_size // self.microbatch
        self.lr = lr
        self.ema_rates = tuple(r.strip() for r in str(ema_rate).split(",")
                               if r.strip())
        self._rate_values = [float(r) for r in self.ema_rates]
        self.log_interval = log_interval
        self.eval_interval = eval_interval
        self.save_interval = save_interval
        self.gradient_clipping = gradient_clipping
        self.weight_decay = weight_decay
        self.learning_steps = learning_steps
        self.warmup_steps = warmup_steps
        self.checkpoint_dir = checkpoint_dir
        self.dispatch_lag = dispatch_lag
        self.logger = logger if logger is not None else Logger(checkpoint_dir)
        self.device = next(model.parameters()).device
        self.fused_update = resolve_fused_update(fused_update, self.device)
        self.eval_batches_consumed = 0
        # the decode callback's records ({"step", "key", "value",
        # "tokens_sha256"}, models/sampling.py)
        self.eval_decodes: List[Dict[str, Any]] = []
        # per-step metrics as fetched (step, loss, grad_norm, lr, ...)
        self.history: List[Dict[str, float]] = []
        self._inflight: "collections.deque" = collections.deque()
        self.profile_dir = profile_dir
        self._profile_window = parse_profile_steps(profile_steps)
        self._profiler: Optional[Any] = None
        self.chaos = chaos
        self.recompute_until_step = recompute_until_step
        self.cost_ledger = cost_ledger
        self.sanitize = sanitize
        self.sanitize_report = SanitizeReport()
        self.stalls = StallBreakdown()
        self.padding = ledger_lib.PaddingMeter() if cost_ledger else None
        self.goodput = GoodputTracker(t0=self._construct_t0)
        spawn_t = os.environ.get("DPT_SPAWN_T", "")
        if spawn_t:
            # the launcher's spawn stamp: the interpreter, torch import and
            # process-group init before this constructor are attempt time
            startup = max(0.0, time.time() - float(spawn_t))
            self.goodput.base_s = startup
            self.goodput.add("startup_s", startup)
        if (not progress_file and checkpoint_dir
                and os.environ.get("DPT_ATTEMPT") is not None):
            # under the launcher every loop beacons by default
            progress_file = beacon_path(checkpoint_dir, self.rank)
        self.progress_file = progress_file
        self.beacon_s = 0.0     # seconds spent writing beacons
        self.tracer = trace_lib.tracer_for(checkpoint_dir, self.rank,
                                           armed=trace)
        self.saver = ckpt.AsyncSaver()
        # a save's seconds: {"step", "copy_s", "wait_s"} (wait_s once the
        # save has been waited for)
        self.save_times: List[Dict[str, Any]] = []

        self.data = self._wrap_prefetch(data)
        # the gradient all-reduce's time, the ZeRO-1 and FSDP collectives'
        # and the ring's shifts' (sequence parallelism), read at each flush
        self.allreduce_time = EventTimer()
        self.reduce_scatter_time = EventTimer()
        self.all_gather_time = EventTimer()
        self.shift_time = EventTimer()
        self._build_state(init_params, seed)
        self.step = 0
        self.resumed_from = ""
        self.resume_meta: Optional[Dict[str, Any]] = None
        self._load_kernels()
        self._resume(resume_checkpoint)
        self.start_step = self.step
        if self.world > 1 and not self.shard.sharded:
            # every rank starts from rank 0's weights (a resumed run loaded
            # the same files everywhere; a fresh one may have been seeded
            # apart; a sharded state took its shard of rank 0's values in
            # _build_state)
            dist.sync_params(self.params)
            dist.broadcast(self.ema)
        self._samples = self.step * self.global_batch
        self.n_params = self.shard.n
        # the parameters a token runs through (top-k of an MoE block's
        # experts); mfu counts them all, as the JAX trainer does
        self.n_active_params = active_param_count(
            dict(model.named_parameters()), self.n_params,
            moe_experts=model.moe_experts, moe_top_k=model.moe_top_k)
        self.n_devices = dist.device_count()
        self.throughput: Dict[str, float] = {}
        tokens_per_step = self.global_batch * model.seq_len
        self._timer = StepTimer(tokens_per_step)
        seq_rank_len = model.seq_len // self.seq.size
        self.census = ledger_lib.TrainCensus(
            n_params=self.n_params, num_layers=model.num_layers,
            hidden=model.hidden_size, seq_len=model.seq_len,
            tokens_per_step=tokens_per_step, n_micro=self.n_micro,
            compute_bytes=torch.finfo(model.dtype).bits // 8,
            n_ema_rates=len(self.ema_rates), world=self.world,
            update_elems=self.shard.own,
            flash_shape=(self.microbatch, model.num_heads, seq_rank_len,
                         model.hidden_size // model.num_heads,
                         model.family == "diffuseq"))
        self._flops_per_token = self.census.flops_per_token
        self._ledger_row: Optional[Dict[str, Any]] = None
        self._ledger_mark = self._ledger_counts()
        # construction minus the restore and the kernels' first use: the
        # state and model setup a restart pays even warm
        self.goodput.add("setup_s", time.perf_counter() - self._construct_t0
                         - self.goodput.get("restore_s")
                         - self.goodput.get("compile_s"))
        # the goodput step-slice anchors
        self._g_prev_t = time.perf_counter()
        self._g_prev_wall = time.time()
        self._g_prev_stall = self._stall_sum()
        self._g_prev_compile = self.goodput.get("compile_s")

    # ------------------------------------------------------------- state

    def _build_state(self, init_params, seed: int) -> None:
        """Flat buffers, parameters and gradients as views into them (the
        cut leaves of an FSDP unit into the unit's gathered buffers), laid
        out by the ``ShardLayout`` of the mesh, the rule table and
        ``shard_optimizer``; the update's state covers the rank's owned
        range."""
        named = list(self.model.named_parameters())
        mesh = self.mesh
        rules = (self.partition_rules if self.partition_rules is not None
                 else rules_for_workload(self.model))
        self.shard = shard = ShardLayout(
            [(name, tuple(p.shape)) for name, p in named], sizes=mesh.shape,
            rules=rules, fsdp_index=mesh.index("fsdp"),
            data_index=mesh.index("data"),
            shard_optimizer=self.shard_optimizer,
            pipe_index=self.pipe.index,
            pipe_virtual=(self.pipe_ctx.virtual if self.pipe_ctx else 1))
        if self.pipe_ctx is not None and self.model.moe_experts > 0:
            m = self.model
            G, S = m.num_layers // m.moe_every, self.pipe.size
            if G % S:
                raise ValueError(f"MoE group count {G} (num_layers "
                                 f"{m.num_layers} / moe_every "
                                 f"{m.moe_every}) not divisible by pipe "
                                 f"axis {S}")
        if self.pipe_ctx is not None:
            loose = [name for name, _p in named
                     if ".blocks." in name and name not in shard.staged]
            if loose or not shard.staged:
                raise ValueError(f"--pipe > 1: the rule table puts no "
                                 f"'pipe' on dim 0 of {loose or 'any leaf'}"
                                 f" (the stacked rules shard the layers)")
        self._layout = shard.full
        dev, f32 = self.device, torch.float32
        self.params = torch.zeros(shard.m_pad, dtype=f32, device=dev)
        self.grads = torch.zeros(shard.m_pad, dtype=f32, device=dev)
        self.mu = torch.zeros(shard.own, dtype=f32, device=dev)
        self.nu = torch.zeros(shard.own, dtype=f32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        if init_params is None and self.world > 1 and self.rank > 0:
            # every rank takes rank 0's draw (broadcast below, or by
            # sync_params): the others' would be thrown away
            init_params = {name: torch.zeros(shape) for name, (_o, _n, shape)
                           in self._layout.items()}
        elif init_params is None:
            m = self.model
            init_params = random_params(dict(
                model_family=m.family, vocab_size=m.vocab_size,
                seq_len=m.seq_len, hidden_size=m.hidden_size,
                num_layers=m.num_layers, num_heads=m.num_heads,
                moe_experts=m.moe_experts, moe_every=m.moe_every,
                scan_layers=m.scan_layers), seed)
        init_params = self._as_layout(init_params)
        self._check_state(init_params)
        if shard.sharded and self.world > 1:
            # every rank takes its shard of rank 0's values (a fresh run
            # may have been seeded apart)
            full = torch.empty(shard.n, dtype=f32, device=dev)
            self._load_full(full, init_params)
            dist.broadcast(full)
            init_params = self.state_dict_of(full)
        shard.local_from_full(init_params, self.params)
        for name, p in named:
            if name in shard.local:
                off, n, shape = shard.local[name]
                p.data = self.params[off:off + n].view(shape)
                p.grad = self.grads[off:off + n].view(shape)
        self.fsdp = (FsdpUnits(self.model, shard, self.params, self.grads,
                               self.mesh.group("fsdp"), self.all_gather_time,
                               self.reduce_scatter_time)
                     if shard.units or shard.stage_unit else None)
        # fresh EMA = a copy of the (owned) params, per rate
        self.ema = self._owned(self.params)[None].repeat(
            len(self.ema_rates), 1)

    def _as_layout(self, state: Mapping[str, Any]) -> Mapping[str, Any]:
        """A full state dict in this model's block layout (named or
        stacked, ``convert.to_layout``)."""
        return to_layout(state, self._layout)

    def _owned(self, local: torch.Tensor) -> torch.Tensor:
        """The range of a rank-layout buffer this rank updates."""
        return local[self.shard.lo:self.shard.hi]

    def _view(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        off, n, shape = self._layout[name]
        return flat[off:off + n].view(shape)

    def state_dict_of(self, flat: torch.Tensor) -> StateDict:
        """A params-shaped state dict of views into a full flat buffer
        (``full_flat``; an unsharded loop's own buffers are full)."""
        return {name: self._view(flat, name) for name in self._layout}

    def _load_full(self, flat: torch.Tensor,
                   state: Mapping[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name in self._layout:
                self._view(flat, name).copy_(state[name])

    def _load_owned(self, dst: torch.Tensor,
                    state: Mapping[str, torch.Tensor]) -> None:
        """This rank's owned range of a full state dict into ``dst``."""
        if not self.shard.zero1:
            self.shard.local_from_full(state, dst)
            return
        local = torch.zeros(self.shard.m_pad, dtype=dst.dtype,
                            device=dst.device)
        self.shard.local_from_full(state, local)
        dst.copy_(self._owned(local))

    def load_state(self, params: Mapping[str, torch.Tensor],
                   ema: Optional[Mapping[str, Mapping[str, torch.Tensor]]]
                   = None, opt: Optional[Mapping[str, Any]] = None) -> None:
        """Set the training state from full state dicts, whatever the
        layout they were saved under: params, EMA copies per rate
        (default: a copy of the params) and ``{"mu", "nu", "count"}``
        (default: fresh); each rank keeps its shard. A state of the other
        block layout (named or stacked) is converted first."""
        params = self._as_layout(params)
        if ema:
            ema = {r: self._as_layout(e) for r, e in ema.items()}
        if opt is not None:
            opt = {**opt, "mu": self._as_layout(opt["mu"]),
                   "nu": self._as_layout(opt["nu"])}
        self._check_state(params)
        with torch.no_grad():
            self.shard.local_from_full(params, self.params)
            for i, rate in enumerate(self.ema_rates):
                self._load_owned(self.ema[i], ema[rate] if ema else params)
            if opt is None:
                self.mu.zero_()
                self.nu.zero_()
                self.count.fill_(0)
            else:
                self._load_owned(self.mu, opt["mu"])
                self._load_owned(self.nu, opt["nu"])
                self.count.fill_(int(opt["count"]))

    def full_flat(self, which: str = "params", rate: str = "") -> torch.Tensor:
        """The full flat layout (``n_params`` elements) of ``which``:
        ``params``, ``mu``, ``nu`` or ``ema`` (of ``rate``). A view of the
        loop's own buffer when the state is not sharded; else a gathered
        copy, a collective every rank calls (the owned ranges all-gathered
        over the data group, then the units' pieces over the fsdp group,
        or the stage slices over the pipe group)."""
        shard = self.shard
        if which == "params":
            local = self.params
        else:
            own = (self.ema[self.ema_rates.index(rate)] if which == "ema"
                   else getattr(self, which))
            if not shard.zero1:
                local = own
            else:
                local = own.new_empty(shard.m_pad)
                dist.all_gather(local, own, self.mesh.group("data"))
        if not shard.units and not shard.staged:
            return local[:shard.n]
        return shard.gather_full(local, local.new_empty(shard.n),
                                 self.mesh.group("fsdp"),
                                 pipe_group=self.pipe.group)

    @contextlib.contextmanager
    def _pinned(self, flat: torch.Tensor) -> Iterator[None]:
        """Inside the block each parameter's ``data`` is a view into the
        full flat buffer ``flat`` (a stacked weight whole, every layer),
        and its own view again after it."""
        named = list(self.model.named_parameters())
        before = [p.data for _name, p in named]
        try:
            for name, p in named:
                p.data = self._view(flat, name)
            yield
        finally:
            for (_name, p), data in zip(named, before):
                p.data = data

    @contextlib.contextmanager
    def full_weights(self) -> Iterator[None]:
        """Inside the block every parameter is whole: under ``--fsdp`` a
        view into one gathered copy (every rank gathers), with the units'
        hooks off; under ``--pipe`` likewise, every layer of the stacked
        weights; otherwise as it is."""
        if self.fsdp is not None:
            with self.fsdp.pinned_to(self.full_flat("params")):
                yield
            return
        if self.pipe_ctx is not None:
            with self._pinned(self.full_flat("params")):
                yield
            return
        yield

    @contextlib.contextmanager
    def ema_weights(self, rate: str) -> Iterator[None]:
        """Inside the block the model computes with the EMA copy of
        ``rate``: each parameter's ``data`` is a view into that EMA row
        (gathered first when the EMA is sharded: every rank calls this;
        nothing of the training state is written), and its previous view
        again after it."""
        ema = self.full_flat("ema", rate)
        if self.fsdp is not None:
            with self.fsdp.pinned_to(ema):
                yield
            return
        with self._pinned(ema):
            yield

    def ema_state_dicts(self) -> Dict[str, StateDict]:
        """Each rate's EMA as a full state dict (gathered when sharded)."""
        return {r: self.state_dict_of(self.full_flat("ema", r))
                for r in self.ema_rates}

    def _check_state(self, state: Mapping[str, Any]) -> None:
        """Raise unless ``state`` is a state dict of this model's
        parameter names and shapes (the resume walks back past one that
        is not); a state of the other block layout is converted first."""
        if isinstance(state, Mapping):
            try:
                state = self._as_layout(state)
            except KeyError:
                pass
        if not isinstance(state, Mapping) or set(state) != set(self._layout):
            raise KeyError("checkpoint keys differ from the model's")
        for name, (_off, _n, shape) in self._layout.items():
            if tuple(state[name].shape) != shape:
                raise ValueError(f"checkpoint {name} has shape "
                                 f"{tuple(state[name].shape)}, the model "
                                 f"{shape}")

    def _resume(self, resume_checkpoint: str) -> None:
        """Restore the newest finalized step of the run dir, walking back
        past unloadable ones (or exactly ``resume_checkpoint``), booked as
        ``restore_s`` and a ``restore`` span."""
        t0, t0_wall = time.perf_counter(), time.time()
        state = ckpt.restore_resume_state(
            self.checkpoint_dir, self.ema_rates, device=self.device,
            explicit_model_path=resume_checkpoint, check=self._check_state,
            warn=self.logger.info)
        if state is not None:
            self.load_state(state["params"], state["ema"], state["opt"])
            self.step = state["step"]
            self.resume_meta = state["meta"]
            self.resumed_from = os.path.dirname(state["path"])
            self.logger.info(f"resumed from step {self.step} "
                             f"({self.resumed_from})")
        dt = time.perf_counter() - t0
        self.goodput.add("restore_s", dt)
        if self.tracer.enabled:
            self.tracer.complete("restore", "ckpt", t0_wall, dt,
                                 args={"step": self.step,
                                       "resumed": state is not None})

    def _load_kernels(self) -> None:
        """The kernel library's first use on a GPU (``ops/_build.py``: the
        nvcc build on a cold tree, the load on a warm one), booked once as
        ``compile_s`` and a ``compile`` span; nothing on the CPU."""
        if self.device.type != "cuda":
            return
        from ..ops import _build
        t0, t0_wall = time.perf_counter(), time.time()
        _build.load_library()
        dt = time.perf_counter() - t0
        self.goodput.add("compile_s", dt)
        if self.tracer.enabled:
            self.tracer.complete("compile", "compile", t0_wall, dt,
                                 args={"fn": "ops/_build.load_library"})
        self.logger.info(f"kernel library ready in {dt:.2f}s")

    def set_data(self, data: Iterator, *,
                 eval_data: Optional[Iterator] = None,
                 eval_batches_consumed: Optional[int] = None,
                 samples_consumed: Optional[int] = None) -> None:
        """Wire the data streams after construction, once the resumed step
        is known (run/train.py fast-forwards them to it)."""
        self.data = self._wrap_prefetch(data)
        if eval_data is not None:
            self.eval_data = eval_data
        if eval_batches_consumed is not None:
            self.eval_batches_consumed = eval_batches_consumed
        if samples_consumed is not None:
            self._samples = int(samples_consumed)

    def _wrap_prefetch(self, data: Optional[Iterator]) -> Optional[Iterator]:
        if data is None:
            return data
        if self.padding is not None:
            data = self._metered(data)
        if self.prefetch_depth <= 0:
            return data
        return prefetch_to_device(data, self.device, self.prefetch_depth,
                                  stats=self.stalls)

    def _metered(self, data: Iterator) -> Iterator:
        """The host batches as they are, their ``pad_mask`` counted into
        the padding meter (the cost ledger's ``padding_waste_frac``)."""
        for batch in data:
            pm = batch.get("pad_mask")
            if pm is not None:
                self.padding.add(int(np.sum(pm)), int(np.size(pm)))
            yield batch

    def next_batch(self) -> Dict[str, Any]:
        """Pull the next training batch: a chaos ``stall_data`` fault
        first, then the iterator, its wait booked as ``data_wait_s`` (the
        prefetch wrapper books its own waits)."""
        if self.chaos is not None:
            stalled = self.chaos.on_data(self)
            if stalled:
                self.stalls.add("data_wait_s", stalled)
        if self.prefetch_depth > 0:
            return next(self.data)
        t0 = time.perf_counter()
        batch = next(self.data)
        self.stalls.add("data_wait_s", time.perf_counter() - t0)
        return batch

    # -------------------------------------------------------------- step

    def _lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """The reference's linear anneal ``lr * (1 - step/total)``, after a
        linear warmup from 0 over ``warmup_steps`` when set; f32, on the
        step's device (filled there: no host copy)."""
        lr = torch.full((), self.lr, dtype=torch.float32, device=step.device)
        s = step.to(torch.float32)
        if self.learning_steps > 0:
            lr = lr * torch.clamp(1.0 - s / self.learning_steps, min=0.0)
        if self.warmup_steps > 0:
            lr = lr * torch.clamp((s + 1) / self.warmup_steps, max=1.0)
        return lr

    def _micro(self, batch: Mapping[str, Any]) -> List[Dict]:
        """Batch [B, ...] (numpy, or tensors from the prefetcher) ->
        microbatches of device tensors; under sequence parallelism each is
        this rank's L slice (``models.sequence_slice``)."""
        out = [{} for _ in range(self.n_micro)]
        for key, val in batch.items():
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.ascontiguousarray(val))
            t = val.to(self.device, non_blocking=True)
            for i, part in enumerate(t.reshape(
                    (self.n_micro, self.microbatch) + t.shape[1:])):
                out[i][key] = part
        if self.seq.size > 1:
            out = [sequence_slice(self.model, mb, self.seq.index,
                                  self.seq.size) for mb in out]
        return out

    def _seeded_draws(self, step: int, i: int) -> torch.Generator:
        return seeded_generator(self.device, self.seed, step, i)

    def _rank_draws(self, step: int, i: int, mb: Mapping[str, torch.Tensor]
                    ) -> Draws:
        """Microbatch i's draws for this rank: the global microbatch's,
        sliced to its row group's rows and its sequence slice's
        positions under several ranks (every pipe rank of a row group
        takes the same)."""
        draws = (self._draws or self._seeded_draws)(step, i)
        if self.world == 1 or self.model.family != "diffuseq":
            return draws
        seq = self.seq
        row, rows = self.mesh.rows()
        shape = tuple(mb["input_ids"].shape) + (self.model.emb_dim,)
        return rank_draws(self.model.schedule, draws, shape, row, rows,
                          seq.index, seq.size)

    def _global_denoms(self, mbs: List[Dict]) -> List[tuple]:
        """Each microbatch's ``(denom, moe_global)``: the masked means'
        denominator summed over the ranks, clamped to >= 1, and for an MoE
        model the global live-token count with the expert counts'
        all-reduce (one all-reduce for every microbatch's counts); Nones
        without a process group (each loss then takes its own). A pipe
        group counts its rows once (its stage 0's counts)."""
        if not self.distributed:
            return [(None, None)] * len(mbs)
        moe = self.model.moe_experts > 0
        counts = torch.stack([
            torch.stack([loss_count(self.model, mb)]
                        + ([moe_live_count(mb)] if moe else []))
            for mb in mbs])                         # [micro, 1 or 2]
        if self.pipe.index > 0:
            counts.zero_()
        dist.all_reduce(counts)
        denoms = torch.clamp(counts[:, 0], min=1.0).unbind(0)
        if not moe:
            return [(d, None) for d in denoms]
        # the expert counts sum over the ranks that route through the same
        # blocks: every rank, or a stage's ranks under a pipe
        reduce = (dist.all_reduce if self.pipe_ctx is None
                  else lambda t: self._sum(t, "~pipe"))
        return [(d, GlobalMoEStats(n, reduce))
                for d, n in zip(denoms, counts[:, 1].unbind(0))]

    def _sum(self, t: torch.Tensor, key: str) -> torch.Tensor:
        """``t`` summed in place over the mesh group ``key`` (an axis, or
        ``~axis`` for every axis but it); nothing over a group of one."""
        if self.mesh.span(key) > 1:
            dist.all_reduce(t, self.mesh.group(key))
        return t

    def _summed_metrics(self, per_micro: List[Dict[str, torch.Tensor]]
                        ) -> Dict[str, torch.Tensor]:
        """The metrics summed over the microbatches; under a process group
        each microbatch's shares are first summed over the ranks (one
        all-reduce) and finished (``finish_losses``)."""
        if self.distributed:
            keys = sorted(per_micro[0])
            shares = torch.stack([torch.stack([d[k] for k in keys])
                                  for d in per_micro])
            dist.all_reduce(shares)
            per_micro = [finish_losses(self.model, dict(zip(keys, row)))
                         for row in shares]
        sums: Dict[str, torch.Tensor] = {}
        for d in per_micro:
            for k, v in d.items():
                sums[k] = v if k not in sums else sums[k] + v
        return sums

    def _reduce_grads(self) -> None:
        """Sum the gradients over the ranks: under ``--fsdp`` the
        replicated leaves' over the fsdp group (the units' pieces were
        reduce-scattered there after each microbatch); then over the data
        axis, by one reduce-scatter into the rank's owned range under
        ZeRO-1, else one all-reduce (of everything, over every rank,
        without sharding). Under ``--pipe`` the stage slice over the data
        group (the ranks of the same stage) and the rest over every rank.
        Each collective is timed into its ``EventTimer``."""
        shard = self.shard
        if shard.staged:
            self._reduce_staged_grads()
            return
        if self.fsdp is not None:
            with self.allreduce_time.measure(self.device):
                dist.all_reduce(self.grads[shard.pieces:shard.m],
                                self.mesh.group("fsdp"))
        if shard.zero1:
            with self.reduce_scatter_time.measure(self.device):
                dist.reduce_scatter(self._owned(self.grads), self.grads,
                                    self.mesh.group("data"))
        elif self.fsdp is None:
            with self.allreduce_time.measure(self.device):
                dist.all_reduce(self.grads)
        elif self.mesh.size("data") > 1:
            with self.allreduce_time.measure(self.device):
                dist.all_reduce(self.grads, self.mesh.group("data"))

    def _reduce_staged_grads(self) -> None:
        """``_reduce_grads`` under a pipe. Each range of the flat gradient
        sums over the ranks that hold it and saw other rows or another
        slice: the stage's uncut rows over the stage's ranks (``~pipe``),
        the stage unit's pieces (reduce-scattered over fsdp already) over
        the data group, the rest's pieces over ``~fsdp``, the replicated
        rest over every rank. Under ZeRO-1 the data axis's sum is the one
        reduce-scatter into the owned range instead, after the others'."""
        shard, g = self.shard, self.grads
        ranges = ((0, shard.stage_uncut_end, "~pipe"),
                  (shard.stage_uncut_end, shard.staged_end, "data"),
                  (shard.staged_end, shard.pieces, "~fsdp"),
                  (shard.pieces, shard.m, ""))
        with self.allreduce_time.measure(self.device):
            for lo, hi, key in ranges:
                if lo == hi:
                    continue
                if shard.zero1:
                    # the data axis is the reduce-scatter's
                    key = {"~pipe": "~pipe~data", "data": "",
                           "~fsdp": "~fsdp~data", "": "~data"}[key]
                    if key == "":
                        continue
                if key == "":
                    dist.all_reduce(g[lo:hi])
                else:
                    self._sum(g[lo:hi], key)
        if shard.zero1:
            with self.reduce_scatter_time.measure(self.device):
                dist.reduce_scatter(self._owned(g), g,
                                    self.mesh.group("data"))

    def forward_backward(self, batch: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
        """Gradients of the batch's loss into ``self.grads``, summed over the
        microbatches and then averaged (and summed over the ranks); returns
        the averaged metrics."""
        return self._forward_backward(self._micro(batch))

    def _forward_backward(self, mbs: List[Dict]) -> Dict[str, torch.Tensor]:
        self.grads.zero_()
        denoms = self._global_denoms(mbs)
        per_micro = []
        scale = 1.0 / self.n_micro
        fsdp = self.fsdp
        if fsdp is not None:
            fsdp.scale = scale
        with sequence_parallel(self.seq, self.shift_time), \
                pipe_parallel(self.pipe_ctx):
            for i, mb in enumerate(mbs):
                with (fsdp.rest() if fsdp is not None
                      else contextlib.nullcontext()), \
                        (fsdp.stage() if fsdp is not None
                         else contextlib.nullcontext()):
                    d = compute_losses(self.model, mb,
                                       self._rank_draws(self.step, i, mb),
                                       *denoms[i])
                    if self.pipe_ctx is None:
                        # under a pipe the schedule ran its backward
                        d["loss"].backward()
                if fsdp is not None:
                    fsdp.after_backward(scale)
                per_micro.append({k: v.detach() for k, v in d.items()})
        if fsdp is None:
            self.grads.mul_(scale)
        else:
            # the units' (and the stage unit's) pieces were scaled before
            # their reduce-scatters
            self.grads[:self.shard.stage_uncut_end].mul_(scale)
            self.grads[self.shard.pieces:].mul_(scale)
        if self.distributed:
            self._reduce_grads()
        return {k: v * scale
                for k, v in self._summed_metrics(per_micro).items()}

    def _grad_norm(self, grads: torch.Tensor) -> torch.Tensor:
        """The global L2 norm of the gradient this rank holds reduced
        (``grads``: its owned range). Unsharded, the norm of the whole
        buffer; sharded, the owned range's squares over the units' pieces
        and over the replicated leaves, summed over the ranks (one
        all-reduce) and each divided by its copies across the ranks: the
        same value up to the f32 sum order. Under ``--pipe`` the squares
        of each of ``_kinds``' ranges likewise."""
        shard = self.shard
        if shard.staged:
            # the owned range's squares by kind, summed over every rank,
            # each divided by the ranks that hold the same reduced values
            lo, kinds = shard.lo, self._kinds()
            sums = torch.stack([
                torch.linalg.vector_norm(grads[max(a - lo, 0):
                                               max(min(b, shard.hi) - lo,
                                                   0)]) ** 2
                for a, b, _c in kinds])
            dist.all_reduce(sums)
            return torch.sqrt(sum(sums[k] / kinds[k][2] for k in range(4)))
        if not shard.sharded:
            return torch.linalg.vector_norm(grads)
        lo, hi = shard.lo, shard.hi
        cut = min(max(shard.pieces - lo, 0), hi - lo)
        sums = torch.stack([torch.linalg.vector_norm(grads[:cut]) ** 2,
                            torch.linalg.vector_norm(grads[cut:]) ** 2])
        dist.all_reduce(sums)
        copies = 1 if shard.zero1 else self.mesh.size("data")
        return torch.sqrt(sums[0] / copies
                          + sums[1] / (copies * self.mesh.size("fsdp")))

    def _kinds(self) -> Tuple[Tuple[int, int, int], ...]:
        """The flat buffer's ranges by the ranks that hold the same
        reduced values, as ``(start, end, copies)``: the stage's uncut rows,
        the stage unit's pieces, the rest's pieces, the replicated rest
        (empty ranges where the layout has none); the data axis counts
        unless ZeRO-1 owns a data-th."""
        shard, mesh = self.shard, self.mesh
        d = 1 if shard.zero1 else mesh.size("data")
        return ((0, shard.stage_uncut_end, d * mesh.span("~pipe~data")),
                (shard.stage_uncut_end, shard.staged_end, d),
                (shard.staged_end, shard.pieces,
                 d * mesh.span("~fsdp~data")),
                (shard.pieces, shard.m, d * mesh.span("~data")))

    def update_share(self) -> Fraction:
        """The parameters the fused update covers on this rank, each kind
        divided by its copies over the ranks: summed over every rank, the
        model's parameter count."""
        shard = self.shard
        return sum((Fraction(shard.real_elements(max(a, shard.lo),
                                                 min(b, shard.hi)), c)
                    for a, b, c in self._kinds()), Fraction(0))

    @contextlib.contextmanager
    def _guard(self) -> Iterator[None]:
        """The sanitizer's guard: ``set_sync_debug_mode("error")`` on a
        GPU under ``sanitize``, a trip recorded and re-raised; nothing
        otherwise."""
        if not (self.sanitize and self.device.type == "cuda"):
            yield
            return
        with self.sanitize_report.watch():
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(prev)

    def _dispatch(self, mbs: List[Dict]) -> Dict[str, torch.Tensor]:
        """The step's device work: forward, backward, clip and update."""
        metrics = self._forward_backward(mbs)
        grads = self._owned(self.grads)
        gnorm = self._grad_norm(grads)
        if self.gradient_clipping > 0:
            grads.mul_(torch.clamp(
                self.gradient_clipping / (gnorm + 1e-6), max=1.0))
        scalars = update_scalars(self.count, self._lr_at)
        update = fused_adamw_ema if self.fused_update else torch_fused_update
        # one launch over the owned range (all of it unsharded)
        update(self._owned(self.params), grads, self.mu, self.nu, self.ema,
               scalars, self._rate_values, weight_decay=self.weight_decay)
        if self.shard.zero1:
            with self.all_gather_time.measure(self.device):
                dist.all_gather(self.params, self._owned(self.params),
                                self.mesh.group("data"))
        metrics["grad_norm"] = gnorm
        metrics["lr"] = self._lr_at(self.count)
        return metrics

    def run_step(self, batch: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        """One optimizer step. Returns the step's metrics as device scalars;
        they are fetched and logged ``dispatch_lag`` steps later."""
        if self.chaos is not None:
            # faults scheduled for the step about to run: self.step counts
            # the completed ones
            self.chaos.on_step(self)
        t0 = time.perf_counter()
        mbs = self._micro(batch)
        t1 = time.perf_counter()
        if self.prefetch_depth <= 0:
            self.stalls.add("h2d_wait_s", t1 - t0)
        with self._guard():
            metrics = self._dispatch(mbs)
        dispatched = time.perf_counter()
        self.stalls.add("dispatch_s", dispatched - t1)
        if self.debug_nans:
            self._check_finite(metrics)
        self.count += 1
        self.step += 1
        self._samples += self.global_batch
        self._timer.tick()
        self._book_step()
        self._inflight.append((self.step, dispatched, metrics))
        while len(self._inflight) > self.dispatch_lag:
            self._emit_lagged()
        self.logger.logkv("step", self.step)
        self.logger.logkv("samples", self._samples)
        return metrics

    def _stall_sum(self) -> float:
        s = self.stalls.sums()
        return s["data_wait_s"] + s["h2d_wait_s"]

    def _book_step(self) -> None:
        """The goodput step slice (previous step's end to this one's, the
        saves between them excluded): ``recompute_s`` up to
        ``recompute_until_step`` (less the compile and data-stall time
        inside it, booked to their own categories), the ``step`` span over
        the same seconds, and the beacon."""
        now = time.perf_counter()
        replay = self.step <= self.recompute_until_step
        if replay:
            booked = ((self.goodput.get("compile_s") - self._g_prev_compile)
                      + (self._stall_sum() - self._g_prev_stall))
            self.goodput.add("recompute_s",
                             max(0.0, (now - self._g_prev_t) - booked))
        if self.tracer.enabled:
            self.tracer.complete("step", "train", self._g_prev_wall,
                                 now - self._g_prev_t,
                                 args={"step": self.step,
                                       "recompute": replay})
        self._g_prev_t = now
        self._g_prev_wall = time.time()
        self._g_prev_stall = self._stall_sum()
        self._g_prev_compile = self.goodput.get("compile_s")
        if self.progress_file:
            self._write_beacon()

    def _check_finite(self, metrics: Dict[str, torch.Tensor]) -> None:
        """Raise ``FloatingPointError`` naming the step and the first
        non-finite tensor: the metrics in name order, then the gradients
        and the updated parameters in layout order. The torch analogue of
        the JAX entry point's ``jax_debug_nans``; one host sync a step."""
        step = self.step + 1
        for k in sorted(metrics):
            if not bool(torch.isfinite(metrics[k]).all()):
                raise FloatingPointError(
                    f"debug_nans: non-finite {k} at step {step}")
        # the gradient this rank holds reduced and its parameters; the
        # first non-finite element names its leaf
        shard = self.shard
        for what, flat, base in (("gradient", self._owned(self.grads),
                                  shard.lo),
                                 ("parameter", self.params[:shard.m], 0)):
            bad = torch.nonzero(~torch.isfinite(flat))
            if len(bad):
                name = shard.name_at_local(base + int(bad[0, 0]))
                raise FloatingPointError(
                    f"debug_nans: non-finite {what} {name} at step {step}")

    def _emit_lagged(self) -> None:
        """Fetch the oldest in-flight step's metrics (one device->host copy)
        and log them; the wait from its dispatch is ``device_step_s``."""
        step, dispatched, metrics = self._inflight.popleft()
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in keys]).tolist()
        self.stalls.add("device_step_s", time.perf_counter() - dispatched)
        row = dict(zip(keys, vals))
        self.logger.logkvs_mean(row)
        self.history.append({"step": step, **row})

    @property
    def logged_step(self) -> int:
        """The newest step whose metrics have been fetched and logged."""
        return self.step - len(self._inflight)

    def flush_metrics(self) -> None:
        """Fetch every in-flight step's metrics, and the all-reduce and
        ring-shift times recorded so far (waiting for each)."""
        while self._inflight:
            self._emit_lagged()
        for timer in self._timers():
            timer.drain()

    @torch.no_grad()
    def forward_only(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, float]:
        """Eval pass without gradients (global denominators and summed
        shares under a process group, as the step); metrics logged as
        ``eval_*``."""
        t0, t0_wall = time.perf_counter(), time.time()
        step = 0x7FFF0000 + self.step
        mbs = self._micro(batch)
        denoms = self._global_denoms(mbs)
        per_micro = []
        with sequence_parallel(self.seq, self.shift_time), \
                pipe_parallel(self.pipe_ctx):
            for i, mb in enumerate(mbs):
                with (self.fsdp.rest(grads=False) if self.fsdp is not None
                      else contextlib.nullcontext()), \
                        (self.fsdp.stage(grads=False)
                         if self.fsdp is not None
                         else contextlib.nullcontext()):
                    per_micro.append(compute_losses(
                        self.model, mb, self._rank_draws(step, i, mb),
                        *denoms[i]))
        sums = self._summed_metrics(per_micro)
        out = {f"eval_{k}": float(v) / self.n_micro for k, v in sums.items()}
        if self.tracer.enabled:
            self.tracer.complete("eval", "eval", t0_wall,
                                 time.perf_counter() - t0,
                                 args={"step": self.step})
        self.logger.logkvs_mean(out)
        return out

    @property
    def allreduce_s_per_step(self) -> float:
        """The all-reduce's seconds over the calls read so far (one a
        step; calls still in flight are not counted)."""
        return self.allreduce_time.seconds_per_call

    def _timers(self) -> Tuple[EventTimer, ...]:
        return (self.allreduce_time, self.reduce_scatter_time,
                self.all_gather_time, self.shift_time, self.pipe_time)

    def _per_step(self, timer: EventTimer) -> float:
        """A timer's seconds a step: the mean over the calls read so far,
        times the calls this process made, over the steps it ran."""
        return timer.seconds_per_call * timer.calls / max(self._timer.steps,
                                                          1)

    @property
    def reduce_scatter_s_per_step(self) -> float:
        """The reduce-scatters' seconds a step (ZeRO-1's one; under
        ``--fsdp`` each unit's, after every microbatch)."""
        return self._per_step(self.reduce_scatter_time)

    @property
    def all_gather_s_per_step(self) -> float:
        """The all-gathers' seconds a step (ZeRO-1's parameters; under
        ``--fsdp`` each unit's gathers)."""
        return self._per_step(self.all_gather_time)

    @property
    def ring_shift_s_per_step(self) -> float:
        """The ring's shift seconds (forward and backward, eval passes
        included) a step: the mean over the shifts read so far, times the
        shifts this process made, over the steps it ran."""
        return self._per_step(self.shift_time)

    @property
    def pipe_p2p_s_per_step(self) -> float:
        """The pipe exchange's seconds (every tick's frames, eval passes
        included) a step."""
        return self._per_step(self.pipe_time)

    # ---------------------------------------------------- goodput, beacon

    @property
    def recompile_count(self) -> int:
        """CUDA-graph captures of the loop: the training step captures
        none, so 0 by construction (the serving engines count theirs)."""
        return 0

    steady_recompile_count = recompile_count

    def goodput_summary(self) -> Dict[str, float]:
        """This attempt's wall (spawn to now under the launcher, else
        construction to now) split into useful / startup / setup / restore
        / compile / save / data stall / recompute."""
        return self.goodput.summary(extra={"data_stall_s": self._stall_sum()})

    def _write_json(self, path: str, payload: Dict[str, Any]) -> None:
        """Atomic replace; an OSError is logged, never raised (telemetry
        must not fail a step)."""
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps(payload))
            os.replace(tmp, path)
        except OSError as e:
            self.logger.info(f"warning: writing {path} failed: {e}")

    def _write_beacon(self) -> None:
        """Atomically replace this rank's progress beacon (the JAX keys):
        the launcher's liveness and progress probe, a killed attempt's
        flight recorder, the next attempt's recompute boundary."""
        t0 = time.perf_counter()
        self._write_json(self.progress_file, {
            "step": self.step,
            # the step THIS attempt restored from: progress is judged
            # against it (a walk-back restarts below the old maximum)
            "start_step": self.start_step,
            "t": time.time(),
            "attempt": int(os.environ.get("DPT_ATTEMPT") or 0),
            "rank": self.rank,
            "recompile_count": self.recompile_count,
            "steady_recompile_count": self.steady_recompile_count,
            "goodput": {k: round(v, 6)
                        for k, v in self.goodput_summary().items()}})
        self.beacon_s += time.perf_counter() - t0

    def _write_goodput_record(self) -> None:
        """Rank 0, at a clean exit: ``goodput_attempt{A:03d}.json`` beside
        the checkpoints, which ``aggregate_run`` prefers to the beacon."""
        if not self.checkpoint_dir or self.rank != 0:
            return
        attempt = int(os.environ.get("DPT_ATTEMPT") or 0)
        self._write_json(goodput_record_path(self.checkpoint_dir, attempt), {
            "attempt": attempt,
            "steps": [self.start_step, self.step],
            "recompile_count": self.recompile_count,
            "steady_recompile_count": self.steady_recompile_count,
            "compile_time_s": self.goodput.get("compile_s"),
            **{k: round(v, 6) for k, v in self.goodput_summary().items()}})

    def footprint(self) -> Dict[str, int]:
        """State bytes under the JAX gauges: the logical bytes of the
        params and of the optimizer state (``mu``, ``nu`` and the int32
        count), the bytes this rank holds of each (its flat parameter
        buffer; its owned range of ``mu``, ``nu`` and the EMA rows,
        padding included), and this process's peak device allocation (0
        on the CPU)."""
        n = self.n_params * 4
        own = self.shard.own * 4
        return {"params_bytes": n,
                "params_bytes_per_replica": self.params.numel() * 4,
                "opt_state_bytes": 2 * n + 4,
                "opt_state_bytes_per_replica": 2 * own + 4,
                "ema_bytes_per_replica": len(self.ema_rates) * own,
                "peak_live_bytes": peak_live_bytes(self.device)}

    # --------------------------------------------------------- cost ledger

    def _ledger_counts(self) -> Tuple[int, int, int, int]:
        return (self.step, flash_attention.forward_launch_count(),
                flash_attention.backward_launch_count(),
                dist.ring_shift_bytes())

    def _device_kind(self) -> str:
        return (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")

    def _train_row(self, steps_per_s: float, stall: Dict[str, float]
                   ) -> Dict[str, Any]:
        """The ``train_step`` ledger row over a log window: the census's
        FLOPs and bytes at the window's launches a step, the window's
        rate and stall means, folded by ``roofline_attribution``."""
        mark, self._ledger_mark = self._ledger_mark, self._ledger_counts()
        steps = max(self._ledger_mark[0] - mark[0], 1)
        fwd, bwd, shift = ((b - a) / steps
                           for a, b in zip(mark[1:], self._ledger_mark[1:]))
        tokens = self.census.tokens_per_step
        host_stall = (stall["data_wait_s"] + stall["h2d_wait_s"]
                      + stall["dispatch_s"])
        kind = self._device_kind()
        row: Dict[str, Any] = {
            "program": "train_step",
            **self.census.cost(fwd, bwd, shift),
            "tokens_per_step": tokens,
            "flops_per_token": self._flops_per_token,
            "analytic_flops_per_step": self._flops_per_token * tokens,
            "steps_per_s": steps_per_s,
            "tokens_per_s": steps_per_s * tokens,
            "device_step_s": stall["device_step_s"],
            "host_stall_s_per_step": host_stall,
            "data_stall_s_total": self._stall_sum()}
        row.update(ledger_lib.roofline_attribution(
            tokens_per_s=row["tokens_per_s"],
            flops_per_token=self._flops_per_token,
            peak_flops=ledger_lib.device_peak_flops(kind),
            n_devices=self.n_devices, steps_per_s=steps_per_s,
            collective_bytes_per_step=row["collective_bytes_per_step"],
            bytes_accessed=row["bytes_accessed"],
            host_stall_s_per_step=host_stall, device_kind=kind,
            padding_waste_frac=(self.padding.frac
                                if self.padding is not None else 0.0)))
        return row

    def _write_ledger(self) -> None:
        if self.rank != 0 or not self.checkpoint_dir or \
                self._ledger_row is None:
            return
        ledger_lib.write_ledger(
            self.checkpoint_dir, {"train_step": self._ledger_row},
            t=time.time(), extra={"step": self.logged_step,
                                  "n_devices": self.n_devices,
                                  "device_kind": self._device_kind()})

    # -------------------------------------------------------------- loop

    def _log_throughput(self) -> None:
        # the timed collectives' pairs that have completed; the rest wait
        # for a later window
        for timer in self._timers():
            timer.poll()
        for key, timer in (("allreduce_s_per_step", self.allreduce_time),
                           ("reduce_scatter_s_per_step",
                            self.reduce_scatter_time),
                           ("all_gather_s_per_step", self.all_gather_time),
                           ("ring_shift_s_per_step", self.shift_time),
                           ("pipe_p2p_s_per_step", self.pipe_time)):
            if timer.calls:
                self.logger.logkv(key, getattr(self, key))
        sps, tps = self._timer.lap()
        stall = self.stalls.lap()
        # the stall gauges' window means, the attempt's goodput so far and
        # the footprint ride every window, as in the JAX trainer
        self.logger.logkvs(stall)
        self.logger.logkv("goodput", self.goodput_summary()["goodput"])
        self.logger.logkvs(self.footprint())
        if self.cost_ledger:
            self._ledger_row = self._train_row(sps, stall)
            for gauge in ledger_lib.GAP_TERMS:
                self.logger.logkv(gauge, self._ledger_row[gauge])
            self.logger.logkv("collective_bytes_per_step",
                              self._ledger_row["collective_bytes_per_step"])
            self.logger.logkv("padding_waste_frac",
                              self._ledger_row["padding_waste_frac"])
            self._write_ledger()
        if tps <= 0:
            return
        # tokens of the global batch; per chip over the ring's distinct
        # devices (ranks sharing a card count it once)
        per_chip = tps / self.n_devices
        row = {"steps_per_sec": sps, "step_time_s": 1.0 / sps,
               "tokens_per_sec": tps, "tokens_per_sec_per_chip": per_chip}
        if self.device.type == "cuda":
            row["mfu"] = mfu(per_chip, self._flops_per_token,
                             self._device_kind())
        self.throughput = row
        self.logger.logkvs(row)

    def _maybe_profile(self, loop_step: int) -> None:
        """Open the ``torch.profiler`` window at its first loop step and
        close it (the trace written into ``profile_dir``) at its end;
        steps count from loop entry, so a resumed run still captures a
        window past its first steps."""
        start, stop = self._profile_window
        if loop_step == start and self._profiler is None:
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(
                activities=acts, on_trace_ready=tensorboard_trace_handler(
                    self.profile_dir, worker_name=f"rank{self.rank}"))
            self._profiler.start()
            self.logger.info(f"profiler: tracing steps {start}..{stop} -> "
                             f"{self.profile_dir}")
        elif loop_step == stop and self._profiler is not None:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        """Close the window: the device's queue drained into it first,
        then the trace written."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()

    def _write_sanitize_report(self) -> None:
        if not self.sanitize or not self.checkpoint_dir:
            return
        out = (self.checkpoint_dir if self.rank == 0 else
               os.path.join(self.checkpoint_dir, f"rank{self.rank:03d}"))
        self.sanitize_report.write(out)

    def run_loop(self) -> None:
        """Interval-driven outer loop: log (the rows fetched so far, the
        newest ``dispatch_lag`` steps left in flight), eval and save (in
        the background) at their intervals (<= 0 disables one), and a
        final save; then the wait for it, the last prune, the exit
        barrier, the attempt's goodput record, the ledger's last snapshot
        and the sanitizer's report. The profiler window is flushed, the
        save in flight waited for and the report written also when the
        loop raises."""
        loop_step = 0
        try:
            while self.learning_steps <= 0 or self.step < self.learning_steps:
                if self.profile_dir:
                    self._maybe_profile(loop_step)
                self.run_step(self.next_batch())
                loop_step += 1
                if self.log_interval > 0 and self.step % self.log_interval == 0:
                    self._log_throughput()
                    self.logger.dumpkvs()
                if (self.eval_data is not None and self.eval_interval > 0
                        and self.step % self.eval_interval == 0):
                    self.flush_metrics()
                    self.forward_only(next(self.eval_data))
                    self.eval_batches_consumed += 1
                    with self._guard(), self.full_weights():
                        for cb in self.eval_callbacks:
                            cb(self)
                if (self.save_interval > 0
                        and self.step % self.save_interval == 0):
                    self.save(wait=False)
        except BaseException:
            self._write_sanitize_report()
            raise
        finally:
            if self._profiler is not None:
                # the run ended (or raised) inside the window: flush it
                self._stop_profiler()
            try:
                self.flush_metrics()
            finally:
                # a process leaving mid-write would leave the step torn
                self.wait_for_saves()
        if self.save_interval <= 0 or self.step % self.save_interval != 0:
            self.save(wait=False)
        self.wait_for_saves()
        # the exit barrier: every rank leaves with rank 0's last save
        # durable
        dist.barrier("save_exit")
        summary = self.goodput_summary()
        self.logger.info("goodput: " + json.dumps(
            {k: round(v, 4) for k, v in summary.items()}))
        self._write_goodput_record()
        if self.cost_ledger:
            if self._ledger_row is None:
                self._ledger_row = self._train_row(0.0, self.stalls.lap())
            self._write_ledger()
        self.tracer.close()
        self._write_sanitize_report()

    __call__ = run_loop

    def save(self, wait: bool = True) -> None:
        """``model_/ema_{rate}_/opt_/meta_{step:06d}`` in the run dir,
        written and pruned by rank 0; then every rank passes a barrier.
        The save in flight, if any, is waited for first (and the run dir
        pruned); then the device-to-host copy, and the files on the
        saver's writer thread (``wait=False``, what the loop passes) or
        before return. The copy and scheduling are ``save_s`` (and a
        ``save`` span), taken out of the next step's slice; a chaos
        ``crash_in_save`` fires after the save is scheduled."""
        if not self.checkpoint_dir:
            self.logger.info("no checkpoint_dir configured; skipping save")
            return
        self.flush_metrics()
        self.wait_for_saves()
        t0, t0_wall = time.perf_counter(), time.time()
        if self.rank == 0 or self.shard.sharded:
            # a sharded state is gathered by every rank
            self._schedule_checkpoint()
        dist.barrier("save")
        dt = time.perf_counter() - t0
        self.save_times.append({"step": self.step, "copy_s": dt,
                                "wait_s": 0.0})
        self._book_save(dt, t0_wall, {"step": self.step, "async": not wait})
        if self.chaos is not None:
            self.chaos.on_save(self)
        if wait:
            self.wait_for_saves()

    def _book_save(self, dt: float, t0_wall: float,
                   args: Dict[str, Any]) -> None:
        """``dt`` seconds of saving: ``save_s``, a ``save`` span, and out of
        the next step's slice."""
        self.goodput.add("save_s", dt)
        self._g_prev_t += dt
        self._g_prev_wall += dt
        if self.tracer.enabled:
            self.tracer.complete("save", "ckpt", t0_wall, dt, args=args)

    def wait_for_saves(self) -> None:
        """Wait for the save in flight, if any, then prune the run dir
        (booked as ``save_s`` and a ``save`` span, as the JAX trainer books
        its wait); raises the writer's error."""
        if not self.saver.in_flight:
            return
        t0, t0_wall = time.perf_counter(), time.time()
        try:
            self.saver.wait()
            # the step just finalized may push an older one out
            self._prune()
        finally:
            dt = time.perf_counter() - t0
            last = self.save_times[-1]
            last["wait_s"] += dt
            self._book_save(dt, t0_wall, {"step": last["step"],
                                          "wait": True})

    def tear_save(self) -> bool:
        """``crash_in_save``'s hook: leave the save in flight torn (its
        payload written, its meta not); False when none is in flight."""
        return self.saver.tear()

    def _host_state(self, which: str, rate: str = "") -> Optional[StateDict]:
        """Rank 0's host copy of ``full_flat(which, rate)`` as a state dict
        (None on the other ranks, which take part in the gather)."""
        full = self.full_flat(which, rate)
        if self.rank != 0:
            return None
        return {k: v.to("cpu", copy=True)
                for k, v in self.state_dict_of(full).items()}

    def _schedule_checkpoint(self) -> None:
        """The step's full files (C.8) whatever the layout: unsharded,
        views the saver copies to the host; sharded, each state gathered
        and copied to rank 0's host one at a time (every rank gathers)."""
        if not self.shard.sharded:
            params = self.state_dict_of(self.params)
            ema = self.ema_state_dicts()
            mu, nu = self.state_dict_of(self.mu), self.state_dict_of(self.nu)
        else:
            params = self._host_state("params")
            ema = {r: self._host_state("ema", r) for r in self.ema_rates}
            mu, nu = self._host_state("mu"), self._host_state("nu")
        if self.rank != 0:
            return
        self.saver.save(
            self.checkpoint_dir, self.step, params, ema,
            {"mu": mu, "nu": nu, "count": int(self.count)},
            {"samples": self._samples, "batch_size": self.batch_size,
             "global_batch": self.global_batch,
             "eval_batches_consumed": self.eval_batches_consumed},
            copied=self.shard.sharded)
        self.logger.info(f"scheduled checkpoint save at step {self.step} "
                         f"-> {self.checkpoint_dir}")

    def _prune(self) -> None:
        """Rank 0: keep the newest ``keep_checkpoints`` finalized steps
        (a step in flight is neither counted nor touched)."""
        if (self.keep_checkpoints <= 0 or self.rank != 0
                or not self.checkpoint_dir):
            return
        pruned = ckpt.prune_checkpoints(self.checkpoint_dir,
                                        self.keep_checkpoints)
        if pruned:
            self.logger.info(f"pruned checkpoints at steps {pruned} "
                             f"(keep_checkpoints={self.keep_checkpoints})")
