"""TrainLoop: the port of ``distributed_pipeline_tpu/utils/trainer.py`` for
one GPU (or the CPU, when asked).

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
exit.

``run_loop`` logs every ``log_interval`` steps (the step's metrics plus
``steps_per_sec``, ``tokens_per_sec``, ``tokens_per_sec_per_chip``,
``step_time_s`` and, on a GPU, ``mfu``), evaluates every ``eval_interval``
(then runs each of ``eval_callbacks`` with the loop, as the JAX trainer
does), saves every ``save_interval`` and once more at the end, keeping the
newest ``keep_checkpoints`` steps when that is > 0. ``prefetch_depth`` > 0
feeds the step from ``data/device_prefetch.py`` (batches copied to the
device ahead of the step that reads them); ``debug_nans`` checks each
step's metrics, gradients and parameters on the host and raises
``FloatingPointError`` at the first non-finite one. Chaos, goodput, the
sanitizer, the cost ledger, profiling and meshes are later work (ROADMAP
A.8-A.10).
"""

from __future__ import annotations

import collections
import os
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence)

import numpy as np
import torch

from ..convert import init_params as random_params
from ..data.device_prefetch import prefetch_to_device
from ..models import Model, compute_losses
from ..models.diffuseq import Draws, seeded_generator
from ..ops.fused_update import (fused_adamw_ema, resolve_fused_update,
                                torch_fused_update, update_scalars)
from . import checkpoint as ckpt
from .logger import Logger
from .perf import StepTimer, mfu, transformer_train_flops_per_token

__all__ = ["TrainLoop"]

StateDict = Dict[str, torch.Tensor]


class TrainLoop:
    """``TrainLoop(model=..., data=..., ...)`` then ``run_loop()`` (or
    ``run_step(batch)`` step by step). ``model`` is a :class:`DiffuSeqModel`
    or :class:`GPT2Model` on the device to train on; its weights come from
    ``init_params`` (a state dict), else from ``convert.init_params`` at
    ``seed``, unless a checkpoint is resumed. ``draws(step, i)``, when
    given, returns microbatch i's DiffuSeq draws at ``step`` (a generator
    or ``{"t", "noise"}``) in place of the seeded generator."""

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
                 prefetch_depth: int = 0,
                 logger: Optional[Logger] = None) -> None:
        self.model = model
        self.keep_checkpoints = keep_checkpoints
        self.debug_nans = debug_nans
        self.prefetch_depth = prefetch_depth
        self.eval_data = eval_data
        self.eval_callbacks = tuple(eval_callbacks)
        self.seed = seed
        self._draws = draws or self._seeded_draws
        self.batch_size = batch_size
        self.microbatch = microbatch if microbatch > 0 else batch_size
        if batch_size % self.microbatch:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"microbatch {self.microbatch}")
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
        # per-step metrics as fetched (step, loss, grad_norm, lr, ...)
        self.history: List[Dict[str, float]] = []
        self._inflight: "collections.deque" = collections.deque()

        self.data = self._wrap_prefetch(data)
        self._build_state(init_params, seed)
        self.step = 0
        self.resumed_from = ""
        self.resume_meta: Optional[Dict[str, Any]] = None
        self._resume(resume_checkpoint)
        self._samples = self.step * batch_size
        self.n_params = self.params.numel()
        tokens_per_step = batch_size * model.seq_len
        self._timer = StepTimer(tokens_per_step)
        self._flops_per_token = transformer_train_flops_per_token(
            self.n_params, model.num_layers, model.hidden_size, model.seq_len)

    # ------------------------------------------------------------- state

    def _build_state(self, init_params, seed: int) -> None:
        """Flat buffers, parameters and gradients as views into them."""
        named = list(self.model.named_parameters())
        self._layout = {}
        off = 0
        for name, p in named:
            self._layout[name] = (off, p.numel(), tuple(p.shape))
            off += p.numel()
        dev, f32 = self.device, torch.float32
        self.params = torch.empty(off, dtype=f32, device=dev)
        self.grads = torch.zeros(off, dtype=f32, device=dev)
        self.mu = torch.zeros(off, dtype=f32, device=dev)
        self.nu = torch.zeros(off, dtype=f32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        if init_params is None:
            m = self.model
            init_params = random_params(dict(
                model_family=m.family, vocab_size=m.vocab_size,
                seq_len=m.seq_len, hidden_size=m.hidden_size,
                num_layers=m.num_layers, num_heads=m.num_heads), seed)
        self._load_flat(self.params, init_params)
        for name, p in named:
            p.data = self._view(self.params, name)
            p.grad = self._view(self.grads, name)
        # fresh EMA = a copy of the params, per rate
        self.ema = self.params[None].repeat(len(self.ema_rates), 1)

    def _view(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        off, n, shape = self._layout[name]
        return flat[off:off + n].view(shape)

    def state_dict_of(self, flat: torch.Tensor) -> StateDict:
        """A params-shaped state dict of views into a flat buffer."""
        return {name: self._view(flat, name) for name in self._layout}

    def _load_flat(self, flat: torch.Tensor,
                   state: Mapping[str, torch.Tensor]) -> None:
        missing = set(self._layout) ^ set(state)
        if missing:
            raise KeyError(f"state dict keys differ from the model's: "
                           f"{sorted(missing)[:5]}")
        with torch.no_grad():
            for name in self._layout:
                self._view(flat, name).copy_(state[name])

    def load_state(self, params: Mapping[str, torch.Tensor],
                   ema: Optional[Mapping[str, Mapping[str, torch.Tensor]]]
                   = None, opt: Optional[Mapping[str, Any]] = None) -> None:
        """Set the training state: params, EMA copies per rate (default: a
        copy of the params) and ``{"mu", "nu", "count"}`` (default: fresh)."""
        self._load_flat(self.params, params)
        for i, rate in enumerate(self.ema_rates):
            self._load_flat(self.ema[i], ema[rate] if ema else params)
        if opt is None:
            self.mu.zero_()
            self.nu.zero_()
            self.count.fill_(0)
        else:
            self._load_flat(self.mu, opt["mu"])
            self._load_flat(self.nu, opt["nu"])
            self.count.fill_(int(opt["count"]))

    def ema_state_dicts(self) -> Dict[str, StateDict]:
        return {r: self.state_dict_of(self.ema[i])
                for i, r in enumerate(self.ema_rates)}

    def _resume(self, resume_checkpoint: str) -> None:
        if resume_checkpoint:
            step = ckpt.parse_step_from_name(resume_checkpoint)
            if step is None:
                raise ValueError(f"resume_checkpoint must name a "
                                 f"model_NNNNNN.pt, got {resume_checkpoint!r}")
            run_dir = os.path.dirname(os.path.abspath(resume_checkpoint))
        elif self.checkpoint_dir:
            run_dir = self.checkpoint_dir
            step = ckpt.find_complete_step(run_dir, self.ema_rates)
        else:
            step = None
        if step is None:
            return
        state = ckpt.load_checkpoint(run_dir, step, self.ema_rates,
                                     self.device)
        self.load_state(state["params"], state["ema"], state["opt"])
        self.step = step
        self.resume_meta = state["meta"]
        self.resumed_from = run_dir
        self.logger.info(f"resumed from step {step} ({run_dir})")

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
        if data is None or self.prefetch_depth <= 0:
            return data
        return prefetch_to_device(data, self.device, self.prefetch_depth)

    # -------------------------------------------------------------- step

    def _lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """The reference's linear anneal ``lr * (1 - step/total)``, after a
        linear warmup from 0 over ``warmup_steps`` when set; f32, on the
        step's device."""
        lr = torch.tensor(self.lr, dtype=torch.float32, device=step.device)
        s = step.to(torch.float32)
        if self.learning_steps > 0:
            lr = lr * torch.clamp(1.0 - s / self.learning_steps, min=0.0)
        if self.warmup_steps > 0:
            lr = lr * torch.clamp((s + 1) / self.warmup_steps, max=1.0)
        return lr

    def _micro(self, batch: Mapping[str, Any]) -> List[Dict]:
        """Batch [B, ...] (numpy, or tensors from the prefetcher) ->
        microbatches of device tensors."""
        out = [{} for _ in range(self.n_micro)]
        for key, val in batch.items():
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.ascontiguousarray(val))
            t = val.to(self.device, non_blocking=True)
            for i, part in enumerate(t.reshape(
                    (self.n_micro, self.microbatch) + t.shape[1:])):
                out[i][key] = part
        return out

    def _seeded_draws(self, step: int, i: int) -> torch.Generator:
        return seeded_generator(self.device, self.seed, step, i)

    def forward_backward(self, batch: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
        """Gradients of the batch's loss into ``self.grads``, summed over the
        microbatches and then averaged; returns the averaged metrics."""
        self.grads.zero_()
        sums: Dict[str, torch.Tensor] = {}
        for i, mb in enumerate(self._micro(batch)):
            d = compute_losses(self.model, mb, self._draws(self.step, i))
            d["loss"].backward()
            for k, v in d.items():
                v = v.detach()
                sums[k] = v if k not in sums else sums[k] + v
        scale = 1.0 / self.n_micro
        self.grads.mul_(scale)
        return {k: v * scale for k, v in sums.items()}

    def run_step(self, batch: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        """One optimizer step. Returns the step's metrics as device scalars;
        they are fetched and logged ``dispatch_lag`` steps later."""
        metrics = self.forward_backward(batch)
        gnorm = torch.linalg.vector_norm(self.grads)
        if self.gradient_clipping > 0:
            self.grads.mul_(torch.clamp(
                self.gradient_clipping / (gnorm + 1e-6), max=1.0))
        scalars = update_scalars(self.count, self._lr_at)
        update = fused_adamw_ema if self.fused_update else torch_fused_update
        update(self.params, self.grads, self.mu, self.nu, self.ema, scalars,
               self._rate_values, weight_decay=self.weight_decay)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = self._lr_at(self.count)
        if self.debug_nans:
            self._check_finite(metrics)
        self.count += 1
        self.step += 1
        self._samples += self.batch_size
        self._timer.tick()
        self._inflight.append((self.step, metrics))
        while len(self._inflight) > self.dispatch_lag:
            self._emit_lagged()
        self.logger.logkv("step", self.step)
        self.logger.logkv("samples", self._samples)
        return metrics

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
        for what, flat in (("gradient", self.grads),
                           ("parameter", self.params)):
            if bool(torch.isfinite(flat).all()):
                continue
            for name in self._layout:
                if not bool(torch.isfinite(self._view(flat, name)).all()):
                    raise FloatingPointError(
                        f"debug_nans: non-finite {what} {name} at step "
                        f"{step}")

    def _emit_lagged(self) -> None:
        """Fetch the oldest in-flight step's metrics (one device->host copy)
        and log them."""
        step, metrics = self._inflight.popleft()
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in keys]).tolist()
        row = dict(zip(keys, vals))
        self.logger.logkvs_mean(row)
        self.history.append({"step": step, **row})

    def flush_metrics(self) -> None:
        """Fetch every in-flight step's metrics."""
        while self._inflight:
            self._emit_lagged()

    @torch.no_grad()
    def forward_only(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, float]:
        """Eval pass without gradients; metrics logged as ``eval_*``."""
        sums: Dict[str, torch.Tensor] = {}
        step = 0x7FFF0000 + self.step
        for i, mb in enumerate(self._micro(batch)):
            for k, v in compute_losses(self.model, mb,
                                       self._draws(step, i)).items():
                sums[k] = v if k not in sums else sums[k] + v
        out = {f"eval_{k}": float(v) / self.n_micro for k, v in sums.items()}
        self.logger.logkvs_mean(out)
        return out

    # -------------------------------------------------------------- loop

    def _log_throughput(self) -> None:
        sps, tps = self._timer.lap()
        if tps <= 0:
            return
        self.logger.logkv("steps_per_sec", sps)
        self.logger.logkv("step_time_s", 1.0 / sps)
        self.logger.logkv("tokens_per_sec", tps)
        self.logger.logkv("tokens_per_sec_per_chip", tps)  # one device
        if self.device.type == "cuda":
            self.logger.logkv("mfu", mfu(
                tps, self._flops_per_token,
                torch.cuda.get_device_name(self.device)))

    def run_loop(self) -> None:
        """Interval-driven outer loop: log, eval and save at their
        intervals (<= 0 disables one), and a final save."""
        try:
            while self.learning_steps <= 0 or self.step < self.learning_steps:
                self.run_step(next(self.data))
                if self.log_interval > 0 and self.step % self.log_interval == 0:
                    self.flush_metrics()
                    self._log_throughput()
                    self.logger.dumpkvs()
                if (self.eval_data is not None and self.eval_interval > 0
                        and self.step % self.eval_interval == 0):
                    self.flush_metrics()
                    self.forward_only(next(self.eval_data))
                    self.eval_batches_consumed += 1
                    for cb in self.eval_callbacks:
                        cb(self)
                if (self.save_interval > 0
                        and self.step % self.save_interval == 0):
                    self.save()
        finally:
            self.flush_metrics()
        if self.save_interval <= 0 or self.step % self.save_interval != 0:
            self.save()

    __call__ = run_loop

    def save(self) -> None:
        """``model_/ema_{rate}_/opt_/meta_{step:06d}`` in the run dir."""
        if not self.checkpoint_dir:
            self.logger.info("no checkpoint_dir configured; skipping save")
            return
        self.flush_metrics()
        ckpt.save_checkpoint(
            self.checkpoint_dir, self.step, self.state_dict_of(self.params),
            self.ema_state_dicts(),
            {"mu": self.state_dict_of(self.mu),
             "nu": self.state_dict_of(self.nu), "count": int(self.count)},
            {"samples": self._samples, "batch_size": self.batch_size,
             "eval_batches_consumed": self.eval_batches_consumed})
        self.logger.info(f"saved checkpoint at step {self.step} -> "
                         f"{self.checkpoint_dir}")
        if self.keep_checkpoints > 0:
            pruned = ckpt.prune_checkpoints(self.checkpoint_dir,
                                            self.keep_checkpoints)
            if pruned:
                self.logger.info(f"pruned checkpoints at steps {pruned} "
                                 f"(keep_checkpoints="
                                 f"{self.keep_checkpoints})")
