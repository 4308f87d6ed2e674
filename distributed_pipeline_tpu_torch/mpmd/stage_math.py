"""Per-stage model math for the MPMD pipeline: the port of
``distributed_pipeline_tpu/mpmd/stage_math.py``.

One :class:`StageMath` owns ONE stage's parameter slice, its forward and
backward over microbatch chunks, its own AdamW state, and (stage 0 only)
the data stream, all as tensors on an explicit device (no ``nn.Module``).
The decomposition is the JAX one, term for term:

* every stage builds the FULL initial state exactly as ``run.train``
  does (``convert.init_params`` at the run's seed), on the host, and
  keeps only its slice on the device: no parameter broadcast, the same
  init on every stage;
* microbatch chunk losses are SUMS over the FULL-batch denominator
  ``denom`` (computed on stage 0 and shipped in the act frames), so the
  chunk sum is the full-batch loss and the accumulated gradients are
  the full batch's;
* AdamW is elementwise, so the per-slice update is the full update
  restricted to the slice (optax's ``adamw`` op sequence at a constant
  learning rate, no EMA: the JAX stages run no schedule). The one
  cross-stage coupling is GPT-2's tied word embedding (lookup on stage
  0, logit head on the last stage): both hold a copy, their gradients
  sum through the driver (``shared_grads``/``apply``), and the same
  (gradient, moments) on both sides keep the copies equal;
* the first and middle stages stash only their inputs and recompute the
  stage under autograd in the B op; the last stage's F is a fused
  forward and backward, its grad frame waiting for the B op;
* DiffuSeq's ``t`` and noise are drawn per (seed, step, microbatch) from
  a ``torch.Generator`` seeded from those three, so a rewind replays the
  same draws; its tT and decoder-NLL terms, which need only the
  embedding, run on stage 0.

The embedding, the loss heads and the loss terms are the models' own
(``embed_tokens``, ``denoise_in``, ``embedding_terms``, and the SPMD
pipeline's ``gpt2_head``/``diffuseq_head``), called on a meta-built model
that holds this stage's parameters. A stage's layers run through
``models/pipeline.stage_apply``: at
``attention_impl auto`` a CUDA stage with L >= 1024 launches the flash
kernels (the JAX stages clamp ``auto`` to dense attention; ROADMAP
C.18a). Frames cross the wire as numpy (``pack_frame``): a bf16 tensor
travels as its ``uint16`` view under ``<key>@bf16``, bit for bit.

Also home to :func:`run_pipeline_inprocess`: the same math over
``MemStageLink``s in one process (the numerics reference of the
subprocess runtime).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import init_params, stack_blocks
from ..models import create_model_from_config
from ..models.diffuseq import (diffuseq_loss_count, embedding_terms,
                               seeded_generator)
from ..models.gpt2 import _targets, gpt2_loss_count
from ..models.pipeline import stage_apply
from ..models.schedule_1f1b import diffuseq_head, gpt2_head
from ..ops import flash_attention, fused_update
from ..utils.device import resolve_device
from .link import MemStageLink

__all__ = ["StageMath", "run_pipeline_inprocess", "stage_param_bounds",
           "stage_param_slice", "pack_frame", "unpack_frame"]

BLOCKS = "backbone.blocks."
BF16_SUFFIX = "@bf16"
# (step, microbatch, rows) -> {"t", "noise"}: DiffuSeq's draws handed in
DrawsFn = Callable[[int, int, int], Mapping[str, Any]]


def stage_param_bounds(num_layers: int, stage: int, n_stages: int
                       ) -> Tuple[int, int]:
    """Contiguous layer slice [lo, hi) for one stage: the floor-balanced
    split, so ``num_layers`` need not divide by the stage count."""
    return (stage * num_layers // n_stages,
            (stage + 1) * num_layers // n_stages)


def stage_param_slice(p: Mapping[str, torch.Tensor], family: str, lo: int,
                      hi: int, is_first: bool, is_last: bool
                      ) -> Dict[str, torch.Tensor]:
    """One stage's slice of a FULL stacked state dict (``convert``'s names):
    rows ``[lo, hi)`` of every block weight; GPT-2's stage 0 also holds
    ``word_emb`` and ``pos_emb`` and its last stage ``word_emb`` and
    ``ln_f``; DiffuSeq's stage 0 the embedding, ``in_proj``, the time MLP
    and ``pos_emb``, its last stage ``ln_f`` and ``out_proj``."""
    out = {k: v[lo:hi] for k, v in p.items() if k.startswith(BLOCKS)}
    keep: List[str] = []
    if family == "gpt2":
        if is_first:
            keep += ["word_emb.embedding", "pos_emb"]
        if is_last:
            keep += ["word_emb.embedding", "backbone.ln_f.scale",
                     "backbone.ln_f.bias"]
    else:
        if is_first:
            keep += ["word_emb.embedding", "in_proj.kernel", "in_proj.bias",
                     "time_mlp.layers_0.kernel", "time_mlp.layers_0.bias",
                     "time_mlp.layers_2.kernel", "time_mlp.layers_2.bias",
                     "pos_emb"]
        if is_last:
            keep += ["backbone.ln_f.scale", "backbone.ln_f.bias",
                     "out_proj.kernel", "out_proj.bias"]
    for k in keep:
        out[k] = p[k]
    return out


def pack_frame(values: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Tensors (any device) and arrays -> a link frame of numpy arrays; a
    bf16 tensor goes as its ``uint16`` view under ``key + "@bf16"``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.bfloat16:
                out[k + BF16_SUFFIX] = v.view(torch.int16).cpu().numpy() \
                    .view(np.uint16)
                continue
            v = v.cpu().numpy()
        out[k] = np.asarray(v)
    return out


def unpack_frame(arrays: Mapping[str, np.ndarray], device
                 ) -> Dict[str, torch.Tensor]:
    """A link frame -> tensors on ``device`` (``pack_frame``'s inverse,
    bit for bit)."""
    out: Dict[str, torch.Tensor] = {}
    for k, a in arrays.items():
        if k.endswith(BF16_SUFFIX):
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
                .view(torch.bfloat16)
            k = k[:-len(BF16_SUFFIX)]
        else:
            t = torch.from_numpy(np.array(a))
        out[k] = t.to(device)
    return out


def _chunk(arr, n_mb: int, mb: int):
    c = arr.shape[0] // n_mb
    return arr[mb * c:(mb + 1) * c]


class StageMath:
    """One stage's parameters, AdamW state and microbatch math (see the
    module doc) on the config's device (``""`` = CUDA). ``init_state`` (a
    full state dict, named or stacked blocks) replaces the from-seed init
    and ``draws`` DiffuSeq's seeded draws: the hooks the JAX-parity tests
    hand JAX's values in through."""

    def __init__(self, config: Dict[str, Any], stage: int, *,
                 init_state: Optional[Mapping[str, Any]] = None,
                 draws: Optional[DrawsFn] = None) -> None:
        self.config = config
        self.stage = int(stage)
        self.n_stages = int(config["n_stages"])
        self.is_first = self.stage == 0
        self.is_last = self.stage == self.n_stages - 1
        self.device = resolve_device(config.get("device", ""))
        model_kwargs = {k: v for k, v in dict(config["model"]).items()
                        if k != "device"}
        if not model_kwargs.get("scan_layers"):
            raise ValueError("MPMD stages slice the stacked layer dim: "
                             "model must be built with scan_layers=True")
        # the model's fields and methods; its parameters stay on no device
        # but this stage's slice, registered into it below
        model = create_model_from_config(**model_kwargs, device="meta")
        if model.moe_experts > 0:
            from ..config.train import MPMD_DENSE
            raise ValueError(MPMD_DENSE)
        self.model = model
        self.family = model.family
        self.dtype = model.dtype
        self.seq_len = model.seq_len
        self.schedule = getattr(model, "schedule", None)
        self.emb_dim = getattr(model, "emb_dim", 0)
        self.attention_impl = model.attention_impl
        self.remat = model.remat
        self.causal = self.family == "gpt2"
        self.tied = (self.family == "gpt2" and self.n_stages > 1
                     and self.stage in (0, self.n_stages - 1))
        self.shared_keys = ["word_emb.embedding"] if self.tied else []
        self.seed = int(config.get("seed", 0))
        self._draws = draws

        if init_state is None:
            init_state = init_params(dict(
                model_family=self.family, vocab_size=model.vocab_size,
                seq_len=model.seq_len, hidden_size=model.hidden_size,
                num_layers=model.num_layers, num_heads=model.num_heads,
                scan_layers=True), self.seed)
        elif BLOCKS + "qkv" not in init_state:
            init_state = stack_blocks(init_state)
        lo, hi = stage_param_bounds(model.num_layers, self.stage,
                                    self.n_stages)
        self.layers = (lo, hi)
        self.params = {
            k: nn.Parameter(torch.as_tensor(v).to(self.device, torch.float32)
                            .clone())
            for k, v in stage_param_slice(init_state, self.family, lo, hi,
                                          self.is_first,
                                          self.is_last).items()}
        del init_state
        for k, p in self.params.items():
            if not k.startswith(BLOCKS):  # the blocks go to stage_apply
                owner, _, name = k.rpartition(".")
                model.get_submodule(owner).register_parameter(name, p)
        # per-slice AdamW at a constant learning rate (the JAX stages run
        # optax.adamw(lr) with no schedule, and no EMA)
        self.lr = float(config.get("lr", 1e-3))
        self.weight_decay = float(config.get("weight_decay", 0.0))
        self.mu = {k: torch.zeros_like(v, requires_grad=False)
                   for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v, requires_grad=False)
                   for k, v in self.params.items()}
        self.count = torch.zeros((), dtype=torch.int32, device=self.device)

        # stage 0 regenerates batch t deterministically, across rewind
        # replays too, through the loader's skip_batches resume
        self._data_iter = None
        self._data_pos = -1
        self._ready: Optional[Tuple[int, Dict[str, np.ndarray]]] = None
        self._ctx: Dict[str, Any] = {}

    # ------------------------------------------------------------ the math
    def _dev(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))
        return a.to(self.device)

    def _stage(self, h: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
        blocks = {k[len(BLOCKS):]: v for k, v in self.params.items()
                  if k.startswith(BLOCKS)}
        return stage_apply(blocks, h, pad, dtype=self.dtype,
                           causal=self.causal,
                           attention_impl=self.attention_impl,
                           remat=self.remat)

    def _gpt2_first(self, b: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self._stage(self.model.embed_tokens(b["input_ids"]),
                           b["pad_mask"])

    def _diffuseq_first(self, b: Mapping[str, torch.Tensor], t, noise
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The stage output, x_start and the embedding-only loss terms
        (tT + decoder NLL over the full-batch denominator)."""
        model, ids = self.model, b["input_ids"]
        tm = b["input_mask"].float()
        x_start = model.embed(ids)
        x_noisy = self.schedule.q_sample(x_start, t, noise)
        # partial noising: the target span diffuses, the source anchors
        x_t = torch.where(tm[..., None] > 0, x_noisy, x_start)
        h = self._stage(model.denoise_in(x_t, t), b["pad_mask"])
        tT, dn = embedding_terms(model, x_start, ids, tm, b["denom"])
        return h, x_start, tT + dn

    def _draw(self, step: int, mb: int, rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Microbatch ``mb`` of step ``step``'s ``(t, noise)``: handed in,
        or drawn from a generator seeded from (seed, step, mb)."""
        if self._draws is not None:
            d = self._draws(step, mb, rows)
            return (self._dev(d["t"]),
                    self._dev(d["noise"]).to(torch.float32))
        g = seeded_generator(self.device, self.seed, step, mb)
        t = self.schedule.sample_t(g, rows)
        noise = torch.randn((rows, self.seq_len, self.emb_dim), generator=g,
                            device=self.device, dtype=torch.float32)
        return t, noise

    # ----------------------------------------------------------------- data
    def prefetch(self, step: int) -> None:
        """Make stage 0's batch of ``step`` ahead of the step: the loader's
        threads fill their queues first, holding the interpreter for
        seconds at GPT-2's width, which would otherwise fall into the
        first step's dispatch."""
        if self.is_first:
            self._ready = (step, self.batch_for_step(step))

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        """Batch consumed by optimizer step ``step`` (1-indexed): batch
        ``step - 1`` of the deterministic stream. Rebuilds the iterator
        with ``skip_batches`` on any non-sequential ask (restart, rewind
        replay): ``run.train``'s exact data-order resume."""
        if self._ready is not None and self._ready[0] == step:
            batch, self._ready = self._ready[1], None
            return batch
        want = step - 1
        if self._data_iter is None or self._data_pos != want:
            from ..data import load_data_from_args
            kw = dict(self.config.get("data", {}))
            self._data_iter = load_data_from_args(
                "train", batch_size=int(self.config["batch_size"]),
                skip_batches=want, shard=(0, 1), **kw)
            self._data_pos = want
        batch = next(self._data_iter)
        self._data_pos += 1
        return batch

    # ------------------------------------------------------------- step state
    def start_step(self, step: int, n_mb: int) -> None:
        ctx: Dict[str, Any] = {"step": step, "n_mb": n_mb, "stash": {},
                               "loss": 0.0, "acc": 0.0, "grad_out": {}}
        if self.is_first:
            batch = {k: torch.from_numpy(np.asarray(v))
                     for k, v in self.batch_for_step(step).items()
                     if k in ("input_ids", "input_mask", "pad_mask")}
            count = (gpt2_loss_count if self.family == "gpt2"
                     else diffuseq_loss_count)(batch)
            ctx["batch"] = batch   # on the host: the act frames carry it
            ctx["denom"] = torch.clamp(count, min=1.0)
        for p in self.params.values():
            p.grad = None
        self._ctx = ctx

    # ------------------------------------------------------------- microbatch
    def forward_mb(self, mb: int,
                   inbound: Optional[Mapping[str, np.ndarray]]
                   ) -> Optional[Dict[str, np.ndarray]]:
        """Run this stage's F op for microbatch ``mb``. Returns the act
        frame for the next stage, or None on the last stage (whose F is
        the fused forward and backward: the grad frame waits for its B
        op)."""
        ctx = self._ctx
        n_mb = ctx["n_mb"]
        if self.is_first:
            if self.is_last:
                raise AssertionError("n_stages == 1 is not MPMD")
            b = {k: _chunk(v, n_mb, mb) for k, v in ctx["batch"].items()}
            b["denom"] = ctx["denom"]
            d = {k: self._dev(v) for k, v in b.items()}
            with torch.no_grad():
                if self.family == "gpt2":
                    ctx["stash"][mb] = (d,)
                    return pack_frame({"h": self._gpt2_first(d), **b})
                t, noise = self._draw(ctx["step"], mb,
                                      d["input_ids"].shape[0])
                h, x_start, local = self._diffuseq_first(d, t, noise)
            ctx["stash"][mb] = (d, t, noise)
            ctx["loss"] += float(local)
            del b["input_ids"]
            return pack_frame({"h": h, "x_start": x_start, **b})
        if inbound is None:
            raise AssertionError("non-first stage F needs an act frame")
        x = unpack_frame(inbound, self.device)
        if not self.is_last:
            with torch.no_grad():
                h_out = self._stage(x["h"], x["pad_mask"])
            ctx["stash"][mb] = (x["h"], x["pad_mask"])
            out = dict(inbound)
            out.pop("h" + BF16_SUFFIX, None)
            out.pop("h", None)
            out.update(pack_frame({"h": h_out}))
            return out
        # the last stage: forward and backward at its F slot (1F1B's last
        # stage runs B at once; the grad frame waits for the B op)
        h = x["h"].requires_grad_()
        inv = 1.0 / x["denom"]
        if self.family == "gpt2":
            targets, lm = _targets(x)
            with torch.enable_grad():
                loss, acc = gpt2_head(self.model,
                                      self._stage(h, x["pad_mask"]),
                                      targets, lm, inv)
                loss.backward()
            ctx["acc"] += float(acc)
            ctx["grad_out"][mb] = pack_frame({"dh": h.grad})
        else:
            xs = x["x_start"].requires_grad_()
            with torch.enable_grad():
                loss = diffuseq_head(self.model,
                                     self._stage(h, x["pad_mask"]), xs,
                                     x["input_mask"].float(), inv)
                loss.backward()
            ctx["grad_out"][mb] = pack_frame({"dh": h.grad, "dxs": xs.grad})
        ctx["loss"] += float(loss.detach())
        return None

    def backward_mb(self, mb: int,
                    inbound: Optional[Mapping[str, np.ndarray]]
                    ) -> Optional[Dict[str, np.ndarray]]:
        """Run this stage's B op. Returns the grad frame for the previous
        stage, or None on the first stage (the end of the chain)."""
        ctx = self._ctx
        if self.is_last:
            return ctx["grad_out"].pop(mb)
        if inbound is None:
            raise AssertionError("non-last stage B needs a grad frame")
        g = unpack_frame(inbound, self.device)
        stash = ctx["stash"].pop(mb)
        if self.is_first:
            with torch.enable_grad():
                if self.family == "gpt2":
                    torch.autograd.backward(self._gpt2_first(*stash),
                                            g["dh"])
                else:
                    h, x_start, local = self._diffuseq_first(*stash)
                    torch.autograd.backward([h, x_start, local],
                                            [g["dh"], g["dxs"], None])
            return None
        h_in, pad = stash
        h_in = h_in.requires_grad_()
        with torch.enable_grad():
            torch.autograd.backward(self._stage(h_in, pad), g["dh"])
        out = dict(inbound)
        out.pop("dh" + BF16_SUFFIX, None)
        out.pop("dh", None)
        out.update(pack_frame({"dh": h_in.grad}))
        return out

    # ----------------------------------------------------------------- apply
    def shared_grads(self) -> Optional[Dict[str, np.ndarray]]:
        """This stage's partial gradients of the driver-summed shared
        parameters (GPT-2's tied word embedding), or None when it shares
        nothing."""
        if not self.shared_keys:
            return None
        return pack_frame({k: self.params[k].grad for k in self.shared_keys})

    def apply(self, shared_sum: Optional[Mapping[str, np.ndarray]] = None
              ) -> Dict[str, float]:
        """Fold the driver-summed shared gradients in, run AdamW, return
        this stage's done payload (loss partial and metric partials)."""
        grads = {k: (p.grad if p.grad is not None
                     else torch.zeros_like(p, requires_grad=False))
                 for k, p in self.params.items()}
        if shared_sum:
            grads.update(unpack_frame(shared_sum, self.device))
        self._adamw(grads)
        for p in self.params.values():
            p.grad = None
        out = {"loss_partial": float(self._ctx["loss"])}
        if self.family == "gpt2" and self.is_last:
            out["acc"] = float(self._ctx["acc"])
        self._ctx = {}
        return out

    @torch.no_grad()
    def _adamw(self, grads: Mapping[str, torch.Tensor]) -> None:
        """optax.adamw over each leaf (``fused_update.adamw_step``, the
        plain arm's AdamW without the EMA) at the constant rate."""
        lr = self.lr
        scalars = fused_update.update_scalars(
            self.count, lambda c: torch.full((), lr, dtype=torch.float32,
                                             device=c.device))
        # optax.adamw's b1, b2 and eps (the functions' defaults)
        for k, p in self.params.items():
            fused_update.adamw_step(p, grads[k], self.mu[k], self.nu[k],
                                    scalars, weight_decay=self.weight_decay)
        self.count += 1

    # -------------------------------------------------------------- snapshot
    def export_flat(self) -> Dict[str, np.ndarray]:
        flat = {}
        for k, p in self.params.items():
            flat[f"param/{k}"] = p.detach().cpu().numpy()
            flat[f"opt/mu/{k}"] = self.mu[k].cpu().numpy()
            flat[f"opt/nu/{k}"] = self.nu[k].cpu().numpy()
        flat["opt/count"] = self.count.cpu().numpy()
        return flat

    @torch.no_grad()
    def load_flat(self, flat: Mapping[str, np.ndarray]) -> None:
        for k, p in self.params.items():
            p.copy_(torch.from_numpy(np.asarray(flat[f"param/{k}"])))
            self.mu[k].copy_(torch.from_numpy(np.asarray(flat[f"opt/mu/{k}"])))
            self.nu[k].copy_(torch.from_numpy(np.asarray(flat[f"opt/nu/{k}"])))
        self.count.fill_(int(np.asarray(flat["opt/count"])))

    # ----------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """The process's kernel launches and plain calls (every launch in a
        stage process is this stage's), its peak device memory, its layer
        slice and device: the worker's sidecar reads them."""
        return {
            "device": str(self.device), "layers": list(self.layers),
            "launches": {
                "flash_forward": flash_attention.forward_launch_count(),
                "flash_backward": flash_attention.backward_launch_count(),
                "fused_adamw_ema": fused_update.launch_count()},
            "plain_calls": {**{f"flash_{k}": v for k, v in
                               flash_attention.plain_call_counts().items()},
                            "fused_adamw_ema":
                                fused_update.plain_call_count()},
            "peak_memory_bytes": (
                torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)}


def run_pipeline_inprocess(config: Dict[str, Any], n_steps: int, *,
                           maths: Optional[List[StageMath]] = None,
                           init_state: Optional[Mapping[str, Any]] = None,
                           draws: Optional[DrawsFn] = None
                           ) -> Dict[str, Any]:
    """All stages in one process over ``MemStageLink``s: the numerics
    reference for the subprocess runtime (the same ``StageMath``, the same
    frames, GPipe-ordered: schedule order never changes the math). Pass
    ``maths`` to continue training existing stages; ``init_state`` and
    ``draws`` go to each new ``StageMath``."""
    S = int(config["n_stages"])
    M = int(config.get("n_microbatches", 1))
    if maths is None:
        maths = [StageMath(config, s, init_state=init_state, draws=draws)
                 for s in range(S)]
    acts = [MemStageLink(capacity=M + 2) for _ in range(S - 1)]
    grads = [MemStageLink(capacity=M + 2) for _ in range(S - 1)]
    start = getattr(maths[0], "_done_steps", 0)
    losses: List[float] = []
    metrics: List[Dict[str, float]] = []
    for step in range(start + 1, start + n_steps + 1):
        for m in maths:
            m.start_step(step, M)
        for mb in range(M):
            for s in range(S):
                inb = None
                if s > 0:
                    frame = acts[s - 1].recv()
                    assert frame is not None
                    inb = frame[0]
                out = maths[s].forward_mb(mb, inb)
                if s < S - 1:
                    acts[s].send(out, {"step": step, "mb": mb})
        for mb in range(M):
            for s in range(S - 1, -1, -1):
                inb = None
                if s < S - 1:
                    frame = grads[s].recv()
                    assert frame is not None
                    inb = frame[0]
                out = maths[s].backward_mb(mb, inb)
                if s > 0:
                    grads[s - 1].send(out, {"step": step, "mb": mb})
        shared_sum: Optional[Dict[str, np.ndarray]] = None
        for m in maths:
            part = m.shared_grads()
            if part is not None:
                shared_sum = (part if shared_sum is None else
                              {k: shared_sum[k] + part[k] for k in part})
        dones = [m.apply(shared_sum if m.shared_keys else None)
                 for m in maths]
        loss = sum(d["loss_partial"] for d in dones)
        losses.append(loss)
        step_metrics = {"loss": loss}
        for d in dones:
            for k, v in d.items():
                if k != "loss_partial":
                    step_metrics[k] = v
        metrics.append(step_metrics)
    for m in maths:
        m._done_steps = start + n_steps
    return {"losses": losses, "metrics": metrics, "maths": maths}
