"""The 1F1B and interleaved pipeline schedules: the port of
``distributed_pipeline_tpu/models/schedule_1f1b.py``.

A pipe rank runs ticks. At tick ``t`` stage ``s`` runs one **F slot**
(forward chunk ``cf`` through virtual slice ``jf`` of its rows, stashing
the slot's INPUT; stage 0 embeds the chunk first, and the last virtual
stage runs the loss head on its output at once, whose backward seeds the
cotangent stream) and one **B slot** (chunk ``cb`` through slice ``jb``:
the stage forward recomputed from the stashed input with gradients on,
its backward given the cotangent, the weight gradients accumulated into
``.grad``, the input cotangent handed back; stage 0 then backprops
through the embedding). Which chunk and slice each slot takes is the JAX
closed form :func:`_slot_indices`, in integers; at V = 1 it is the plain
1F1B schedule (``cf = t - s``, ``cb = t - 2(S-1) + s``), at V > 1
Megatron's interleaved schedule over the V slices a rank holds (virtual
stage ``j*S + s`` on rank s: ``models/pipeline.stage_layers``, a static
assignment of the stacked rows, so no weight permute a step).

After each tick's slots the rank posts the tick's frames in one
``dist.pipe_exchange``: the forward activation to the next stage and the
cotangent to the stage before (cyclic under the interleaved schedule),
and the receives its next tick's slots read. Both sides decide from
``_slot_indices`` which slots carry a frame; the bubble slots the JAX
lockstep fills with masked garbage send nothing here and compute nothing.
The ticks are the JAX ones: ``M*V + S*V + S - 2`` (``M + 2(S-1)`` at
V = 1).

The memory contract is the JAX one: the stash holds stage inputs only, at
most ``stash_size(M, S, V)`` chunks a slice, and every B slot recomputes
its stage forward (so the flash forward runs twice a chunk-layer on this
path). A call without gradients takes the forward-only stream
(``_forward_body``, ``M*V + S - 1`` ticks of F slots and the head): eval
under a pipe pays no backward, and its loss sums the chunks in the same
order. The GPipe schedule (``models/pipeline.gpipe_stream``) takes the
same family glue.

The family glue restates each family's embedding and loss head over one
microbatch's chunks: :func:`gpt2_1f1b_losses` (the tied embedding is used
by stage 0's embedding and the last stage's head: its gradient is the sum
over the pipe group, which the trainer takes) and
:func:`diffuseq_1f1b_losses` (the mse term runs through the stages; x_t
and x_start enter as leaves whose cotangents flow back into the
embedding; tT and the decoder NLL, which need only the embedding, run on
stage 0). Each returns this rank's shares of the family's metrics: the
last stage's loss terms, stage 0's embedding-only terms, zeros
elsewhere, so the shares summed over the ranks are the global values.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..ops.xent import token_cross_entropy
from ..parallel.ring import current_sequence
from .moe import MOE_AUX_WEIGHT, GlobalMoEStats, MoEStats, moe_aux
from .pipeline import (PipeContext, StageFns, _add, current_pipe,
                       gpipe_stream)

__all__ = ["stash_size", "pipelined_loss", "gpt2_1f1b_losses",
           "diffuseq_1f1b_losses", "gpt2_head", "diffuseq_head",
           "check_pipe_layout", "SCHEDULES"]

SCHEDULES = ("1f1b", "gpipe", "interleaved")
# the tags of a tick's two frames
_TAG_F, _TAG_B = 0, 1


def stash_size(M: int, S: int, V: int = 1) -> int:
    """Stage-input stash slots a virtual slice needs: ``min(M, 2S-1)``
    for plain 1F1B (stage 0's forward-to-backward distance is 2(S-1)
    chunks, plus the chunk entering this tick), ``min(M, 3S)`` a slice
    under the interleaved schedule (V > 1)."""
    if V <= 1:
        return min(M, 2 * S - 1)
    return min(M, 3 * S)


def _slot_indices(t: int, sid: int, S: int, M: int, V: int
                  ) -> Tuple[int, int, bool, int, int, bool]:
    """The JAX closed-form slot schedule at tick ``t`` on stage ``sid``:
    ``(jf, cf, vf, jb, cb, vb)``, the F slot's virtual slice, chunk and
    validity and the B slot's. Chunk c's F reaches virtual stage
    ``k = j*S + s`` at tick ``s + (c//S)*SV + j*S + c%S``; its B mirrors
    at ``u_f(SV-1, c) + (SV-1-k)``, one virtual stage a tick. Python's
    ``//`` and ``%`` floor as ``jnp``'s do."""
    SV = S * V
    xf = t - sid
    qf = xf % SV
    jf = qf // S
    cf = (xf // SV) * S + qf % S
    vf = xf >= 0 and 0 <= cf < M
    y0 = t + sid + 2 - 2 * SV
    z = y0 % SV
    jb = (-(z // S)) % V
    y = y0 + jb * S
    cb = (y // SV) * S + y % SV
    vb = y >= 0 and 0 <= cb < M
    return jf, cf, vf, jb, cb, vb


def _receives(t: int, sid: int, S: int, M: int, V: int, T: int
              ) -> Tuple[bool, bool]:
    """Whether stage ``sid``'s slots at tick ``t`` read a frame: the F
    slot unless it is virtual stage 0 (which embeds), the B slot unless it
    is the last virtual stage (whose cotangent is its own head's)."""
    if t >= T:
        return False, False
    jf, _cf, vf, jb, _cb, vb = _slot_indices(t, sid, S, M, V)
    return (vf and not (sid == 0 and jf == 0),
            vb and not (sid == S - 1 and jb == V - 1))


def _check_chunks(B: int, M: int, S: int, V: int) -> int:
    """The chunk rows, with the JAX divisibility errors."""
    if V > 1 and M % S:
        raise ValueError(
            f"interleaved 1F1B groups chunks in bursts of S: pp_chunks "
            f"{M} must divide by the pipe axis {S}")
    if B % M:
        raise ValueError(f"per-shard batch {B} not divisible by pp_chunks "
                         f"{M}")
    return B // M


def _forward_body(ctx: PipeContext, fns: StageFns
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The forward-only stream (F slots and the head, no stash, no
    backward): ``M*V + S - 1`` ticks."""
    S, sid, M, V = ctx.size, ctx.index, ctx.chunks, ctx.virtual
    T = M * V + S - 1
    dev = fns.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    metrics: Dict[str, torch.Tensor] = {}
    recv_f = None
    for t in range(T):
        jf, cf, vf, *_ = _slot_indices(t, sid, S, M, V)
        send = []
        if vf:
            ctx.f_slots += 1
            h_in = fns.pre(cf) if (sid == 0 and jf == 0) else recv_f
            h_out = fns.stage(jf, h_in, fns.mask(cf))
            if sid == S - 1 and jf == V - 1:
                lc, mc = fns.head(h_out, cf)
                loss = loss + lc
                _add(metrics, mc)
            else:
                send = [(h_out, 1, _TAG_F)]
        nf, _nb = _receives(t + 1, sid, S, M, V, T)
        got = ctx.exchange(send, [(fns.shape, fns.dtype, -1, _TAG_F)]
                           if nf else [], dev)
        recv_f = got[0] if nf else None
    if fns.aux is not None:
        _add(metrics, fns.aux()[1])
    return loss, metrics


def _schedule_body(ctx: PipeContext, fns: StageFns
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The combined F+B ticks (module doc); gradients accumulate into
    ``.grad``. Returns this rank's loss contribution and metrics."""
    S, sid, M, V = ctx.size, ctx.index, ctx.chunks, ctx.virtual
    K = stash_size(M, S, V)
    T = M * V + S * V + S - 2
    dev = fns.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    metrics: Dict[str, torch.Tensor] = {}
    stash: Dict[Tuple[int, int], torch.Tensor] = {}
    recv_f = recv_b = None
    for t in range(T):
        jf, cf, vf, jb, cb, vb = _slot_indices(t, sid, S, M, V)
        send = []
        d_h_out = None
        # ---- F slot: forward chunk cf through slice jf, its input kept
        if vf:
            ctx.f_slots += 1
            with torch.no_grad():
                h_in = (fns.pre(cf) if (sid == 0 and jf == 0)
                        else recv_f)
                h_out = fns.stage(jf, h_in, fns.mask(cf))
            stash[(jf, cf)] = h_in
            in_slice = sum(1 for j, _c in stash if j == jf)
            if in_slice > K:
                raise RuntimeError(f"1F1B stash holds {in_slice} inputs of "
                                   f"slice {jf}, over stash_size {K}")
            ctx.stash_peak = max(ctx.stash_peak, len(stash))
            if sid == S - 1 and jf == V - 1:
                # the loss head on the last virtual stage's output: its
                # backward seeds this tick's B slot (the same chunk)
                h_leaf = h_out.detach().requires_grad_()
                lc, mc = fns.head(h_leaf, cf)
                lc.backward()
                d_h_out = h_leaf.grad
                loss = loss + lc.detach()
                _add(metrics, mc)
            else:
                send.append((h_out, 1, _TAG_F))
        # ---- B slot: recompute chunk cb through slice jb from its stashed
        # input, backward with the arriving cotangent
        if vb:
            ctx.b_slots += 1
            kb_last = sid == S - 1 and jb == V - 1
            if kb_last and d_h_out is None:
                raise RuntimeError(f"tick {t}: the last stage's B slot "
                                   f"(chunk {cb}) has no head cotangent")
            cot = d_h_out if kb_last else recv_b
            h_in_b = stash.pop((jb, cb)).detach().requires_grad_()
            h = fns.stage(jb, h_in_b, fns.mask(cb))
            torch.autograd.backward(h, cot)
            d_h_in = h_in_b.grad
            if sid == 0 and jb == 0:
                torch.autograd.backward(fns.pre(cb), d_h_in)
            else:
                send.append((d_h_in, -1, _TAG_B))
        nf, nb = _receives(t + 1, sid, S, M, V, T)
        recvs = []
        if nf:
            recvs.append((fns.shape, fns.dtype, -1, _TAG_F))
        if nb:
            recvs.append((fns.shape, fns.dtype, 1, _TAG_B))
        got = ctx.exchange(send, recvs, dev)
        recv_f = got.pop(0) if nf else None
        recv_b = got.pop(0) if nb else None
    if stash:
        raise RuntimeError(f"1F1B ended with {len(stash)} stashed inputs")
    return loss, metrics


def pipelined_loss(ctx: PipeContext, fns: StageFns
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One microbatch through ``ctx``'s schedule: with gradients on, the
    GPipe stream or the F+B ticks (the gradients accumulate into
    ``.grad``); without, the forward-only stream. Returns this rank's
    loss contribution and metrics (detached; the last stage's chunk sums,
    zeros elsewhere)."""
    if not torch.is_grad_enabled():
        return _forward_body(ctx, fns)
    if ctx.schedule == "gpipe" or gpipe_only(fns):
        return gpipe_stream(ctx, fns)
    return _schedule_body(ctx, fns)


def gpipe_only(fns: StageFns) -> bool:
    """Whether a training request of any schedule takes the GPipe stream:
    an MoE stage (its aux needs the groups' sums over every chunk) or a
    ring inside the stage, as the JAX family losses route them (its 1F1B
    engine has no MoE or sequence stage path)."""
    seq = current_sequence()
    return fns.aux is not None or (seq is not None and seq.size > 1)


def check_pipe_layout(model, ctx: PipeContext) -> None:
    """The model can run ``ctx``'s schedule: stacked weights, and its rows
    a multiple of V (``models/pipeline.stage_layers`` checks the layers
    against S x V); an MoE model or a sequence ring runs one slice a rank
    (the GPipe stream)."""
    if not model.scan_layers:
        raise ValueError("--pipe > 1 requires --scan_layers true")
    blocks = model.backbone.blocks
    seq = current_sequence()
    if ctx.virtual > 1 and (model.moe_experts > 0
                            or (seq is not None and seq.size > 1)):
        raise ValueError("MoE and ring-in-stage pipes take the GPipe "
                         "stream: pp_virtual must be 1")
    rows = next(iter(blocks.stacked().values())).shape[0]
    if rows % ctx.virtual:
        raise ValueError(f"a stage's {rows} layers do not split into "
                         f"pp_virtual {ctx.virtual} slices")


def _stage_fn(model, ctx: PipeContext,
              stats: Optional[List[List[MoEStats]]] = None):
    """The stage function of ``StageFns``: virtual slice j of the rank's
    rows; an MoE stage appends each chunk's group sums to ``stats``."""
    blocks = model.backbone.blocks
    if model.moe_experts > 0:
        def moe_stage(j: int, h: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
            h, st = blocks.apply_rows(blocks.stacked(), h, mask)
            stats.append(st)
            return h
        return moe_stage
    per = blocks.qkv.shape[0] // ctx.virtual

    def stage(j: int, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return blocks.apply_rows(blocks.virtual_slice(ctx.virtual, j), h,
                                 mask, row0=j * per)
    return stage


def _moe_aux_fn(model, stats: List[List[MoEStats]],
                moe_global: Optional[GlobalMoEStats]):
    """``StageFns.aux`` of an MoE stage: its groups' raw sums over every
    chunk of the microbatch, the counts made global (``moe_global``: the
    ranks of this stage), formed into this rank's aux share (the JAX
    ``_moe_schedule``: the pipe ranks' shares sum to the aux)."""
    def aux():
        groups = [tuple(sum(c[g][i] for c in stats) for i in range(3))
                  for g in range(len(stats[0]))]
        share = moe_aux(groups, model.moe_experts, moe_global)
        return MOE_AUX_WEIGHT * share, {"moe_aux": share}
    return aux if model.moe_experts > 0 else None


def gpt2_head(model, h: torch.Tensor, targets: torch.Tensor,
              loss_mask: torch.Tensor, inv: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GPT-2's loss head over one chunk at the last stage: ``ln_f``, the
    tied LM head and the next-token CE of the stage output ``h``, as
    ``(loss share, acc share)``, each ``(sum over the chunk) * inv``
    (the acc share detached)."""
    logits = model.lm_head(model.backbone.ln_f(h).to(model.dtype))
    logits = logits[:, :targets.shape[1]]
    nll = token_cross_entropy(logits, targets)
    hit = (torch.argmax(logits, dim=-1) == targets).float()
    acc = (hit * loss_mask).sum().detach() * inv
    return (nll * loss_mask).sum() * inv, acc


def diffuseq_head(model, h: torch.Tensor, x_start: torch.Tensor,
                  tgt_mask: torch.Tensor, inv: torch.Tensor
                  ) -> torch.Tensor:
    """DiffuSeq's mse term over one chunk at the last stage: ``ln_f`` and
    ``denoise_out`` of the stage output ``h`` against ``x_start``, the
    chunk's sum over the target span times ``inv``."""
    x0_hat = model.denoise_out(model.backbone.ln_f(h).to(model.dtype))
    per = torch.mean((x0_hat - x_start) ** 2, dim=-1)
    return (per * tgt_mask).sum() * inv


def gpt2_1f1b_losses(model, batch: Dict[str, torch.Tensor],
                     denom: Optional[torch.Tensor] = None,
                     ctx: Optional[PipeContext] = None,
                     moe_global: Optional[GlobalMoEStats] = None
                     ) -> Dict[str, torch.Tensor]:
    """GPT-2 next-token CE through the pipe schedule, per chunk at the last
    stage: this rank's shares of ``loss`` (= ``nll``) and ``acc`` (module
    doc), each ``(sum over the chunk) * 1/denom`` as the JAX head;
    ``denom`` defaults to the microbatch's own loss count. An MoE model
    adds this stage's ``moe_aux`` share (``moe_global``: the counts over
    the stage's ranks) and its weighted term to ``loss``."""
    from .gpt2 import _targets
    ctx = ctx if ctx is not None else current_pipe()
    check_pipe_layout(model, ctx)
    ids, pad = batch["input_ids"], batch["pad_mask"]
    targets, lm = _targets(batch)
    if denom is None:
        denom = torch.clamp(lm.sum(), min=1.0)
    inv = 1.0 / denom
    B, L = ids.shape
    cb = _check_chunks(B, ctx.chunks, ctx.size, ctx.virtual)
    rows = lambda a, c: a[c * cb:(c + 1) * cb]  # noqa: E731

    def head(h, c):
        loss, acc = gpt2_head(model, h, rows(targets, c), rows(lm, c), inv)
        return loss, {"acc": acc}

    stats: List[List[MoEStats]] = []
    fns = StageFns(pre=lambda c: model.embed_tokens(rows(ids, c)),
                   stage=_stage_fn(model, ctx, stats),
                   mask=lambda c: rows(pad, c), head=head,
                   shape=(cb, L, model.hidden_size), dtype=model.dtype,
                   device=ids.device,
                   aux=_moe_aux_fn(model, stats, moe_global))
    loss, metrics = pipelined_loss(ctx, fns)
    zero = torch.zeros((), device=ids.device)
    out = {"loss": loss, "nll": loss, "acc": metrics.get("acc", zero)}
    if "moe_aux" in metrics:
        out["moe_aux"] = metrics["moe_aux"]
        out["loss"] = loss + MOE_AUX_WEIGHT * metrics["moe_aux"]
    return out


def diffuseq_1f1b_losses(model, batch: Dict[str, torch.Tensor], draws,
                         denom: Optional[torch.Tensor] = None,
                         ctx: Optional[PipeContext] = None,
                         moe_global: Optional[GlobalMoEStats] = None
                         ) -> Dict[str, torch.Tensor]:
    """The DiffuSeq objective with the denoiser trunk on the pipe
    schedule: this rank's shares of ``loss``, ``mse``, ``tT`` and
    ``decoder_nll`` (module doc). Every pipe rank draws the same ``t`` and
    noise (the caller passes the row group's draws); ``denom`` defaults to
    the microbatch's target count. An MoE model adds this stage's
    ``moe_aux`` share and its weighted term, as :func:`gpt2_1f1b_losses`."""
    from .diffuseq import draw, embedding_terms
    ctx = ctx if ctx is not None else current_pipe()
    check_pipe_layout(model, ctx)
    ids = batch["input_ids"]
    tgt_mask = batch["input_mask"].float()
    pad = batch["pad_mask"]
    schedule = model.schedule
    if denom is None:
        denom = torch.clamp(tgt_mask.sum(), min=1.0)
    inv = 1.0 / denom
    grad = torch.is_grad_enabled()
    x_start = model.embed(ids)
    t, noise = draw(schedule, draws, x_start)
    x_noisy = schedule.q_sample(x_start, t, noise)
    x_t = torch.where(tgt_mask[..., None] > 0, x_noisy, x_start)
    # the engine's differentiable data: leaves whose cotangents flow back
    # into the embedding after the schedule
    xt_leaf = x_t.detach().requires_grad_(grad)
    xs_leaf = x_start.detach().requires_grad_(grad)
    B, L = ids.shape
    cb = _check_chunks(B, ctx.chunks, ctx.size, ctx.virtual)
    rows = lambda a, c: a[c * cb:(c + 1) * cb]  # noqa: E731

    def head(h, c):
        return diffuseq_head(model, h, rows(xs_leaf, c), rows(tgt_mask, c),
                             inv), {}

    stats: List[List[MoEStats]] = []
    fns = StageFns(pre=lambda c: model.denoise_in(rows(xt_leaf, c),
                                                  rows(t, c)),
                   stage=_stage_fn(model, ctx, stats),
                   mask=lambda c: rows(pad, c), head=head,
                   shape=(cb, L, model.hidden_size), dtype=model.dtype,
                   device=ids.device,
                   aux=_moe_aux_fn(model, stats, moe_global))
    first = ctx.index == 0
    if first:
        # the terms that need only the embedding, once over the pipe
        tT, decoder_nll = embedding_terms(model, x_start, ids, tgt_mask,
                                          denom)
    mse, metrics = pipelined_loss(ctx, fns)
    if grad:
        roots, cots = [], []
        for root, leaf in ((x_t, xt_leaf), (x_start, xs_leaf)):
            if leaf.grad is not None:
                roots.append(root)
                cots.append(leaf.grad)
        if first:
            roots.append(tT + decoder_nll)
            cots.append(None)
        if roots:
            torch.autograd.backward(roots, cots)
    if not first:
        tT = decoder_nll = torch.zeros((), device=ids.device)
    tT, decoder_nll = tT.detach(), decoder_nll.detach()
    out = {"loss": mse + tT + decoder_nll, "mse": mse, "tT": tT,
           "decoder_nll": decoder_nll}
    if "moe_aux" in metrics:
        out["moe_aux"] = metrics["moe_aux"]
        out["loss"] = out["loss"] + MOE_AUX_WEIGHT * metrics["moe_aux"]
    return out
