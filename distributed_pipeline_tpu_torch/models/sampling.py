"""Inference: the port of ``distributed_pipeline_tpu/models/sampling.py``'s
DiffuSeq samplers and the truncation step of the batch decoders.

* :func:`diffuseq_sample` - DDIM (eta=0) reverse diffusion over the target
  span with the source span anchored clean (training's partial noising,
  mirrored), DiffuSeq's clamping (each x0 estimate projected onto its
  nearest word embedding through the tied rounding head), and step
  striding for fast sampling;
* :func:`diffuseq_sample_mbr` - minimum-Bayes-risk consensus over S
  independent samples (the DiffuSeq paper's own scheme);
* :func:`target_span_accuracy` and :func:`make_decode_callback`, which
  wires the sampler into ``TrainLoop``'s ``eval_callbacks`` and logs
  ``decode_acc``.

The initial noise comes from an explicit ``torch.Generator``, or is handed
in (one tensor a candidate for MBR), so a test can feed the reference's.
The step loop runs eagerly in Python. ``gpt2_decode`` and the dense-cache
decode are ROADMAP A.7b.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Union

import numpy as np
import torch

from .diffuseq import DiffuSeqModel, seeded_generator

__all__ = ["diffuseq_sample", "diffuseq_sample_mbr", "target_span_accuracy",
           "make_decode_callback", "_truncate_logits", "_sample_timesteps",
           "_mbr_scores"]

Noise = Union[torch.Generator, torch.Tensor]


def _truncate_logits(l: torch.Tensor, top_k: int,
                     top_p: float) -> torch.Tensor:
    """Top-k / nucleus truncation of f32 logits [..., V]: cut entries become
    ``-inf``. Same rule as the JAX package: top-k keeps every entry >= the
    k-th largest, and nucleus keeps the smallest sorted prefix whose mass
    reaches ``top_p`` (the crossing token stays in)."""
    if top_k > 0:
        k = min(top_k, l.shape[-1])  # top_k >= vocab means no truncation
        kth = torch.topk(l, k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, torch.full_like(l, float("-inf")), l)
    if 0.0 < top_p < 1.0:
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, sorted_l,
                             torch.full_like(sorted_l, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        l = torch.where(l < cutoff, torch.full_like(l, float("-inf")), l)
    return l


def _sample_timesteps(T: int, sample_steps: int) -> np.ndarray:
    """Descending int32 subset of [0, T): all T when ``sample_steps`` <= 0,
    else an evenly strided subsequence ending at 0 (DDIM respacing)."""
    if sample_steps <= 0 or sample_steps >= T:
        return np.arange(T - 1, -1, -1, dtype=np.int32)
    return np.unique(np.linspace(0, T - 1, sample_steps).round()
                     .astype(np.int32))[::-1].copy()


@torch.no_grad()
def diffuseq_sample(model: DiffuSeqModel, batch: Dict[str, torch.Tensor],
                    noise: Noise, sample_steps: int = 0,
                    clamp: bool = True) -> torch.Tensor:
    """Target-span token ids by reverse diffusion: int32 [B, L], the source
    ids untouched and the target span (``input_mask == 1``) generated. The
    batch's target ids are never read (zeroed before embedding), so gold
    batches can be passed. ``noise`` is a generator or the [B, L, E]
    starting noise."""
    sched = model.schedule
    ids = batch["input_ids"]
    tgt = batch["input_mask"][..., None] > 0             # [B, L, 1]
    pad_mask = batch["pad_mask"]
    B = ids.shape[0]
    x_src = model.embed(torch.where(tgt[..., 0], 0, ids))
    if isinstance(noise, torch.Generator):
        noise = torch.randn(x_src.shape, generator=noise,
                            device=noise.device)
    x = torch.where(tgt, noise.to(x_src.device, torch.float32), x_src)
    sa, ss = sched.sqrt_alphas_cumprod, sched.sqrt_one_minus_alphas_cumprod
    ts = _sample_timesteps(sched.num_steps, sample_steps)
    t_prev = np.concatenate([ts[1:], [0]]).astype(np.int32)
    x0 = x_src
    for t, tp in zip(ts.tolist(), t_prev.tolist()):
        t_full = torch.full((B,), t, dtype=torch.int32, device=ids.device)
        x0 = model(x, t_full, pad_mask)
        if clamp:
            x0 = model.embed(torch.argmax(model.logits(x0), dim=-1))
        x0 = torch.where(tgt, x0, x_src)
        # the table entries are f32, as python floats exactly
        eps = (x - float(sa[t]) * x0) / float(np.maximum(ss[t],
                                                         np.float32(1e-4)))
        x = torch.where(tgt, float(sa[tp]) * x0 + float(ss[tp]) * eps, x_src)
    gen = torch.argmax(model.logits(x0), dim=-1).to(ids.dtype)
    return torch.where(tgt[..., 0], gen, ids)


def _mbr_scores(cands: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Per-candidate consensus score [S, B]: the mean target-span token
    agreement of candidate s with the other candidates."""
    agree = (cands[:, None] == cands[None, :]).float()  # [S, S, B, L]
    span = torch.clamp(tgt.sum(-1), min=1.0)            # [B]
    pair = (agree * tgt[None, None]).sum(-1) / span     # [S, S, B]
    return (pair.sum(0) - 1.0) / (cands.shape[0] - 1)


def diffuseq_sample_mbr(model: DiffuSeqModel,
                        batch: Dict[str, torch.Tensor], noise: Noise,
                        num_candidates: int = 5, sample_steps: int = 0,
                        clamp: bool = True) -> torch.Tensor:
    """Minimum-Bayes-risk decoding: ``num_candidates`` independent samples,
    and per example the one that agrees most with the others over the
    target span. ``noise`` is a generator (the candidates draw from it in
    turn) or one starting noise a candidate, [S, B, L, E]; with one
    candidate it is :func:`diffuseq_sample` on a [B, L, E] noise."""
    if num_candidates <= 1:
        return diffuseq_sample(model, batch, noise, sample_steps, clamp)
    per = (noise if isinstance(noise, torch.Generator) else noise[s]
           for s in range(num_candidates))
    cands = torch.stack([diffuseq_sample(model, batch, n, sample_steps, clamp)
                         for n in per])                 # [S, B, L]
    tgt = (batch["input_mask"] * batch["pad_mask"]).float()
    best = torch.argmax(_mbr_scores(cands, tgt), dim=0)  # [B]
    return torch.take_along_dim(cands, best[None, :, None].long(), dim=0)[0]


def target_span_accuracy(pred_ids: torch.Tensor,
                         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token accuracy of ``pred_ids`` against the batch's gold ids over the
    target span (``input_mask & pad_mask``), a 0-d f32 tensor."""
    m = (batch["input_mask"] * batch["pad_mask"]).float()
    hit = (pred_ids == batch["input_ids"]).float()
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)


def make_decode_callback(data: Iterator[Dict[str, np.ndarray]],
                         sample_steps: int = 32
                         ) -> Callable[[Any], None]:
    """An ``eval_callbacks`` entry for a DiffuSeq ``TrainLoop``: decode one
    batch (the first of ``data``, kept on the loop's device) with noise
    seeded from the step, and log ``decode_acc``."""
    cache: Dict[str, Dict[str, torch.Tensor]] = {}

    def callback(loop) -> None:
        if "batch" not in cache:
            cache["batch"] = {k: torch.from_numpy(np.asarray(v)).to(
                loop.device) for k, v in next(data).items()}
        batch = cache["batch"]
        noise = seeded_generator(loop.device, 0, loop.step)
        pred = diffuseq_sample(loop.model, batch, noise, sample_steps)
        loop.logger.logkv("decode_acc",
                          float(target_span_accuracy(pred, batch)))

    return callback
