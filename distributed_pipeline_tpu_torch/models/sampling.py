"""Inference: the port of ``distributed_pipeline_tpu/models/sampling.py``.

* :func:`diffuseq_sample` - DDIM (eta=0) reverse diffusion over the target
  span with the source span anchored clean (training's partial noising,
  mirrored), DiffuSeq's clamping (each x0 estimate projected onto its
  nearest word embedding through the tied rounding head), and step
  striding for fast sampling;
* :func:`diffuseq_sample_mbr` - minimum-Bayes-risk consensus over S
  independent samples (the DiffuSeq paper's own scheme);
* :func:`gpt2_decode` - continuation of a prompt prefix over the dense KV
  cache (``models/backbone.DenseKV``: one full-length prefill, then one
  single-token forward a position), or by a full re-forward a position
  (``use_cache=False``, the reference the cache is held to); greedy, or
  temperature / top-k / nucleus sampling;
* :func:`target_span_accuracy`, :func:`gpt2_decode_and_score` and
  :func:`make_decode_callback`, which wires either family's decoder into
  ``TrainLoop``'s ``eval_callbacks`` and logs ``decode_acc`` (and
  ``decode_acc_ema_<rate>`` for an EMA copy).

DiffuSeq's initial noise comes from an explicit ``torch.Generator``, or is
handed in (one tensor a candidate for MBR), so a test can feed the
reference's. GPT-2's sampling noise cannot be JAX's threefry: it is keyed
on the device by (seed, row, position, vocab index) (:func:`keyed_gumbel`,
which the serving engine keys by slot the same way), so the cached and
uncached paths draw the same noise. The step loops run eagerly in Python.
Every decoder routes an MoE model without drops (``moe_no_drop=True``, the
JAX ``clone(moe_no_drop=True)``): each token takes its exact top-k
experts, so cached and uncached decoding agree. Stacked (``scan_layers``)
models decode through the dense cache; stacked MoE groups have none, and
decode by the full recompute, as the JAX sampler falls back.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from ..parallel import dist
from ..utils.perf import sync_allowed
from .backbone import DenseKV
from .diffuseq import DiffuSeqModel, seeded_generator
from .gpt2 import GPT2Model

__all__ = ["diffuseq_sample", "diffuseq_sample_mbr", "gpt2_decode",
           "gpt2_greedy_decode", "gpt2_decode_and_score",
           "gpt2_decode_accuracy", "target_span_accuracy",
           "make_decode_callback", "keyed_gumbel", "KeyedPicker",
           "_truncate_logits", "_sample_timesteps", "_mbr_scores"]

Noise = Union[torch.Generator, torch.Tensor]
Seed = Union[int, torch.Tensor]

_M32 = 0xFFFFFFFF


def _hash32(x):
    """A 32-bit integer mixer over int64 tensors (or Python ints) holding
    values in [0, 2^32): every product stays below 2^63, so torch's int64
    arithmetic gives the same bits on the CPU and on the card."""
    x = x & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def _seed_key(seed: Seed):
    return _hash32(_hash32(seed & _M32) ^ ((seed >> 32) & _M32))


def keyed_gumbel(seed: Seed, rows: torch.Tensor, positions: torch.Tensor,
                 vocab_hash: torch.Tensor) -> torch.Tensor:
    """Gumbel noise [N, V] as a pure function of (seed, row, position,
    vocab index): an integer hash, then a uniform in (0, 1) from its top 24
    bits, then ``-log(-log u)``. ``seed`` is a non-negative int or an int64
    0-d tensor holding one (device state a CUDA graph reads at replay);
    ``rows`` are batch rows or decode slots; ``vocab_hash`` is
    ``_hash32(arange(V))``. The same code on the CPU and on the card; the
    keys match bit for bit, the logarithms to the last ulp of each
    device's ``log``."""
    key = _hash32(_hash32(rows.long() ^ _seed_key(seed))
                  ^ positions.long())                          # [N]
    h = _hash32(key[:, None] ^ vocab_hash[None, :])            # [N, V]
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


class KeyedPicker:
    """Token picker ``(logits [N, V], positions [N], rows [N]) -> int32
    [N]``, all device tensors. Greedy at temperature <= 0; otherwise
    temperature, then :func:`_truncate_logits`, then a categorical pick by
    Gumbel-max whose noise is keyed per (seed, row, position)
    (:func:`keyed_gumbel`), the JAX per-position key fold: two rows at one
    position draw different noise, and a row's stream is fixed from its
    first token on. The seed is a 0-d int64 device tensor that
    :meth:`set_seed` rewrites in place, so a captured CUDA graph reads the
    seed of its replay, not of its capture."""

    def __init__(self, temperature: float, top_k: int, top_p: float,
                 seed: Optional[int], vocab_size: int,
                 device: torch.device) -> None:
        if temperature > 0.0 and seed is None:
            raise ValueError("stochastic decoding (temperature > 0) needs a "
                             "seed")
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = torch.full((), int(seed or 0), dtype=torch.int64,
                               device=device)
        self.vocab_hash = (_hash32(torch.arange(vocab_size, device=device))
                           if temperature > 0.0 else None)

    def set_seed(self, seed: int) -> None:
        self.seed.fill_(int(seed))

    def __call__(self, logits: torch.Tensor, positions: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
        if self.vocab_hash is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        l = _truncate_logits(logits.float() / self.temperature, self.top_k,
                             self.top_p)
        noise = keyed_gumbel(self.seed, rows, positions, self.vocab_hash)
        return torch.argmax(l + noise, dim=-1).to(torch.int32)


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
        x0 = model(x, t_full, pad_mask, moe_no_drop=True)
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


@torch.no_grad()
def gpt2_decode(model: GPT2Model, ids: torch.Tensor, prompt_len: int,
                use_cache: bool = True, temperature: float = 0.0,
                top_k: int = 0, top_p: float = 0.0,
                seed: Optional[int] = None) -> torch.Tensor:
    """Continue ``ids[:, :prompt_len]`` out to the full length: int [B, L]
    out, the prompt untouched. ``temperature=0`` (default) is greedy
    argmax; > 0 samples from the temperature-scaled distribution, cut to
    the ``top_k`` most likely tokens and/or the ``top_p`` nucleus, with
    noise keyed per (``seed``, row, position) (:class:`KeyedPicker`), so
    the cached and uncached paths sample alike.

    ``use_cache=True`` runs the dense KV cache: one full-length prefill
    fills every layer's K/V (stale tail rows are overwritten before any
    step reads them: causality guarantees it), then one single-position
    forward a new token. ``use_cache=False`` recomputes the full forward
    a position: the reference the cache path is held to, and the path a
    stacked MoE model always takes. The pick at position p is keyed at
    p, the index being written, on both paths."""
    if model.family != "gpt2":
        raise ValueError(f"gpt2_decode decodes the gpt2 family, got "
                         f"{model.family!r}")
    B, L = ids.shape
    dev = ids.device
    pick = KeyedPicker(temperature, top_k, top_p, seed, model.vocab_size,
                       dev)
    rows = torch.arange(B, device=dev)
    ids = ids.clone()
    pad = torch.ones_like(ids)
    if model.scan_layers and model.moe_experts > 0:
        # MoE scan groups keep no cache: the recompute decodes the same
        # tokens (the JAX sampler's fallback)
        use_cache = False
    if not use_cache:
        for i in range(prompt_len, L):
            logits = model(ids, pad, moe_no_drop=True)      # [B, L, V]
            ids[:, i] = pick(logits[:, i - 1],
                             torch.full((B,), i, device=dev), rows)
        return ids
    cache = [DenseKV() for _ in range(model.num_layers)]
    logits = model(ids, pad, kv_cache=cache,
                   moe_no_drop=True)                        # the prefill
    pos = torch.full((), prompt_len, dtype=torch.int64, device=dev)
    if prompt_len < L:
        ids[:, prompt_len] = pick(logits[:, prompt_len - 1], pos.expand(B),
                                  rows)
    for i in range(prompt_len, L - 1):
        # the token at position i (pos holds i) writes its K/V there and
        # attends over cache[0..i]; its pick lands at i + 1
        logits = model(ids[:, i:i + 1], None, cache_index=pos,
                       kv_cache=cache, moe_no_drop=True)
        pos += 1
        ids[:, i + 1] = pick(logits[:, 0], pos.expand(B), rows)
    return ids


def gpt2_greedy_decode(model: GPT2Model, ids: torch.Tensor, prompt_len: int,
                       use_cache: bool = True) -> torch.Tensor:
    """Greedy continuation (:func:`gpt2_decode` at temperature 0)."""
    return gpt2_decode(model, ids, prompt_len, use_cache=use_cache)


def target_span_accuracy(pred_ids: torch.Tensor,
                         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token accuracy of ``pred_ids`` against the batch's gold ids over the
    target span (``input_mask & pad_mask``), a 0-d f32 tensor."""
    m = (batch["input_mask"] * batch["pad_mask"]).float()
    hit = (pred_ids == batch["input_ids"]).float()
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)


def gpt2_decode_and_score(model: GPT2Model,
                          batch: Dict[str, torch.Tensor],
                          prompt_len: int = 0, temperature: float = 0.0,
                          top_k: int = 0, top_p: float = 0.0,
                          seed: Optional[int] = None):
    """Decode the suffix after ``prompt_len`` (default seq_len/2) and score
    it against the gold continuation over the generated, unpadded span:
    ``(pred_ids, accuracy)``, the JAX span accounting."""
    plen = prompt_len or model.seq_len // 2
    pred = gpt2_decode(model, batch["input_ids"], plen,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       seed=seed)
    gen_mask = (torch.arange(model.seq_len, device=pred.device)
                >= plen).to(torch.int32).expand(pred.shape)
    acc = target_span_accuracy(
        pred, dict(batch, input_mask=gen_mask * batch["pad_mask"]))
    return pred, acc


def gpt2_decode_accuracy(model: GPT2Model, batch: Dict[str, torch.Tensor],
                         prompt_len: int = 0,
                         preds: Optional[list] = None) -> torch.Tensor:
    """Greedy generated-span accuracy (:func:`gpt2_decode_and_score`);
    ``preds``, a list, receives the decoded rows."""
    pred, acc = gpt2_decode_and_score(model, batch, prompt_len)
    if preds is not None:
        preds.append(pred)
    return acc


def make_decode_callback(data: Iterator[Dict[str, np.ndarray]],
                         sample_steps: int = 32,
                         prompt_len: Optional[int] = None,
                         use_ema: str = "") -> Callable[[Any], None]:
    """An ``eval_callbacks`` entry for a ``TrainLoop`` of either family:
    decode one batch (the first of ``data``, kept on the loop's device)
    and log ``decode_acc``, or ``decode_acc_ema_<rate>`` when ``use_ema``
    names one of the loop's EMA rates (decoded through views into that
    EMA row; the training parameters are not touched). DiffuSeq samples
    ``sample_steps`` reverse steps with noise seeded from the step; GPT-2
    decodes greedily after ``prompt_len`` (default seq_len/2). The model
    is back in its own mode after, and no gradient is taken.

    Under sequence parallelism (``loop.seq.size`` > 1) the callback runs
    outside the ring: each data group's first sequence rank decodes the
    full sequence from its replicated weights, as one process would, while
    the group's other ranks log the key absent (the logger's mean over the
    ranks then carries the decoding ranks' value) and every rank meets at
    a barrier. Each decode appends ``{"step", "key", "value",
    "tokens_sha256"}`` (the decoded rows' SHA-256) to the loop's
    ``eval_decodes`` when it has one. Under a pipe group
    (``loop.pipe.size`` > 1) the trainer runs the callback inside
    ``full_weights``, which gathers the stacked weights onto every rank;
    the group's stage 0 decodes (the dense cache over every layer) and the
    others log the key absent and wait at the barrier (ROADMAP C.18b: JAX
    decodes through pipe-sharded caches)."""
    cache: Dict[str, Dict[str, torch.Tensor]] = {}

    def callback(loop) -> None:
        seq, pipe = loop.seq, getattr(loop, "pipe", None)
        staged = pipe is not None and pipe.size > 1
        if seq.size > 1 or staged:
            key = (f"decode_acc_ema_{use_ema}"
                   if use_ema and use_ema in loop.ema_rates
                   else "decode_acc")
            if seq.index == 0 and (not staged or pipe.index == 0):
                decode(loop)
            else:
                loop.logger.logkv_absent(key)
            with sync_allowed(loop.device):
                dist.barrier("eval_decode")
            return
        decode(loop)

    def decode(loop) -> None:
        if "batch" not in cache:
            cache["batch"] = {k: torch.from_numpy(np.asarray(v)).to(
                loop.device) for k, v in next(data).items()}
        batch = cache["batch"]
        model = loop.model
        key = "decode_acc"
        weights = contextlib.nullcontext()
        if use_ema and use_ema in loop.ema_rates:
            key = f"decode_acc_ema_{use_ema}"
            weights = loop.ema_weights(use_ema)
        was_training = model.training
        model.eval()
        try:
            with weights:
                if model.family == "diffuseq":
                    noise = seeded_generator(loop.device, 0, loop.step)
                    pred = diffuseq_sample(model, batch, noise, sample_steps)
                    acc = target_span_accuracy(pred, batch)
                else:
                    rows: list = []
                    acc = gpt2_decode_accuracy(model, batch, prompt_len or 0,
                                               preds=rows)
                    pred = rows[0]
        finally:
            model.train(was_training)
        loop.logger.logkv(key, float(acc))
        record = getattr(loop, "eval_decodes", None)
        if record is not None:
            # the decoded rows' digest: a run's decodes compared token for
            # token without keeping them
            record.append({"step": loop.step, "key": key,
                           "value": float(acc), "tokens_sha256":
                           hashlib.sha256(pred.cpu().numpy().tobytes())
                           .hexdigest()})

    return callback
