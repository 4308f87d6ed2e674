"""DiffuSeq: seq2seq text diffusion in embedding space, the port of
``distributed_pipeline_tpu/models/diffuseq.py``.

Tokens embed into a low-dim continuous space; the TARGET span is diffused
with Gaussian noise at a sampled timestep while the SOURCE span stays clean
(partial noising: the source conditions the denoiser through bidirectional
attention); the transformer predicts x_0; the objective is x0-MSE on the
target span, plus the decodability NLL through the weight-tied rounding
head, plus the prior term ``||sqrt(abar_T) x_0||^2``.

Parameter names are the flax paths (``word_emb.embedding``,
``in_proj.kernel``, ``time_mlp.layers_0.kernel``, ``pos_emb``,
``backbone.block_i...``, ``out_proj.bias``), so a flax tree loads key for
key (``convert.py``). The dtype casts are the JAX module's: ``in_proj`` and
``out_proj`` compute in the model dtype over f32 parameters, the time MLP in
f32, the output is cast to f32, and the tied ``logits`` head runs in the
model dtype.

The loss's random draws (timesteps ``t`` and ``noise``) come from an
explicit ``torch.Generator``, or are handed in by the caller
(``{"t": [B], "noise": [B, L, E]}``), so a test can feed the reference's
draws. An MoE model (``moe_experts`` > 0) adds the load-balance aux to
the loss, as ``gpt2_losses`` does. Under a pipe group the loss runs the
pipe schedule (``schedule_1f1b.diffuseq_1f1b_losses``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.xent import token_cross_entropy
from ..parallel.ring import sequence_offset
from .backbone import Embed, TransformerBackbone, _param
from .diffusion import DiffusionSchedule
from .moe import MOE_AUX_WEIGHT, GlobalMoEStats, MoEStats, moe_aux
from .pipeline import current_pipe

__all__ = ["DiffuSeqModel", "diffuseq_losses", "diffuseq_loss_count",
           "embedding_terms", "timestep_embedding", "Draws",
           "DIFFUSEQ_EMB_DIM", "seeded_generator", "mix_seed", "rank_draws"]

DIFFUSEQ_EMB_DIM = 128  # DiffuSeq's low-dim embedding space

# a generator to draw (t, noise) from, or the draws themselves
Draws = Union[torch.Generator, Mapping[str, torch.Tensor]]


def mix_seed(*words: int) -> int:
    """One 63-bit seed from the non-negative integers ``words`` (e.g. seed,
    step, microbatch index), mixed by numpy's ``SeedSequence`` so that
    nearby words give unrelated streams."""
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def seeded_generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``mix_seed(*words)``."""
    return torch.Generator(device=device).manual_seed(mix_seed(*words))


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal timestep features [B, dim], f32."""
    half = dim // 2
    # log(max_period) rounds to the same f32 as the JAX package's jnp.log
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -math.log(max_period) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class Dense(nn.Module):
    """flax ``nn.Dense`` over f32 ``kernel`` [in, out] and ``bias`` [out]:
    the product and the bias add in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((d_in, d_out), device)
        self.bias = _param((d_out,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)


class TimeMlp(nn.Module):
    """flax ``nn.Sequential([Dense(4D), silu, Dense(D)])`` in f32; the
    Dense layers keep flax's names ``layers_0`` and ``layers_2``."""

    def __init__(self, hidden: int, device=None) -> None:
        super().__init__()
        self.layers_0 = Dense(hidden, 4 * hidden, torch.float32, device)
        self.layers_2 = Dense(4 * hidden, hidden, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_2(F.silu(self.layers_0(x)))


class DiffuSeqModel(nn.Module):
    """Denoiser ``(x_t [B, L, E], t [B], pad_mask [B, L]) -> x0_hat
    [B, L, E]`` (f32), over a bidirectional, pad-masked backbone. The word
    embedding doubles as the rounding head (``logits``). ``schedule`` is the
    run's diffusion schedule, which the loss and the samplers read.
    ``moe_*``, ``remat``, ``scan_layers``, the ``pp_*`` fields and
    ``scan_unroll`` are ``GPT2Model``'s. Parameters start at zero; load
    weights with ``load_state_dict``."""

    family = "diffuseq"

    def __init__(self, vocab_size: int, seq_len: int, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 emb_dim: int = 128, dtype: torch.dtype = torch.bfloat16,
                 device=None, attention_impl: str = "auto",
                 schedule: Optional[DiffusionSchedule] = None,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_every: int = 2, moe_capacity_factor: float = 1.25,
                 remat: bool = False, scan_layers: bool = False,
                 pp_chunks: int = 4, pp_schedule: str = "1f1b",
                 pp_virtual: int = 2, scan_unroll: int = 0) -> None:
        super().__init__()
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.emb_dim = emb_dim
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.schedule = schedule
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.moe_every = moe_every
        self.moe_capacity_factor = moe_capacity_factor
        self.remat = remat
        self.scan_layers = scan_layers
        self.pp_chunks = pp_chunks
        self.pp_schedule = pp_schedule
        self.pp_virtual = pp_virtual
        self.scan_unroll = scan_unroll
        self.word_emb = Embed(vocab_size, emb_dim, device)
        self.in_proj = Dense(emb_dim, hidden_size, dtype, device)
        self.time_mlp = TimeMlp(hidden_size, device)
        self.pos_emb = _param((seq_len, hidden_size), device)
        self.backbone = TransformerBackbone(
            num_layers, hidden_size, num_heads, dtype, device,
            attention_impl, causal=False, moe_experts=moe_experts,
            moe_top_k=moe_top_k, moe_every=moe_every,
            moe_capacity_factor=moe_capacity_factor, remat=remat,
            scan_layers=scan_layers)
        self.out_proj = Dense(hidden_size, emb_dim, dtype, device)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Token ids -> embedding-space points x_0, f32 [B, L, E]."""
        return self.word_emb.embedding[ids.long()]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Rounding head: embedding-space points -> vocab logits through the
        tied embedding, in the model dtype (the loss takes its softmax
        statistics in f32)."""
        return torch.einsum("...e,ve->...v", x.to(self.dtype),
                            self.word_emb.embedding.to(self.dtype))

    def forward(self, x_t: torch.Tensor, t: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                moe_no_drop: bool = False,
                moe_stats: Optional[List[MoEStats]] = None) -> torch.Tensor:
        h = self.denoise_in(x_t, t)
        h = self.backbone(h, pad_mask,          # bidirectional, pad-masked
                          moe_no_drop=moe_no_drop, moe_stats=moe_stats)
        return self.denoise_out(h)

    def denoise_in(self, x_t: torch.Tensor, t: torch.Tensor
                   ) -> torch.Tensor:
        """The denoiser's input [B, L, D] in the model dtype: ``in_proj``
        of x_t, plus the time MLP's embedding of t, plus positions."""
        L = x_t.shape[1]
        h = self.in_proj(x_t.to(self.dtype))
        temb = self.time_mlp(timestep_embedding(t, self.hidden_size))
        h = h + temb[:, None, :].to(self.dtype)
        off = sequence_offset(L)   # a sequence-parallel rank's slice
        return h + self.pos_emb[None, off:off + L].to(self.dtype)

    def denoise_out(self, h: torch.Tensor) -> torch.Tensor:
        """The backbone's output (after ``ln_f``) -> x0_hat, f32."""
        return self.out_proj(h).float()


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of per-position values [B, L] over the positions mask == 1;
    ``denom`` replaces the count (clamped to >= 1) when given."""
    m = mask.to(x.dtype)
    if denom is None:
        denom = torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(x * m) / denom


def embedding_terms(model: DiffuSeqModel, x_start: torch.Tensor,
                    ids: torch.Tensor, tgt_mask: torch.Tensor,
                    denom: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two loss terms that need only the embedding, ``(tT,
    decoder_nll)``: masked means over the target span (``_masked_mean``'s
    ``denom``) of the prior's KL at step T and of the rounding head's CE."""
    tT = _masked_mean(model.schedule.mean_flat_tT(x_start), tgt_mask, denom)
    decoder_nll = _masked_mean(
        token_cross_entropy(model.logits(x_start), ids), tgt_mask, denom)
    return tT, decoder_nll


def diffuseq_loss_count(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The positions the masked means average over (the target span), f32
    0-d: what a rank contributes to a global denominator."""
    return torch.sum(batch["input_mask"].float())


def rank_draws(schedule: DiffusionSchedule, draws: Draws,
               shape: Tuple[int, ...], rank: int, world: int,
               seq_index: int = 0, seq_size: int = 1
               ) -> Dict[str, torch.Tensor]:
    """This rank's share of a global microbatch's draws. ``draws`` is the
    global microbatch's (``world * shape[0]`` rows of ``seq_size *
    shape[1]`` positions): a generator, drawn as one process would draw
    that many rows (t first, then the noise), or ``{"t", "noise"}``
    tensors; data rank r of ``world`` takes rows ``r * B : (r + 1) * B``
    of each, and sequence index i of ``seq_size`` the noise's positions
    ``i * L : (i + 1) * L``, ``shape`` being its x_start's ``[B, L, E]``
    (``t`` is one a row: every sequence rank of a row takes the same)."""
    rows, length = shape[0], shape[1]
    if isinstance(draws, torch.Generator):
        t = schedule.sample_t(draws, rows * world)
        noise = torch.randn((rows * world, length * seq_size, *shape[2:]),
                            generator=draws, device=draws.device,
                            dtype=torch.float32)
        draws = {"t": t, "noise": noise}
    lo, pos = rank * rows, seq_index * length
    return {"t": draws["t"][lo:lo + rows],
            "noise": draws["noise"][lo:lo + rows, pos:pos + length]}


def draw(schedule: DiffusionSchedule, draws: Draws, x_start: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(t [B], noise like x_start)``: drawn from ``draws`` when it is a
    generator (t first, then the noise), else the caller's tensors."""
    if isinstance(draws, torch.Generator):
        t = schedule.sample_t(draws, x_start.shape[0])
        noise = torch.randn(x_start.shape, generator=draws,
                            device=draws.device, dtype=x_start.dtype)
    else:
        t, noise = draws["t"], draws["noise"]
    return (t.to(x_start.device),
            noise.to(device=x_start.device, dtype=x_start.dtype))


def diffuseq_losses(model: DiffuSeqModel, batch: Dict[str, torch.Tensor],
                    draws: Draws, denom: Optional[torch.Tensor] = None,
                    moe_global: Optional[GlobalMoEStats] = None
                    ) -> Dict[str, torch.Tensor]:
    """The DiffuSeq objective, as the JAX package's ``diffuseq_losses``:
    ``loss = mse + tT + decoder_nll``, each a 0-d f32 tensor, over a batch
    of ``input_ids``, ``input_mask`` (the diffused target span) and
    ``pad_mask`` [B, L]. ``denom`` (a global microbatch's target count,
    clamped to >= 1) replaces the batch's own in every masked mean: a
    rank's terms then sum over the ranks to the global ones. An MoE model
    adds ``moe_aux`` and ``MOE_AUX_WEIGHT * moe_aux`` to ``loss``, the aux
    from the global counts under ``moe_global`` (``gpt2_losses``). Under a
    pipe group it runs the pipe schedule and returns this rank's shares
    (``schedule_1f1b.diffuseq_1f1b_losses``)."""
    ctx = current_pipe()
    if ctx is not None:
        from .schedule_1f1b import diffuseq_1f1b_losses
        return diffuseq_1f1b_losses(model, batch, draws, denom, ctx,
                                    moe_global)
    ids = batch["input_ids"]
    tgt_mask = batch["input_mask"].float()
    pad_mask = batch["pad_mask"]
    schedule = model.schedule
    x_start = model.embed(ids)
    t, noise = draw(schedule, draws, x_start)
    x_noisy = schedule.q_sample(x_start, t, noise)
    # partial noising: the target span diffuses, the source span anchors
    x_t = torch.where(tgt_mask[..., None] > 0, x_noisy, x_start)
    stats: List[MoEStats] = []
    x0_hat = model(x_t, t, pad_mask, moe_stats=stats)
    mse = _masked_mean(torch.mean((x0_hat - x_start) ** 2, dim=-1), tgt_mask,
                       denom)
    tT, decoder_nll = embedding_terms(model, x_start, ids, tgt_mask, denom)
    out = {"loss": mse + tT + decoder_nll, "mse": mse, "tT": tT,
           "decoder_nll": decoder_nll}
    if stats:  # an MoE model
        aux = moe_aux(stats, model.moe_experts, moe_global)
        out["moe_aux"] = aux
        out["loss"] = out["loss"] + MOE_AUX_WEIGHT * aux
    return out
