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
draws. MoE and the pipeline (1F1B) losses are ROADMAP A.8 and A.9.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.xent import token_cross_entropy
from .backbone import Embed, TransformerBackbone, _param
from .diffusion import DiffusionSchedule

__all__ = ["DiffuSeqModel", "diffuseq_losses", "timestep_embedding",
           "Draws", "DIFFUSEQ_EMB_DIM", "seeded_generator"]

DIFFUSEQ_EMB_DIM = 128  # DiffuSeq's low-dim embedding space

# a generator to draw (t, noise) from, or the draws themselves
Draws = Union[torch.Generator, Mapping[str, torch.Tensor]]


def seeded_generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from the non-negative integers
    ``words`` (e.g. seed, step, microbatch index), mixed by numpy's
    ``SeedSequence`` so that nearby words give unrelated streams."""
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    seed = (int(state[0]) << 31) ^ int(state[1])
    return torch.Generator(device=device).manual_seed(seed)


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
    Parameters start at zero; load weights with ``load_state_dict``."""

    family = "diffuseq"

    def __init__(self, vocab_size: int, seq_len: int, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 emb_dim: int = 128, dtype: torch.dtype = torch.bfloat16,
                 device=None, attention_impl: str = "auto",
                 schedule: Optional[DiffusionSchedule] = None) -> None:
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
        self.word_emb = Embed(vocab_size, emb_dim, device)
        self.in_proj = Dense(emb_dim, hidden_size, dtype, device)
        self.time_mlp = TimeMlp(hidden_size, device)
        self.pos_emb = _param((seq_len, hidden_size), device)
        self.backbone = TransformerBackbone(num_layers, hidden_size,
                                            num_heads, dtype, device,
                                            attention_impl, causal=False)
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
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        L = x_t.shape[1]
        h = self.in_proj(x_t.to(self.dtype))
        temb = self.time_mlp(timestep_embedding(t, self.hidden_size))
        h = h + temb[:, None, :].to(self.dtype)
        h = h + self.pos_emb[None, :L].to(self.dtype)
        h = self.backbone(h, pad_mask)          # bidirectional, pad-masked
        return self.out_proj(h).float()


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of per-position values [B, L] over the positions mask == 1."""
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


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
                    draws: Draws) -> Dict[str, torch.Tensor]:
    """The DiffuSeq objective, as the JAX package's ``diffuseq_losses``:
    ``loss = mse + tT + decoder_nll``, each a 0-d f32 tensor, over a batch
    of ``input_ids``, ``input_mask`` (the diffused target span) and
    ``pad_mask`` [B, L]."""
    ids = batch["input_ids"]
    tgt_mask = batch["input_mask"].float()
    pad_mask = batch["pad_mask"]
    schedule = model.schedule
    x_start = model.embed(ids)
    t, noise = draw(schedule, draws, x_start)
    x_noisy = schedule.q_sample(x_start, t, noise)
    # partial noising: the target span diffuses, the source span anchors
    x_t = torch.where(tgt_mask[..., None] > 0, x_noisy, x_start)
    x0_hat = model(x_t, t, pad_mask)
    mse = _masked_mean(torch.mean((x0_hat - x_start) ** 2, dim=-1), tgt_mask)
    tT = _masked_mean(schedule.mean_flat_tT(x_start), tgt_mask)
    logits = model.logits(x_start)
    decoder_nll = _masked_mean(token_cross_entropy(logits, ids), tgt_mask)
    return {"loss": mse + tT + decoder_nll, "mse": mse, "tT": tT,
            "decoder_nll": decoder_nll}
