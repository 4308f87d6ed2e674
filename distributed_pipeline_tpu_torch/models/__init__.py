"""Model factory: the port of ``distributed_pipeline_tpu/models/__init__.py``.

``create_model_from_config(**training_args)`` builds the model a run
directory's ``training_args.json`` describes, ignoring the training-only keys
in it: a :class:`DiffuSeqModel` (holding its diffusion schedule) or a
:class:`GPT2Model`. ``compute_losses(model, batch, draws)`` is the one loss
seam the trainer calls for either family, in place of the JAX ``Workload``'s
``compute_losses``. Under data parallelism the trainer passes a global
microbatch's denominator (the ranks' ``loss_count`` summed) so each rank's
terms are its share of the global masked means, and ``finish_losses``
adds the metrics that are not sums of shares once the shares are summed.
An MoE model's load-balance aux is formed the same way from the global
microbatch's counts (``moe_global``: the ranks' ``moe_live_count`` summed
and the expert counts all-reduced; ``models/moe.py``). Under sequence
parallelism ``sequence_slice`` gives a rank its L slice of a microbatch
(GPT-2's with the next slice's first token for its last target); the
same global denominators hold, every term being a per-token masked
mean. Under a pipe group (``pipeline.pipe_parallel``) ``compute_losses``
runs the pipe schedule: with gradients on it also runs the backward
(``models/schedule_1f1b.py``), and returns this rank's shares.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from .diffuseq import (DIFFUSEQ_EMB_DIM, DiffuSeqModel, Draws,
                       diffuseq_loss_count, diffuseq_losses)
from .diffusion import make_schedule
from .gpt2 import (GPT2Model, gpt2_loss_count, gpt2_losses, gpt2_ppl,
                   gpt2_sequence_slice)
from .moe import GlobalMoEStats, moe_live_count

__all__ = ["PRESETS", "create_model_from_config", "compute_losses",
           "loss_count", "finish_losses", "GPT2Model", "DiffuSeqModel",
           "gpt2_losses", "diffuseq_losses", "torch_dtype", "Model",
           "GlobalMoEStats", "moe_live_count", "sequence_slice"]

Model = Union[DiffuSeqModel, GPT2Model]

# (hidden, layers, heads) per family/size — the JAX package's table.
PRESETS: Dict[str, Dict[str, Tuple[int, int, int]]] = {
    "diffuseq": {
        "base": (768, 12, 12),
        "large": (1024, 24, 16),
        "xl": (1600, 32, 25),
    },
    "gpt2": {
        "base": (768, 12, 12),
        "medium": (1024, 24, 16),
        "large": (1280, 36, 20),
        "xl": (1600, 48, 25),
    },
}


def torch_dtype(name: str) -> torch.dtype:
    """The compute dtype a config names ("bfloat16" or "float32")."""
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be bfloat16|float32, got {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def create_model_from_config(*, model_family: str = "diffuseq",
                             model_size: str = "base",
                             vocab_size: int = 8192, seq_len: int = 128,
                             hidden_size: int = 0, num_layers: int = 0,
                             num_heads: int = 0,
                             diffusion_steps: int = 2000,
                             noise_schedule: str = "sqrt",
                             dtype: str = "bfloat16",
                             attention_impl: str = "auto", device=None,
                             remat: bool = False, moe_experts: int = 0,
                             moe_top_k: int = 2, moe_every: int = 2,
                             moe_capacity_factor: float = 1.25,
                             scan_layers: bool = False, pp_chunks: int = 4,
                             pp_schedule: str = "1f1b", pp_virtual: int = 2,
                             scan_unroll: int = 0,
                             **_unused: Any) -> Model:
    """The model for (a superset of) the JAX package's ``TrainSettings``
    fields; preset dims are overridden by nonzero hidden/layers/heads,
    ``moe_experts`` > 0 builds the mixture-of-experts model a run dir's
    ``training_args.json`` names, and ``scan_layers`` the stacked blocks
    (with the pipe schedule's ``pp_*`` fields and ``scan_unroll``, as the
    JAX factory). The parameters are zeros until a state dict is
    loaded."""
    if model_family not in PRESETS:
        raise ValueError(f"unknown model family: {model_family!r}; "
                         f"available: {sorted(PRESETS)}")
    if moe_experts > 0 and moe_every < 1:
        raise ValueError(f"moe_every must be >= 1, got {moe_every}")
    preset = PRESETS[model_family].get(model_size)
    if preset is None:
        raise ValueError(f"no preset {model_size!r} for family "
                         f"{model_family!r}; available: "
                         f"{sorted(PRESETS[model_family])}")
    dims = dict(vocab_size=vocab_size, seq_len=seq_len,
                hidden_size=hidden_size or preset[0],
                num_layers=num_layers or preset[1],
                num_heads=num_heads or preset[2],
                dtype=torch_dtype(dtype), device=device,
                attention_impl=attention_impl, remat=bool(remat),
                moe_experts=moe_experts, moe_top_k=moe_top_k,
                moe_every=moe_every, moe_capacity_factor=moe_capacity_factor,
                scan_layers=bool(scan_layers), pp_chunks=pp_chunks,
                pp_schedule=pp_schedule, pp_virtual=pp_virtual,
                scan_unroll=scan_unroll)
    if model_family == "diffuseq":
        return DiffuSeqModel(**dims, emb_dim=DIFFUSEQ_EMB_DIM,
                             schedule=make_schedule(noise_schedule,
                                                    diffusion_steps))
    return GPT2Model(**dims)


def compute_losses(model: Model, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None,
                   denom: Optional[torch.Tensor] = None,
                   moe_global: Optional[GlobalMoEStats] = None
                   ) -> Dict[str, torch.Tensor]:
    """The training loss of the model's family on one (micro)batch: a dict
    whose ``"loss"`` is optimized and whose other entries are logged.
    ``draws`` (a generator, or ``{"t", "noise"}``) feeds DiffuSeq's random
    draws; GPT-2's loss takes none. ``denom``, when given, is the masked
    means' denominator (a global microbatch's ``loss_count``, clamped to
    >= 1), and the result is this batch's share of them; ``moe_global``
    does the same for an MoE model's aux."""
    if model.family == "diffuseq":
        if draws is None:
            raise ValueError("the diffuseq loss needs draws: a "
                             "torch.Generator or {'t', 'noise'} tensors")
        return diffuseq_losses(model, batch, draws, denom, moe_global)
    return gpt2_losses(model, batch, denom, moe_global)


def loss_count(model: Model, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """The positions the family's masked means average over in ``batch``
    (f32 0-d)."""
    if model.family == "diffuseq":
        return diffuseq_loss_count(batch)
    return gpt2_loss_count(batch)


def sequence_slice(model: Model, batch: Dict[str, torch.Tensor],
                   index: int, size: int) -> Dict[str, torch.Tensor]:
    """Sequence slice ``index`` of ``size`` of a [B, L] microbatch: each
    key's L/size columns at the slice's offset; GPT-2's also carries the
    next slice's first token and its loss mask (``gpt2_sequence_slice``),
    so no target is lost at a slice boundary."""
    if model.family == "gpt2":
        return gpt2_sequence_slice(batch, index, size)
    n = batch["input_ids"].shape[1] // size
    return {k: v[:, index * n:(index + 1) * n] for k, v in batch.items()}


def finish_losses(model: Model, shares: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The metrics of a global microbatch from its summed shares: the
    shares themselves, plus GPT-2's ``ppl`` of the summed NLL (the loss
    less an MoE model's aux term)."""
    if model.family == "gpt2":
        return {**shares, "ppl": gpt2_ppl(shares["nll"])}
    return dict(shares)
