"""Model factory: the port of ``distributed_pipeline_tpu/models/__init__.py``.

``create_model_from_config(**training_args)`` builds the model a run
directory's ``training_args.json`` describes, ignoring the training-only keys
in it: a :class:`DiffuSeqModel` (holding its diffusion schedule) or a
:class:`GPT2Model`. ``compute_losses(model, batch, draws)`` is the one loss
seam the trainer calls for either family, in place of the JAX ``Workload``'s
``compute_losses``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from .diffuseq import (DIFFUSEQ_EMB_DIM, DiffuSeqModel, Draws,
                       diffuseq_losses)
from .diffusion import make_schedule
from .gpt2 import GPT2Model, gpt2_losses

__all__ = ["PRESETS", "create_model_from_config", "compute_losses",
           "GPT2Model", "DiffuSeqModel", "gpt2_losses", "diffuseq_losses",
           "torch_dtype", "Model"]

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
                             **_unused: Any) -> Model:
    """The model for (a superset of) the JAX package's ``TrainSettings``
    fields; preset dims are overridden by nonzero hidden/layers/heads. The
    parameters are zeros until a state dict is loaded."""
    if model_family not in PRESETS:
        raise ValueError(f"unknown model family: {model_family!r}; "
                         f"available: {sorted(PRESETS)}")
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
                attention_impl=attention_impl)
    if model_family == "diffuseq":
        return DiffuSeqModel(**dims, emb_dim=DIFFUSEQ_EMB_DIM,
                             schedule=make_schedule(noise_schedule,
                                                    diffusion_steps))
    return GPT2Model(**dims)


def compute_losses(model: Model, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
    """The training loss of the model's family on one (micro)batch: a dict
    whose ``"loss"`` is optimized and whose other entries are logged.
    ``draws`` (a generator, or ``{"t", "noise"}``) feeds DiffuSeq's random
    draws; GPT-2's loss takes none."""
    if model.family == "diffuseq":
        if draws is None:
            raise ValueError("the diffuseq loss needs draws: a "
                             "torch.Generator or {'t', 'noise'} tensors")
        return diffuseq_losses(model, batch, draws)
    return gpt2_losses(model, batch)
