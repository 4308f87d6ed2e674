"""Model factory: the port of ``distributed_pipeline_tpu/models/__init__.py``.

``create_model_from_config(**training_args)`` builds the model a run
directory's ``training_args.json`` describes, ignoring the training-only keys
in it. This slice serves the ``gpt2`` family; ``diffuseq`` comes with the
training slice (ROADMAP A.6).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .gpt2 import GPT2Model

__all__ = ["PRESETS", "create_model_from_config", "GPT2Model", "torch_dtype"]

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
                             num_heads: int = 0, dtype: str = "bfloat16",
                             device=None, **_unused: Any) -> GPT2Model:
    """The model for (a superset of) the JAX package's ``TrainSettings``
    fields; preset dims are overridden by nonzero hidden/layers/heads. The
    parameters are zeros until a state dict is loaded."""
    if model_family not in PRESETS:
        raise ValueError(f"unknown model family: {model_family!r}; "
                         f"available: {sorted(PRESETS)}")
    if model_family == "diffuseq":
        raise NotImplementedError(
            "the diffuseq family comes with the training slice (ROADMAP A.6)")
    preset = PRESETS[model_family].get(model_size)
    if preset is None:
        raise ValueError(f"no preset {model_size!r} for family "
                         f"{model_family!r}; available: "
                         f"{sorted(PRESETS[model_family])}")
    return GPT2Model(vocab_size=vocab_size, seq_len=seq_len,
                     hidden_size=hidden_size or preset[0],
                     num_layers=num_layers or preset[1],
                     num_heads=num_heads or preset[2],
                     dtype=torch_dtype(dtype), device=device)
