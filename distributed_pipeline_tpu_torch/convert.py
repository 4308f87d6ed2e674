"""Weight bridge between the JAX package's flax parameter tree and the
port's ``state_dict``.

The port names every parameter by its flax path (``word_emb.embedding``,
``backbone.block_0.attn.qkv``, ``backbone.ln_f.scale``, ...), so the bridge
is a flatten/unflatten of nested dicts of numpy arrays; no array is
reshaped or transposed. Trees shaped like the parameters (the Adam moments,
each EMA copy) convert with the same mapping. :func:`init_params` draws the
JAX initializers' distributions with numpy, for either family, which gives
full-width weights without JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.diffuseq import DIFFUSEQ_EMB_DIM

__all__ = ["params_from_flax", "params_to_flax", "init_params",
           "opt_state_from_optax"]

# the standard deviation of a unit normal truncated to [-2, 2] (flax's
# variance_scaling divides by it so the truncated draw keeps the variance)
_TRUNC_STD = .87962566103423978


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Unboxed flax parameters (``{"params": {...}}`` or the inner dict,
    nested dicts of arrays) -> a state dict keyed by dotted flax path."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, value in node.items():
            key = f"{prefix}{name}"
            if isinstance(value, Mapping):
                walk(value, key + ".")
            else:
                out[key] = torch.from_numpy(np.array(value))
    walk(tree, "")
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`: ``{"params": nested dict of
    numpy arrays}``."""
    root: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = root
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value.detach().cpu().numpy()
    return {"params": root}


def init_params(cfg: Mapping[str, Any], seed: int) -> Dict[str, torch.Tensor]:
    """Random weights of the ``model_family`` in ``cfg`` (default
    ``gpt2``) with the JAX initializers' distributions: embeddings and
    ``pos_emb`` ``normal(0.02)``, the backbone's dense kernels and
    DiffuSeq's ``in_proj``/``out_proj`` ``normal(fan_in**-0.5)``, the time
    MLP flax's default ``lecun_normal`` (a normal truncated at two standard
    deviations, rescaled to variance ``1/fan_in``), biases zero, LayerNorm
    scales one. ``cfg`` holds ``vocab_size``, ``seq_len``, ``hidden_size``,
    ``num_layers`` and ``num_heads``; the result is an f32 state dict for
    the model's ``load_state_dict``."""
    rng = np.random.default_rng(seed)
    V, L = cfg["vocab_size"], cfg["seq_len"]
    D, H = cfg["hidden_size"], cfg["num_heads"]
    dh = D // H

    def normal(std: float, *shape: int) -> torch.Tensor:
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    def lecun_normal(fan_in: int, fan_out: int) -> torch.Tensor:
        x = rng.standard_normal((fan_in, fan_out))
        out = np.abs(x) > 2.0
        while out.any():
            x[out] = rng.standard_normal(int(out.sum()))
            out = np.abs(x) > 2.0
        std = fan_in ** -0.5 / _TRUNC_STD
        return torch.from_numpy((x * std).astype(np.float32))

    def layer_norm(prefix: str) -> Dict[str, torch.Tensor]:
        return {f"{prefix}.scale": torch.ones(D),
                f"{prefix}.bias": torch.zeros(D)}

    if cfg.get("model_family", "gpt2") == "diffuseq":
        E = DIFFUSEQ_EMB_DIM
        sd = {"word_emb.embedding": normal(0.02, V, E),
              "in_proj.kernel": normal(E ** -0.5, E, D),
              "in_proj.bias": torch.zeros(D),
              "time_mlp.layers_0.kernel": lecun_normal(D, 4 * D),
              "time_mlp.layers_0.bias": torch.zeros(4 * D),
              "time_mlp.layers_2.kernel": lecun_normal(4 * D, D),
              "time_mlp.layers_2.bias": torch.zeros(D),
              "pos_emb": normal(0.02, L, D),
              "out_proj.kernel": normal(D ** -0.5, D, E),
              "out_proj.bias": torch.zeros(E)}
    else:
        sd = {"word_emb.embedding": normal(0.02, V, D),
              "pos_emb": normal(0.02, L, D)}
    for i in range(cfg["num_layers"]):
        p = f"backbone.block_{i}"
        sd.update(layer_norm(f"{p}.ln1"))
        sd[f"{p}.attn.qkv"] = normal(D ** -0.5, D, 3, H, dh)
        sd[f"{p}.attn.out"] = normal(D ** -0.5, H, dh, D)
        sd.update(layer_norm(f"{p}.ln2"))
        sd[f"{p}.mlp.wi"] = normal(D ** -0.5, D, 4 * D)
        sd[f"{p}.mlp.wo"] = normal((4 * D) ** -0.5, 4 * D, D)
    sd.update(layer_norm("backbone.ln_f"))
    return sd


def opt_state_from_optax(opt_state: Any) -> Dict[str, Any]:
    """An ``optax.adamw`` state (``ScaleByAdamState`` first, as the JAX
    trainer builds it) -> the port's ``{"mu", "nu", "count"}``."""
    adam = opt_state[0]
    return {"mu": params_from_flax(adam.mu), "nu": params_from_flax(adam.nu),
            "count": int(np.asarray(adam.count))}
