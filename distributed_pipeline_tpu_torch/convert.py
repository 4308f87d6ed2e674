"""Weight bridge between the JAX package's flax parameter tree and the
port's ``state_dict``.

The port names every parameter by its flax path (``word_emb.embedding``,
``backbone.block_0.attn.qkv``, ``backbone.ln_f.scale``, ...), so the bridge
is a flatten/unflatten of nested dicts of numpy arrays; no array is
reshaped or transposed. :func:`init_params` draws the JAX initializers'
distributions with numpy, which gives full-width weights without JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_flax", "params_to_flax", "init_params"]


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


def init_params(cfg: Mapping[str, int], seed: int) -> Dict[str, torch.Tensor]:
    """Random GPT-2 weights with the JAX initializers' distributions:
    embeddings ``normal(0.02)``, every dense kernel ``normal(fan_in**-0.5)``,
    LayerNorm scales one and biases zero. ``cfg`` holds ``vocab_size``,
    ``seq_len``, ``hidden_size``, ``num_layers`` and ``num_heads``; the
    result is an f32 state dict for ``GPT2Model.load_state_dict``."""
    rng = np.random.default_rng(seed)
    V, L = cfg["vocab_size"], cfg["seq_len"]
    D, H = cfg["hidden_size"], cfg["num_heads"]
    dh = D // H

    def normal(std: float, *shape: int) -> torch.Tensor:
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    def layer_norm(prefix: str) -> Dict[str, torch.Tensor]:
        return {f"{prefix}.scale": torch.ones(D),
                f"{prefix}.bias": torch.zeros(D)}

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
