"""Weight bridge between the JAX package's flax parameter tree and the
port's ``state_dict``.

The port names every parameter by its flax path (``word_emb.embedding``,
``backbone.block_0.attn.qkv``, ``backbone.ln_f.scale``, ...), so the bridge
is a flatten/unflatten of nested dicts of numpy arrays (an MoE block's
``backbone.block_i.moe.{router,wi,wo}`` included); no array is reshaped or
transposed. Trees shaped like the parameters (the Adam moments,
each EMA copy) convert with the same mapping. :func:`init_params` draws the
JAX initializers' distributions with numpy, for either family, which gives
full-width weights without JAX.

A stacked (``scan_layers``) model's blocks are one ``backbone.blocks``
module whose weights carry a leading ``[num_layers]`` dim, the JAX
``params/backbone/blocks/{qkv, ...}`` tree, so the flax bridge holds for
it as it is. :func:`stack_blocks` and :func:`unstack_blocks` move a state
dict between the named blocks (``backbone.block_i.attn.qkv``, ...) and the
stacked ones (``backbone.blocks.qkv[i]``; an MoE model's groups
``backbone.blocks.dense_qkv[g, j]`` and ``backbone.blocks.moe_qkv[g]``,
the JAX ``MoEScanBlocks`` layout), and :func:`to_layout` gives a state
dict the layout a model's parameter names ask for, so a stacked
checkpoint loads into the named-block model and the reverse.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.diffuseq import DIFFUSEQ_EMB_DIM

__all__ = ["params_from_flax", "params_to_flax", "init_params",
           "opt_state_from_optax", "stack_blocks", "unstack_blocks",
           "to_layout", "STACKED_FROM_NAMED", "MOE_FROM_NAMED"]

# a named block's leaf -> its stacked weight (models/pipeline.py)
STACKED_FROM_NAMED = {"ln1.scale": "ln1_scale", "ln1.bias": "ln1_bias",
                      "attn.qkv": "qkv", "attn.out": "out",
                      "ln2.scale": "ln2_scale", "ln2.bias": "ln2_bias",
                      "mlp.wi": "wi", "mlp.wo": "wo"}
_NAMED = "backbone.block_"
_STACKED = "backbone.blocks."


def _num_named_layers(state: Mapping[str, Any]) -> int:
    return len({k[len(_NAMED):].split(".")[0] for k in state
                if k.startswith(_NAMED)})


# an MoE block's router and experts -> the MoE groups' weights
MOE_FROM_NAMED = {"moe.router": "router", "moe.wi": "wi", "moe.wo": "wo"}


def _moe_every(state: Mapping[str, Any]) -> int:
    """The MoE period of a named state (0 without MoE blocks): block i is
    an MoE block when ``i % moe_every == moe_every - 1``, so the first
    one sits at ``moe_every - 1``."""
    moe = sorted(int(k[len(_NAMED):].split(".")[0]) for k in state
                 if k.startswith(_NAMED) and k.endswith(".moe.router"))
    return moe[0] + 1 if moe else 0


def _rows(state: Mapping[str, Any], layers, leaf: str) -> torch.Tensor:
    return torch.stack([torch.as_tensor(state[f"{_NAMED}{i}.{leaf}"])
                        for i in layers])


def stack_blocks(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Named blocks -> stacked: ``backbone.block_i.<leaf>`` of every i
    stacked in layer order into ``backbone.blocks.<name>``; with MoE
    blocks (every ``moe_every``-th) into the JAX ``MoEScanBlocks`` groups:
    group g's dense layers ``g*me .. g*me + me-2`` into ``dense_<name>
    [G, me-1, ...]`` and its MoE block ``g*me + me-1`` into ``moe_<name>
    [G, ...]``. The other keys as they are. Raises ``KeyError`` for a
    block the stacked layout cannot hold."""
    n = _num_named_layers(state)
    out = {k: v for k, v in state.items() if not k.startswith(_NAMED)}
    if not n:
        return out
    me = _moe_every(state)
    if not me:
        for leaf, name in STACKED_FROM_NAMED.items():
            out[_STACKED + name] = _rows(state, range(n), leaf)
    else:
        if n % me:
            raise KeyError(f"{n} named blocks do not group by moe_every "
                           f"{me}")
        G = n // me
        moe = [g * me + me - 1 for g in range(G)]
        for leaf, name in STACKED_FROM_NAMED.items():
            if me > 1:
                out[f"{_STACKED}dense_{name}"] = torch.stack(
                    [_rows(state, range(g * me, g * me + me - 1), leaf)
                     for g in range(G)])
            if not leaf.startswith("mlp."):
                out[f"{_STACKED}moe_{name}"] = _rows(state, moe, leaf)
        for leaf, name in MOE_FROM_NAMED.items():
            out[f"{_STACKED}moe_{name}"] = _rows(state, moe, leaf)
    used = {f"{_NAMED}{i}.{leaf}" for i in range(n)
            for leaf in list(STACKED_FROM_NAMED) + list(MOE_FROM_NAMED)}
    extra = set(state) - set(out) - used
    if extra:
        raise KeyError(f"stacked blocks hold no {sorted(extra)[0]}")
    return out


def unstack_blocks(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Stacked blocks -> named: row i of ``backbone.blocks.<name>`` to
    ``backbone.block_i.<leaf>`` (the MoE groups' rows back to their
    layers); the other keys as they are."""
    out = {k: v for k, v in state.items() if not k.startswith(_STACKED)}
    if _STACKED + "moe_qkv" in state:
        G = state[_STACKED + "moe_qkv"].shape[0]
        dense = state.get(_STACKED + "dense_qkv")
        me = (dense.shape[1] if dense is not None else 0) + 1
        for leaf, name in STACKED_FROM_NAMED.items():
            for g in range(G):
                for j in range(me - 1):
                    out[f"{_NAMED}{g * me + j}.{leaf}"] = \
                        state[f"{_STACKED}dense_{name}"][g][j]
                if not leaf.startswith("mlp."):
                    out[f"{_NAMED}{g * me + me - 1}.{leaf}"] = \
                        state[f"{_STACKED}moe_{name}"][g]
        for leaf, name in MOE_FROM_NAMED.items():
            for g in range(G):
                out[f"{_NAMED}{g * me + me - 1}.{leaf}"] = \
                    state[f"{_STACKED}moe_{name}"][g]
        return out
    if _STACKED + "qkv" not in state:
        return out
    n = state[_STACKED + "qkv"].shape[0]
    for leaf, name in STACKED_FROM_NAMED.items():
        rows = state[_STACKED + name]
        for i in range(n):
            out[f"{_NAMED}{i}.{leaf}"] = rows[i]
    return out


def _stacked(keys) -> bool:
    return _STACKED + "qkv" in keys or _STACKED + "moe_qkv" in keys


def to_layout(state: Mapping[str, Any], names) -> Mapping[str, Any]:
    """``state`` in the block layout that the parameter ``names`` use
    (stacked when they hold ``backbone.blocks.qkv`` or, for MoE groups,
    ``backbone.blocks.moe_qkv``; else named): as it is when it already
    is, else stacked or unstacked."""
    stacked_model = _stacked(set(names))
    if _stacked(state) == stacked_model:
        return state
    return stack_blocks(state) if stacked_model else unstack_blocks(state)

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
    ``num_layers`` and ``num_heads``, and for a mixture of experts
    ``moe_experts`` and ``moe_every`` (an MoE block draws ``router`` and
    ``wi`` ``normal(D**-0.5)``, ``wo`` ``normal((4D)**-0.5)``, the JAX
    ``_dense_init``); the result is an f32 state dict for the model's
    ``load_state_dict``. With ``scan_layers`` the blocks come stacked
    (:func:`stack_blocks` of the same draws: a stacked and a named model
    from one seed hold the same weights)."""
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
    n_exp = cfg.get("moe_experts", 0)
    every = cfg.get("moe_every", 2)
    for i in range(cfg["num_layers"]):
        p = f"backbone.block_{i}"
        sd.update(layer_norm(f"{p}.ln1"))
        sd[f"{p}.attn.qkv"] = normal(D ** -0.5, D, 3, H, dh)
        sd[f"{p}.attn.out"] = normal(D ** -0.5, H, dh, D)
        sd.update(layer_norm(f"{p}.ln2"))
        if n_exp > 0 and i % every == every - 1:
            sd[f"{p}.moe.router"] = normal(D ** -0.5, D, n_exp)
            sd[f"{p}.moe.wi"] = normal(D ** -0.5, n_exp, D, 4 * D)
            sd[f"{p}.moe.wo"] = normal((4 * D) ** -0.5, n_exp, 4 * D, D)
        else:
            sd[f"{p}.mlp.wi"] = normal(D ** -0.5, D, 4 * D)
            sd[f"{p}.mlp.wo"] = normal((4 * D) ** -0.5, 4 * D, D)
    sd.update(layer_norm("backbone.ln_f"))
    return stack_blocks(sd) if cfg.get("scan_layers") else sd


def opt_state_from_optax(opt_state: Any) -> Dict[str, Any]:
    """An ``optax.adamw`` state (``ScaleByAdamState`` first, as the JAX
    trainer builds it) -> the port's ``{"mu", "nu", "count"}``."""
    adam = opt_state[0]
    return {"mu": params_from_flax(adam.mu), "nu": params_from_flax(adam.nu),
            "count": int(np.asarray(adam.count))}
