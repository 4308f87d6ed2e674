"""Quantized serving weights: int8 storage with a round-trip guard, the port
of ``distributed_pipeline_tpu/serving/quantize.py``.

``--serve_quant int8`` rounds every float weight to symmetric int8 at load
— per-channel scales for matrices, per-tensor for vectors — and
dequantizes it back to its own dtype at once: storage quantization, not
compute quantization. The model keeps its dtypes and shapes and serves on
weights that have lost sub-scale precision.

The arithmetic is the JAX package's numpy code, so a tree quantized here
is bitwise the JAX one converted. The channel axis is the JAX leaf's last
axis, which is the last axis of the port's tensor too: ``convert.py`` keeps
every flax layout as it is (``qkv`` [D, 3, H, Dh], ``mlp.wi`` [D, 4D], the
embedding [V, D]).

THE GUARD: :func:`quantize_state_dict` measures each leaf's round-trip
error and raises :class:`QuantizationError` when a leaf is non-finite or
its relative error exceeds ``max_rel_err``, so a corrupt checkpoint fails
at load.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["QuantizationError", "quantize_state_dict", "quantize_leaf"]

Q8_MAX = 127.0


class QuantizationError(RuntimeError):
    """A leaf failed the round-trip guard: abort the load."""


def quantize_leaf(x: torch.Tensor, max_rel_err: float) -> torch.Tensor:
    """int8 round-trip one leaf, guarded (the JAX ``quantize_leaf``).
    Channel scales along the LAST axis for ndim >= 2, per-tensor for
    vectors and scalars; all-zero channels pass through. A leaf that is
    not floating point is returned as it is."""
    if not x.is_floating_point():
        return x
    arr = x.detach().cpu().numpy()
    f = arr.astype(np.float32)
    if not np.all(np.isfinite(f)):
        raise QuantizationError(f"non-finite leaf {arr.shape} {arr.dtype}")
    axes = tuple(range(arr.ndim - 1)) if arr.ndim >= 2 else None
    amax = np.max(np.abs(f), axis=axes, keepdims=arr.ndim >= 2)
    scale = amax / Q8_MAX
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.round(f / safe), -Q8_MAX, Q8_MAX)
    deq = (q * safe).astype(np.float32)
    denom = max(float(np.max(np.abs(f))), 1e-12)
    err = float(np.max(np.abs(deq - f))) / denom
    # int8 symmetric round-trip error is <= scale/2 per element, ~0.4% of
    # the channel max: past the bound the leaf (or the checkpoint) is
    # broken, not borderline
    if err > max_rel_err:
        raise QuantizationError(
            f"leaf {arr.shape} round-trip rel err {err:.4f} > "
            f"{max_rel_err:.4f}")
    return torch.from_numpy(deq.astype(arr.dtype)).to(x.device)


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor],
                        max_rel_err: float = 0.02
                        ) -> Dict[str, torch.Tensor]:
    """Quantize every float leaf of a state dict (module docstring).
    Raises :class:`QuantizationError` on the first failing leaf."""
    return {k: quantize_leaf(v, max_rel_err) for k, v in state_dict.items()}
