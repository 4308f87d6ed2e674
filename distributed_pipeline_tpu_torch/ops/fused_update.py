"""Fused AdamW + EMA weight update: the port of
``distributed_pipeline_tpu/ops/fused_update.py``.

The trainer keeps every state copy (params, grads, mu, nu, and the R EMA
copies as one ``[R, n]`` buffer) as flat f32 buffers, so the whole update
is one pass over them, **in place**:

* :func:`fused_adamw_ema` wraps the CUDA kernel
  (``ops/csrc/fused_update.cu``): one launch per step, CUDA tensors only,
  with a launch count;
* :func:`torch_fused_update` is the plain version: optax's op sequence in
  separate torch ops (the ``fused_update false`` arm), bit-identical to the
  kernel on the card and within an ulp of the JAX package on the CPU.

The op order is optax's (``mu' = (1-b1) g + b1 mu``;
``nu' = (1-b2) g^2 + b2 nu``; ``u = (mu'/bc1) / (sqrt(nu'/bc2) + eps)``;
``u += wd p``; ``u *= -lr``; ``p' = p + u``; ``e' = e r + p' (1-r)``).
``torch.optim.AdamW`` cannot stand in for it: it decays ``p *= 1 - lr wd``
before the step and divides by ``sqrt(nu)/sqrt(bc2) + eps``.

The per-step scalars ``(-lr, bc1, bc2)`` are a ``[3]`` f32 tensor on the
buffers' device (:func:`update_scalars`), computed from the step count by
torch ops as ``fused_adamw_ema`` computes them in the JAX package, so a
step never waits on the host. The constants ``1-b1``, ``1-b2`` and ``1-r``
are computed in double and rounded once to f32, as JAX's weak-typed
constants are.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Sequence

import torch

__all__ = ["fused_adamw_ema", "torch_fused_update", "resolve_fused_update", "update_scalars", "update_hbm_bytes",
           "launch_count", "reset_launch_count", "B1", "B2", "EPS"]

B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adamw's defaults, as the trainer
_MAX_RATES = 8                   # the kernel's EMA slots

_TRUE = ("true", "on", "yes", "1")
_FALSE = ("false", "off", "no", "0")

# Launches of the CUDA kernel since the last reset: one per call.
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def resolve_fused_update(val: Any, device: torch.device) -> bool:
    """``--fused_update`` for buffers on ``device``: ``auto`` = the kernel
    for CUDA, the plain version otherwise; ``true`` = the kernel (raises off
    CUDA); ``false`` = the plain version."""
    s = str(val).strip().lower()
    on_cuda = torch.device(device).type == "cuda"
    if s == "auto":
        return on_cuda
    if s in _TRUE:
        if not on_cuda:
            raise ValueError(f"fused_update=true needs CUDA tensors, got "
                             f"tensors on {device}")
        return True
    if s in _FALSE:
        return False
    raise ValueError(f"fused_update must be auto/true/false, got {val!r}")


def update_scalars(count: torch.Tensor,
                   lr_fn: Callable[[torch.Tensor], torch.Tensor],
                   b1: float = B1, b2: float = B2) -> torch.Tensor:
    """``[3]`` f32 ``(-lr, bc1, bc2)`` for the step after ``count`` (int32
    scalar tensor, the pre-increment count): ``bc = 1 - beta**(count+1)``
    and ``-lr_fn(count)``, the expressions optax evaluates."""
    inc = (count + 1).to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=count.device), inc)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=count.device), inc)
    step_size = -lr_fn(count).to(torch.float32)
    return torch.stack([step_size, bc1, bc2])


def _coefs(rates: Sequence[float], weight_decay: float, b1: float, b2: float,
           eps: float):
    """The f32 constants of both arms, each rounded once from double."""
    vals = [b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
            *rates, *(1.0 - r for r in rates)]
    return (ctypes.c_float * len(vals))(*vals)


def torch_fused_update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                       nu: torch.Tensor, ema: torch.Tensor,
                       scalars: torch.Tensor, rates: Sequence[float], *,
                       weight_decay: float = 0.0, b1: float = B1,
                       b2: float = B2, eps: float = EPS) -> None:
    """The plain version, in place: optax's op sequence, one torch op per
    step of it. ``ema`` is ``[R, n]`` (``R = len(rates)``)."""
    c = [float(x) for x in _coefs(rates, weight_decay, b1, b2, eps)]
    cb1, comb1, cb2, comb2, ceps, cwd = c[:6]
    n_r = len(rates)
    step_size, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    m = comb1 * g + cb1 * mu
    v = comb2 * (g * g) + cb2 * nu
    u = (m / bc1) / (torch.sqrt(v / bc2) + ceps)
    u = u + cwd * p
    u = step_size * u
    pn = p + u
    p.copy_(pn)
    mu.copy_(m)
    nu.copy_(v)
    for i in range(n_r):
        ema[i].copy_(ema[i] * c[6 + i] + pn * c[6 + n_r + i])


def fused_adamw_ema(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                    nu: torch.Tensor, ema: torch.Tensor,
                    scalars: torch.Tensor, rates: Sequence[float], *,
                    weight_decay: float = 0.0, b1: float = B1,
                    b2: float = B2, eps: float = EPS) -> None:
    """The kernel, in place over flat contiguous f32 CUDA buffers: ``p``,
    ``g``, ``mu``, ``nu`` [n], ``ema`` [R, n], ``scalars`` [3]."""
    global _launches
    n = p.numel()
    for name, t, shape in (("p", p, (n,)), ("g", g, (n,)), ("mu", mu, (n,)),
                           ("nu", nu, (n,)), ("ema", ema, (len(rates), n)),
                           ("scalars", scalars, (3,))):
        if t.device.type != "cuda":
            raise ValueError(f"fused_adamw_ema is the CUDA kernel and takes "
                             f"CUDA tensors, got {name} on {t.device}; the "
                             f"plain version is torch_fused_update")
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != p.device):
            raise ValueError(f"fused_adamw_ema: {name} must be a contiguous "
                             f"f32 {shape} tensor on {p.device}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if len(rates) > _MAX_RATES:
        raise ValueError(f"fused_adamw_ema takes at most {_MAX_RATES} EMA "
                         f"rates, got {len(rates)}")
    from ._build import check, load_library
    lib = load_library()
    coefs = _coefs(rates, weight_decay, b1, b2, eps)
    with torch.cuda.device(p.device):
        err = lib.dpt_fused_update(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            ema.data_ptr(), scalars.data_ptr(), n, coefs, len(rates),
            torch.cuda.current_stream().cuda_stream)
    check(lib, err, "fused_adamw_ema")
    _launches += 1


def update_hbm_bytes(leaf_sizes: Sequence[int], n_ema_rates: int,
                     dtype_bytes: int = 4, per_leaf_scalars: bool = True
                     ) -> int:
    """Device-memory bytes one update step moves: ``(4 + R)`` reads and
    ``(3 + R)`` writes of every element. ``per_leaf_scalars=True`` is the
    JAX package's census (each leaf's kernel reads a broadcast scalar row
    of 3 x 128 f32); ``False`` prices the CUDA kernel, one launch over the
    flat buffers reading the 3 scalars once."""
    total = sum((4 + n_ema_rates + 3 + n_ema_rates) * int(n) * dtype_bytes
                for n in leaf_sizes)
    if per_leaf_scalars:
        return int(total + len(leaf_sizes) * 3 * 4 * 128)
    return int(total + 3 * 4)
