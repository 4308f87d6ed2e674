"""Gaussian diffusion for embedding-space text diffusion: the port of
``distributed_pipeline_tpu/models/diffusion.py`` (a copy: the port imports
nothing of the JAX package, not even its numpy-only modules).

The noise schedules are built in float64 with numpy and stored as float32,
exactly as the JAX package builds them, so both packages hold bitwise the
same tables. ``q_sample`` and ``mean_flat_tT`` work on tensors;
``sample_t`` draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["DiffusionSchedule", "make_schedule", "named_beta_schedule"]


def _betas_for_alpha_bar(T: int, alpha_bar_fn,
                         max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(T):
        t1, t2 = i / T, (i + 1) / T
        betas.append(min(1 - alpha_bar_fn(t2) / alpha_bar_fn(t1), max_beta))
    return np.asarray(betas, dtype=np.float64)


def named_beta_schedule(name: str, T: int) -> np.ndarray:
    """Noise schedules: "sqrt" (DiffuSeq's default for text embeddings),
    "cosine" (Nichol & Dhariwal), "linear" (DDPM); float64 [T]."""
    if name == "sqrt":
        return _betas_for_alpha_bar(T, lambda t: 1 - math.sqrt(t + 0.0001))
    if name == "cosine":
        return _betas_for_alpha_bar(
            T, lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    if name == "linear":
        scale = 1000 / T
        return np.linspace(scale * 1e-4, scale * 0.02, T, dtype=np.float64)
    raise ValueError(f"unknown noise schedule: {name}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The schedule's [T] float32 tables (numpy), and the forward process
    on tensors. Each table is copied to a device once, on first use there."""

    num_steps: int
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    _on_device: Dict[Tuple[str, str], torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def table(self, name: str, device) -> torch.Tensor:
        """The f32 table ``name`` as a tensor on ``device`` (cached)."""
        key = (name, str(device))
        if key not in self._on_device:
            # non-blocking: the copy from pageable memory is staged before
            # the call returns, and no stream synchronization follows (a
            # first training step under --sanitize may make it)
            self._on_device[key] = torch.from_numpy(
                getattr(self, name)).to(device, non_blocking=True)
        return self._on_device[key]

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """``x_t ~ q(x_t | x_0)``: ``t`` is an integer [B] tensor, broadcast
        over the trailing dims of ``x_start`` [B, L, E]."""
        shape = (-1,) + (1,) * (x_start.dim() - 1)
        a = self.table("sqrt_alphas_cumprod", x_start.device).to(
            x_start.dtype)[t.long()].reshape(shape)
        s = self.table("sqrt_one_minus_alphas_cumprod", x_start.device).to(
            x_start.dtype)[t.long()].reshape(shape)
        return a * x_start + s * noise

    def sample_t(self, generator: torch.Generator, batch: int
                 ) -> torch.Tensor:
        """Uniform timesteps, int32 [batch], on the generator's device."""
        return torch.randint(0, self.num_steps, (batch,),
                             generator=generator, device=generator.device,
                             dtype=torch.int32)

    def mean_flat_tT(self, x_start: torch.Tensor) -> torch.Tensor:
        """Per-position ``||sqrt(abar_T) x_0||^2`` mean over the embedding
        dim (pushes the last latent toward the N(0, I) prior), [B, L]."""
        aT = float(self.sqrt_alphas_cumprod[-1])
        return torch.mean((aT * x_start) ** 2, dim=-1)


def make_schedule(name: str = "sqrt",
                  num_steps: int = 2000) -> DiffusionSchedule:
    betas = named_beta_schedule(name, num_steps)
    alphas_cumprod = np.cumprod(1.0 - betas)
    return DiffusionSchedule(
        num_steps=num_steps,
        betas=betas.astype(np.float32),
        alphas_cumprod=alphas_cumprod.astype(np.float32),
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod).astype(np.float32),
        sqrt_one_minus_alphas_cumprod=np.sqrt(
            1 - alphas_cumprod).astype(np.float32),
    )
