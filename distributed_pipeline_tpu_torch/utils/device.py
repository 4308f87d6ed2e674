"""Device choice for the port's entry points: CUDA unless the caller asks
for the CPU. There is no silent CPU path."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/"" -> ``cuda`` (raises when CUDA is unavailable); anything
    else is taken as given, and a CUDA device still has to exist."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the GPU "
                           "unless a CPU run is asked for (--device cpu)")
    return dev
