"""Device choice for the port's entry points: CUDA unless the caller asks
for the CPU. There is no silent CPU path.

A rank of a multi-process run (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` in
its environment, set by ``parallel/launcher.py`` or torchrun) takes
``cuda:{LOCAL_RANK}`` when the host has a card for every local rank, and
``cuda:0`` when the ranks have to share one."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "ranks_share_card"]


def _local_rank_and_size() -> tuple:
    rank = int(os.environ.get("LOCAL_RANK", "0"))
    size = int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))
    return rank, size


def ranks_share_card() -> bool:
    """True when this host runs more local ranks than it has CUDA
    devices, so the ranks share ``cuda:0``."""
    return _local_rank_and_size()[1] > torch.cuda.device_count()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/"" -> ``cuda`` (raises when CUDA is unavailable), which on a
    host of several local ranks is this rank's card; anything else is
    taken as given, and a CUDA device still has to exist."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the GPU "
                           "unless a CPU run is asked for (--device cpu)")
    rank, size = _local_rank_and_size()
    if dev.type == "cuda" and dev.index is None and size > 1:
        dev = torch.device("cuda", 0 if ranks_share_card() else rank)
    return dev
