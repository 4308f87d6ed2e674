"""Device-side input prefetch: the port of
``distributed_pipeline_tpu/data/device_prefetch.py``.

``prefetch_to_device(iterator, device, depth)`` keeps ``depth`` host batches
ahead of the consumer. On a CUDA device each batch is copied into pinned
host memory and from there to the device on a side stream, so the copy of
batch N+1 overlaps step N; the consumer's stream waits on the copy's event
before it reads the batch. On the CPU the batches are only turned into
tensors ``depth`` ahead. Prefetching changes WHEN a batch is transferred,
never WHICH batch the underlying iterator yields next, so the data order,
and the resume fast-forward of ``run/train.py``, are the same at any depth.
"""

from __future__ import annotations

import collections
from typing import Deque, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["prefetch_to_device"]

Batch = Dict[str, torch.Tensor]


def _to_tensors(batch: Dict[str, np.ndarray]) -> Batch:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def prefetch_to_device(iterator: Iterator[Dict[str, np.ndarray]],
                       device: torch.device, depth: int
                       ) -> Iterator[Batch]:
    """Yield the iterator's batches as tensors on ``device``, ``depth``
    (>= 1) of them read and in transfer ahead of the one yielded."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    ring: Deque[Tuple[Batch, Optional[torch.cuda.Event]]] = \
        collections.deque()

    def put(batch: Dict[str, np.ndarray]) -> None:
        host = _to_tensors(batch)
        if not cuda:
            ring.append((host, None))
            return
        host = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(side):
            dev = {k: v.to(device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        ring.append((dev, done))

    def fill() -> None:
        while len(ring) < depth:
            try:
                put(next(iterator))
            except StopIteration:
                return

    fill()
    while ring:
        batch, done = ring.popleft()
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for t in batch.values():
                # the batch was allocated on the side stream: tell the
                # caching allocator the consumer's stream uses it too
                t.record_stream(stream)
        fill()
        yield batch
