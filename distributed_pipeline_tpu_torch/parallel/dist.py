"""The communication shim over ``torch.distributed``: the port of
``distributed_pipeline_tpu/parallel/dist.py``.

The same call sites work under a multi-process launch and in a bare single
process: with nothing in the environment to join, ``setup_dist`` does
nothing and every primitive is the identity (rank 0 of 1), the reference
contract.

A launch is detectable from torch's ``env://`` keys (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK``), which
``parallel/launcher.py`` (or torchrun) sets on every worker. Backend rule,
logged once at start:

* NCCL when the rank is on a CUDA device of its own (the host has a card
  for every local rank, ``utils/device.py``);
* gloo on the CPU, or when ranks share a card: NCCL refuses two ranks on
  one device. Gloo takes CUDA tensors as they are (it copies through host
  memory inside the collective), so the ranks run the same kernels on the
  same card either way.

Sequence parallelism (``--sequence N``) splits the ranks as the JAX mesh
orders its devices, data before sequence: rank r is data index ``r // N``
and sequence index ``r % N`` of ``world // N`` data groups.
``sequence_groups`` forms one process group per data index (the mesh's
sequence groups, ``parallel/mesh.py``; every rank forms every group, in
the same order, as ``new_group`` requires), and
``ring_shift`` hands tensors one step round a group's ring with paired
point-to-point sends (``ppermute`` of the JAX ring). Gloo has no
point-to-point operations for CUDA tensors, so ranks that share a card
stage them through host memory; NCCL sends them directly.
``ring_shift_bytes`` counts the bytes this rank has sent round its ring
(the training ledger's collective term).

Pipeline parallelism (``--pipe S``) hands stage activations and their
cotangents between pipe neighbours: ``pipe_exchange`` posts one tick's
frames, the sends and the receives together, in one
``batch_isend_irecv`` (``ppermute`` of the JAX schedules, non-cyclic for
GPipe and 1F1B, cyclic for the interleaved schedule). Under gloo, CUDA
tensors go through pinned host buffers kept across ticks; NCCL sends
them directly. ``pipe_bytes`` counts the bytes this rank has sent.

The sharded training state (``--shard_optimizer``, ``--fsdp``) adds
``reduce_scatter`` and ``all_gather`` over a group of the mesh
(``parallel/mesh.py``) and ``all_reduce`` takes one too. NCCL runs them on
the tensors as they are; under gloo they go through fresh host buffers
(gloo's tensor collectives are CPU collectives), which also lets the
ZeRO-1 shard be a view of the buffer it is reduced from or gathered into.

Under the trainer's ``--sanitize`` guard (``set_sync_debug_mode("error")``)
the collectives that gloo stages through host memory are intended
host<->device transfers: ``all_reduce``, ``reduce_scatter``,
``all_gather`` and ``ring_shift`` lift the guard
around them (``utils/perf.sync_allowed``), as the JAX guard keeps
explicit transfers legal; NCCL's collectives stay under it.

Divergence from the JAX shim: when the environment describes a launch and
the process group fails to form, ``setup_dist`` RAISES. The JAX shim
degrades to one process there; a rank that trained alone on its shard
would log a wrong loss and nobody would see it (ROADMAP C.11).
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import datetime
import functools
import math
import os
import sys
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from ..utils.device import ranks_share_card, resolve_device
from ..utils.perf import sync_allowed
from .launcher import AUTORUN_ENV_FLAG, find_free_port

__all__ = ["is_available", "is_initialized", "setup_dist", "get_rank",
           "get_world_size", "barrier", "dev", "device_count", "broadcast",
           "sync_params", "all_reduce", "all_gather_object", "backend",
           "choose_backend", "find_free_port", "AUTORUN_ENV_FLAG",
           "SequenceGroups", "sequence_groups", "ring_shift",
           "ring_shift_bytes", "new_group", "group_size", "reduce_scatter",
           "all_gather", "PipeGroup", "pipe_exchange", "pipe_bytes"]

_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
# distinct devices of the ring, learned once at setup; bytes this rank has
# sent round its sequence ring
_state = {"device_count": 1, "shift_bytes": 0, "pipe_bytes": 0}


def is_available() -> bool:
    """True when the environment describes a launch to join (torch's
    ``env://`` keys, or the launcher's autorun flag with them)."""
    if not tdist.is_available():
        return False
    return all(k in os.environ for k in _ENV_KEYS)


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def choose_backend(device: torch.device) -> str:
    """``nccl`` for a rank on a CUDA device of its own, else ``gloo``."""
    if device.type == "cuda" and not ranks_share_card():
        return "nccl"
    return "gloo"


@functools.lru_cache(maxsize=None)
def setup_dist(device: Optional[torch.device] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the process group the environment describes, once (later calls
    return at once); nothing to join -> one process. ``device`` is this
    rank's device (default: ``resolve_device()``), which picks the backend
    (``choose_backend``). Raises ``RuntimeError`` when the group fails to
    form within ``timeout_s`` (default: torch's)."""
    if is_initialized() or not is_available():
        return
    device = torch.device(device) if device is not None else resolve_device()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    backend_name = choose_backend(device)
    kw: dict = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend_name == "nccl":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    elif device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        tdist.init_process_group(backend_name, init_method="env://",
                                 world_size=world, rank=rank, **kw)
    except Exception as e:
        raise RuntimeError(
            f"rank {rank} of {world}: the {backend_name} process group did "
            f"not form ({type(e).__name__}: {e}); a rank does not train "
            f"alone on its shard") from e
    # tear the group (and every subgroup's gloo threads) down before the
    # interpreter's own teardown, which can otherwise destroy a joinable
    # worker thread and abort the process as it exits
    atexit.register(_destroy)
    devices = all_gather_object(str(device))
    _state["device_count"] = len(set(devices))
    print(f"[dist] rank {rank}/{world} backend {backend_name} device "
          f"{device} ({_state['device_count']} distinct device(s) in the "
          f"ring)", file=sys.stderr, flush=True)


def _destroy() -> None:
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def get_rank() -> int:
    """This process's rank; 0 when not distributed."""
    return tdist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    """The number of processes; 1 when not distributed."""
    return tdist.get_world_size() if is_initialized() else 1


def backend() -> str:
    """The process group's backend (``nccl``/``gloo``), or ``none``."""
    return str(tdist.get_backend()) if is_initialized() else "none"


def barrier(name: str = "barrier") -> None:
    """Every rank waits here; a no-op single-process. ``name`` documents
    the call site (the JAX shim's barrier takes one)."""
    del name
    if get_world_size() > 1:
        tdist.barrier()


def dev() -> torch.device:
    """This rank's device (``utils/device.py``'s rule)."""
    return resolve_device()


def device_count() -> int:
    """The number of distinct devices the ring runs on: the world size
    when every rank has a card of its own, 1 when they share one (or all
    run on the CPU)."""
    return _state["device_count"] if is_initialized() else 1


def _host_staged(device: torch.device):
    """Around a collective: gloo stages CUDA tensors through host memory
    (an intended transfer), so the sanitizer's guard is lifted there;
    NCCL's collectives stay under it."""
    return (sync_allowed(device) if backend() == "gloo"
            else contextlib.nullcontext())


def all_reduce(tensor: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Sum ``tensor`` over the ranks of ``group`` (default: all) in place
    (the identity single-process); returns it."""
    if is_initialized():
        with _host_staged(tensor.device):
            tdist.all_reduce(tensor, group=group)
    return tensor


def new_group(ranks: Sequence[int]) -> Any:
    """A process group of ``ranks`` (every rank must call this, for every
    group, in the same order)."""
    return tdist.new_group(list(ranks))


def group_size(group: Any = None) -> int:
    """The ranks in ``group`` (default: all); 1 when not distributed."""
    return tdist.get_world_size(group) if is_initialized() else 1


# pinned host buffers for staging CUDA tensors under gloo, by (role,
# elements, dtype): a rank stages the same few sizes every step
_PINNED: dict = {}


def _host_buffer(role: str, like: torch.Tensor, numel: int) -> torch.Tensor:
    """A host buffer of ``numel`` elements of ``like``'s dtype: a fresh
    one for a CPU tensor, a kept pinned one for a CUDA tensor (pinned
    copies run at the link's rate; pageable ones do not)."""
    if like.device.type != "cuda":
        return torch.empty(numel, dtype=like.dtype)
    key = (role, numel, like.dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(numel, dtype=like.dtype,
                                         pin_memory=True)
    return buf


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group: Any = None
                   ) -> torch.Tensor:
    """``out`` = this rank's chunk (by its rank in ``group``) of ``inp``
    summed over the group's ranks; ``inp`` holds ``group_size(group)``
    chunks of ``out``'s size and ``out`` may be a view of it (the ZeRO-1
    shard). Single-process: ``out`` = ``inp``. Returns ``out``.

    Under NCCL this is ``reduce_scatter_tensor``. Under gloo it is the
    direct algorithm over host buffers: one ``all_to_all_single`` hands
    every rank its chunk from each rank, and the chunks are summed in rank
    order (gloo's own reduce-scatter of the same host buffers takes over
    four times as long on the card's host,
    ``scripts/profile_torch_collectives.py``). The input is copied to the
    host first, so the output may alias it."""
    n = group_size(group)
    if inp.numel() != n * out.numel():
        raise ValueError(f"reduce_scatter: input of {inp.numel()} elements "
                         f"is not {n} chunks of {out.numel()}")
    if not is_initialized():
        if out.data_ptr() != inp.data_ptr():
            out.copy_(inp)
        return out
    with _host_staged(inp.device):
        if backend() != "gloo":
            tdist.reduce_scatter_tensor(out, inp, group=group)
            return out
        src = _host_buffer("in", inp, inp.numel())
        src.copy_(inp.detach().reshape(-1))
        got = _host_buffer("out", inp, inp.numel())
        tdist.all_to_all_single(got, src, group=group)
        flat = out.view(-1)
        parts = got.view(n, -1)
        flat.copy_(parts[0])
        for part in parts[1:]:
            flat.add_(part.to(flat.device))
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor, group: Any = None
               ) -> torch.Tensor:
    """``out`` = every rank of ``group``'s ``inp``, concatenated in group
    rank order; ``inp`` may be this rank's chunk of ``out`` (the ZeRO-1
    parameters). Single-process: ``out`` = ``inp``. Returns ``out``.

    Under NCCL this is ``all_gather_into_tensor``. Under gloo it is one
    ``all_to_all_single`` over host buffers whose input repeats this
    rank's chunk for every rank (gloo's own all-gather takes about twice
    as long, ``scripts/profile_torch_collectives.py``)."""
    n = group_size(group)
    if out.numel() != n * inp.numel():
        raise ValueError(f"all_gather: output of {out.numel()} elements "
                         f"is not {n} chunks of {inp.numel()}")
    if not is_initialized():
        if out.data_ptr() != inp.data_ptr():
            out.copy_(inp)
        return out
    with _host_staged(inp.device):
        if backend() != "gloo":
            tdist.all_gather_into_tensor(out, inp, group=group)
            return out
        src = _host_buffer("in", out, out.numel()).view(n, -1)
        src[0].copy_(inp.detach().reshape(-1))
        for row in src[1:]:
            row.copy_(src[0])
        got = _host_buffer("out", out, out.numel())
        tdist.all_to_all_single(got, src.view(-1), group=group)
        out.copy_(got.view(out.shape))
    return out


def broadcast(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` to every rank, in place (the identity
    single-process); returns it."""
    if get_world_size() > 1:
        tdist.broadcast(tensor, src)
    return tensor


def sync_params(flat: torch.Tensor) -> torch.Tensor:
    """Make every rank hold rank 0's parameters: one broadcast of the flat
    parameter buffer (the trainer keeps the model's parameters as views
    into it)."""
    return broadcast(flat)


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order (``[obj]`` single-process)."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    tdist.all_gather_object(out, obj)
    return out


# --------------------------------------------------- sequence parallelism

@dataclasses.dataclass(frozen=True)
class SequenceGroups:
    """This rank's place in a data x sequence split of the ranks: its
    sequence group (None for a ring of one, or one of every rank: the
    default group) and that group's global ranks by sequence index."""

    group: Any
    ranks: Tuple[int, ...]
    index: int          # sequence index: the L slice this rank holds
    size: int           # sequence ranks a data group (sp)
    data_index: int     # the data group: the rows this rank reads
    dp: int             # data groups


def sequence_groups(sp: int) -> SequenceGroups:
    """Split the ranks into ``world // sp`` data groups of ``sp`` sequence
    ranks each (rank ``d * sp + i`` is sequence index i of data group d):
    the sequence groups of the mesh ``{data, sequence sp}``
    (``parallel/mesh.RankMesh.sequence_groups``, which every rank forms
    in the same order). ``sp`` = 1 forms none."""
    world = get_world_size()
    if sp < 1 or world % sp:
        raise ValueError(f"the sequence axis ({sp}) must divide the world "
                         f"size ({world})")
    from .mesh import make_mesh
    return make_mesh(sequence=sp).sequence_groups()


def ring_shift(tensors: Sequence[torch.Tensor], seq: SequenceGroups,
               reverse: bool = False) -> List[torch.Tensor]:
    """Send ``tensors`` to the next sequence index (``(i + 1) % n``) and
    return those received from the previous one (``(i - 1) % n``), one
    batch of paired sends and receives; ``reverse`` turns the ring the
    other way (the transpose, for cotangents). Under gloo, CUDA tensors go
    through host buffers (the copies wait for the stream)."""
    n, i = seq.size, seq.index
    step = -1 if reverse else 1
    dst, src = seq.ranks[(i + step) % n], seq.ranks[(i - step) % n]
    stage = backend() == "gloo"
    with _host_staged(tensors[0].device):
        send = [(t.detach().cpu() if stage else t.detach()).contiguous()
                for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        ops = []
        for tag, (s, r) in enumerate(zip(send, recv)):
            ops.append(tdist.P2POp(tdist.isend, s, dst, seq.group, tag))
            ops.append(tdist.P2POp(tdist.irecv, r, src, seq.group, tag))
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        if stage:
            recv = [r.to(t.device) for r, t in zip(recv, tensors)]
    _state["shift_bytes"] += sum(t.numel() * t.element_size() for t in send)
    return recv


def sequence_all_gather(tensor: torch.Tensor, seq: SequenceGroups
                        ) -> torch.Tensor:
    """``[size, *tensor.shape]``: every rank of this rank's sequence group's
    ``tensor``, by sequence index (no gradient). Under gloo a CUDA tensor
    goes through a host buffer, as ``ring_shift``'s do."""
    t = tensor.detach().contiguous()
    stage = backend() == "gloo" and t.device.type == "cuda"
    with _host_staged(t.device):
        src = t.cpu() if stage else t
        parts = [torch.empty_like(src) for _ in range(seq.size)]
        tdist.all_gather(parts, src, group=seq.group)
        out = torch.stack(parts)
        if stage:
            out = out.to(t.device)
    return out


def ring_shift_bytes() -> int:
    """Bytes this process has sent through ``ring_shift``."""
    return _state["shift_bytes"]


# --------------------------------------------------- pipeline parallelism

@dataclasses.dataclass(frozen=True)
class PipeGroup:
    """This rank's pipe group: the process group (None when it spans every
    rank, or for a pipe of one), its global ranks by stage index, and this
    rank's stage index."""

    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    def peer(self, step: int) -> int:
        """The global rank ``step`` stages on, cyclically."""
        return self.ranks[(self.index + step) % self.size]


def pipe_exchange(pipe: PipeGroup,
                  sends: Sequence[Tuple[torch.Tensor, int, int]],
                  recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, int,
                                        int]],
                  device: torch.device) -> List[torch.Tensor]:
    """One tick's frames between pipe neighbours, in one
    ``batch_isend_irecv``: ``sends`` are ``(tensor, step, tag)`` to the
    stage ``step`` on, ``recvs`` are ``(shape, dtype, step, tag)`` from
    the stage ``step`` on; returns the received tensors on ``device``, in
    ``recvs`` order. Both sides name a frame by the same tag. Under gloo
    a CUDA tensor is copied into a pinned host buffer kept for its tag
    (the copy waits for the stream), and a received one copied back."""
    if not sends and not recvs:
        return []
    stage = backend() == "gloo" and device.type == "cuda"
    with _host_staged(device):
        ops, out = [], []
        for t, step, tag in sends:
            src = t.detach().contiguous()
            if stage:
                buf = _host_buffer(f"pipe_send{tag}", src, src.numel())
                buf.copy_(src.view(-1))
                src = buf
            _state["pipe_bytes"] += src.numel() * src.element_size()
            ops.append(tdist.P2POp(tdist.isend, src, pipe.peer(step),
                                   pipe.group, tag))
        for shape, dtype, step, tag in recvs:
            n = math.prod(shape)
            if stage:
                dst = _host_buffer(f"pipe_recv{tag}",
                                   torch.empty(0, dtype=dtype,
                                               device=device), n)
            else:
                dst = torch.empty(n, dtype=dtype, device=device)
            out.append(dst)
            ops.append(tdist.P2POp(tdist.irecv, dst, pipe.peer(step),
                                   pipe.group, tag))
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        return [(r.to(device) if stage else r).view(shape)
                for r, (shape, *_rest) in zip(out, recvs)]


def pipe_bytes() -> int:
    """Bytes this process has sent through ``pipe_exchange``."""
    return _state["pipe_bytes"]
