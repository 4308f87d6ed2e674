"""The mesh's rank layout: the port of
``distributed_pipeline_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` over six
named axes and shards arrays against them. The port has no device-mesh
object: each process is one rank of a ``torch.distributed`` group, and a
mesh is the ranks laid out the same way. Rank r sits at its index in
``np.arange(world).reshape(sizes)`` over ``AXES`` (the JAX mesh's
row-major order), so a rank's coordinate on one axis, and the ranks that
share every other coordinate (its group along that axis), are pure
functions of the sizes.

:func:`make_mesh` forms the process groups this port trains over:

* ``data``: the gradient's reduction (``--dp``; the ZeRO-1 shard's
  reduce-scatter and all-gather under ``--shard_optimizer``);
* ``fsdp``: the parameter units' all-gathers and their gradients'
  reduce-scatters (``--fsdp``);
* ``sequence``: the ring (``--sequence``,
  :meth:`RankMesh.sequence_groups`): the ranks that differ only in their
  sequence coordinate. Without a pipe axis rank ``(d * fsdp + f) * sp +
  i`` is sequence index i of the row group ``rank // sp``; under
  ``{sequence 2, pipe 2}`` the pipe axis is the faster one, so ranks 0
  and 2 ring together and 0 and 1 are pipe partners;
* ``pipe``: the pipeline stages (``--pipe``), the innermost axis, so a
  pipe group is S consecutive ranks and a rank's stage index is its pipe
  coordinate (:meth:`RankMesh.pipe_group`);
* under a pipe axis, the groups that span every axis but some
  (``~pipe``: a stage's ranks; ``~fsdp``, ``~data``, ``~pipe~data``,
  ``~fsdp~data``), over which the trainer sums the gradient's ranges.

``tensor`` and ``expert`` stay 1 (ROADMAP A.8g). An axis of size 1 has no
group; an axis that spans every rank uses the default group.
:func:`batch_spec` is the JAX rule for a batch's rows, and
:meth:`RankMesh.rows` the row selection it implies here (the port of
``sharding.batch_shardings`` and ``shard_batch``): the data, fsdp and
expert ranks read distinct rows; the sequence ranks of a row group read
the same rows (each its L slice), and so do its pipe ranks (each runs its
stage of every row).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["AXES", "RankMesh", "resolve_axis_sizes", "rank_coords",
           "axis_ranks", "key_axes", "make_mesh", "batch_spec", "local_mesh_info"]

AXES: Tuple[str, ...] = ("data", "fsdp", "sequence", "tensor", "expert",
                         "pipe")
# the axes whose ranks read distinct rows of the global batch
_ROW_AXES = ("data", "fsdp", "expert")


def resolve_axis_sizes(dp: int = -1, fsdp: int = 1, sequence: int = 1,
                       tensor: int = 1, expert: int = 1, pipe: int = 1,
                       n_devices: Optional[int] = None) -> Tuple[int, ...]:
    """Resolve ``-1`` axis sizes against the rank count and validate the
    product. Returns sizes in AXES order (data, fsdp, sequence, tensor,
    expert, pipe). ``n_devices`` defaults to the process group's size."""
    if n_devices is None:
        from . import dist
        n_devices = dist.get_world_size()
    n = n_devices
    sizes = {"data": dp, "fsdp": fsdp, "sequence": sequence, "tensor": tensor,
             "expert": expert, "pipe": pipe}
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if unknown:
        if n % fixed != 0:
            raise ValueError(f"device count {n} not divisible by fixed axes "
                             f"product {fixed}")
        sizes[unknown[0]] = n // fixed
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(f"mesh axes {sizes} multiply to {total}, but {n} "
                         f"devices are present")
    return tuple(sizes[a] for a in AXES)  # type: ignore[return-value]


def rank_coords(rank: int, sizes: Tuple[int, ...]) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each axis: its index in
    ``np.arange(world).reshape(sizes)``."""
    return dict(zip(AXES, (int(c) for c in np.unravel_index(rank, sizes))))


def key_axes(key: str) -> Tuple[str, ...]:
    """The axes a group key spans: an axis name, ``""`` for every axis, or
    ``~a~b`` for every axis but ``a`` and ``b``."""
    if not key:
        return AXES
    if key.startswith("~"):
        out = set(key.split("~")[1:])
        return tuple(a for a in AXES if a not in out)
    return (key,)


def axis_ranks(rank: int, sizes: Tuple[int, ...], axis: str
               ) -> Tuple[int, ...]:
    """The ranks that share every coordinate of ``rank`` but those of the
    axes ``axis`` spans (an axis name, or a ``~`` key of
    :func:`key_axes`), in row-major order over those axes:
    ``rank``'s group along them."""
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    index = list(np.unravel_index(rank, sizes))
    for a in key_axes(axis):
        index[AXES.index(a)] = slice(None)
    return tuple(int(r) for r in grid[tuple(index)].reshape(-1))


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place in the mesh: the axis sizes, its coordinates and
    its process group along each axis (None for an axis of size 1 or one
    that spans every rank, which take no group or the default one)."""

    sizes: Tuple[int, ...]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Any]

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}``, as the JAX ``Mesh.shape``."""
        return dict(zip(AXES, self.sizes))

    def size(self, axis: str) -> int:
        return self.sizes[AXES.index(axis)]

    def span(self, key: str) -> int:
        """The ranks in this rank's group ``key`` (:func:`key_axes`)."""
        return math.prod(self.size(a) for a in key_axes(key))

    def sequence_groups(self) -> Any:
        """This rank's ``dist.SequenceGroups`` from the mesh: its sequence
        group's process group and global ranks by sequence index, its
        sequence index, and its row group (``rows``)."""
        from . import dist
        row, rows = self.rows()
        return dist.SequenceGroups(
            self.group("sequence"),
            axis_ranks(self.rank, self.sizes, "sequence"),
            self.index("sequence"), self.size("sequence"), row, rows)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Any:
        return self.groups.get(axis)

    def pipe_group(self) -> Any:
        """This rank's ``dist.PipeGroup``: its pipe group's process group,
        global ranks by stage index, and its own stage index."""
        from . import dist
        return dist.PipeGroup(self.group("pipe"),
                              axis_ranks(self.rank, self.sizes, "pipe"),
                              self.index("pipe"))

    def rows(self) -> Tuple[int, int]:
        """``(row group, row groups)``: the global batch splits into
        ``row groups`` shards, one for each index over the data, fsdp and
        expert axes (``batch_spec``); this rank reads shard ``row group``,
        as every rank that differs from it only on the other axes does."""
        count = math.prod(self.size(a) for a in _ROW_AXES)
        index = int(np.ravel_multi_index(
            tuple(self.index(a) for a in _ROW_AXES),
            tuple(self.size(a) for a in _ROW_AXES)))
        return index, count


def make_mesh(dp: int = -1, fsdp: int = 1, sequence: int = 1,
              tensor: int = 1, expert: int = 1, pipe: int = 1) -> RankMesh:
    """This rank's mesh over the process group (one rank when there is
    none): the sizes resolved against the world size, its coordinates,
    and one process group per data, fsdp, sequence and pipe group of more
    than one rank, and under a pipe axis per ``~`` group of the module doc
    (every rank forms every group, in the same order, as ``new_group``
    requires)."""
    from . import dist
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = resolve_axis_sizes(dp, fsdp, sequence, tensor, expert, pipe,
                               n_devices=world)
    groups: Dict[str, Any] = {}
    keys = ["data", "fsdp", "sequence", "pipe"]
    if pipe > 1:
        keys += ["~pipe", "~fsdp", "~data", "~pipe~data", "~fsdp~data"]
    for axis in keys:
        n = math.prod(sizes[AXES.index(a)] for a in key_axes(axis))
        if n == 1 or n == world:
            continue
        seen = set()
        for r in range(world):
            members = axis_ranks(r, sizes, axis)
            if members in seen:
                continue
            seen.add(members)
            g = dist.new_group(list(members))
            if rank in members:
                groups[axis] = g
    return RankMesh(sizes, rank, rank_coords(rank, sizes), groups)


def batch_spec(mesh: RankMesh, seq_sharded: bool = False) -> tuple:
    """The spec of a [batch, seq, ...] array: batch over data+fsdp+expert
    (fsdp and expert ranks still read distinct rows: ZeRO/GShard
    semantics), and optionally seq over the sequence axis (ring
    attention). A tuple of entries, as ``partition.py``'s specs."""
    shape = mesh.shape
    batch_axes: Any = tuple(a for a in _ROW_AXES if shape[a] > 1) or None
    if isinstance(batch_axes, tuple) and len(batch_axes) == 1:
        batch_axes = batch_axes[0]
    if seq_sharded and shape["sequence"] > 1:
        return (batch_axes, "sequence")
    return (batch_axes,)


def local_mesh_info(mesh: RankMesh) -> str:
    """Human-readable mesh summary for the launch log."""
    from . import dist
    return (f"mesh {mesh.shape} over {int(np.prod(mesh.sizes))} ranks "
            f"(rank {mesh.rank} at {mesh.coords}, "
            f"{dist.device_count()} distinct device(s))")
