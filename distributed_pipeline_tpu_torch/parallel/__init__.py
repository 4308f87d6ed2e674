"""Processes: the supervised worker ring (``launcher.py``, torch-free: the
serving fleet's parent imports it), the communication shim over
``torch.distributed`` (``dist.py``), the mesh's rank layout (``mesh.py``),
the partition rules and the sharded-state layout (``partition.py``) and
the FSDP units (``fsdp.py``). The shim's names are imported on
first use, so importing this package imports no torch."""

from .launcher import (AUTORUN_ENV_FLAG, find_free_port, parse_and_autorun,
                       parse_distributed_args, run_argv_as_distributed)

_DIST_NAMES = ("barrier", "broadcast", "dev", "device_count", "get_rank",
               "get_world_size", "is_available", "is_initialized",
               "setup_dist", "sync_params", "all_reduce",
               "all_gather_object", "backend", "SequenceGroups",
               "sequence_groups", "ring_shift", "sequence_all_gather",
               "new_group", "group_size", "reduce_scatter", "all_gather",
               "PipeGroup", "pipe_exchange", "pipe_bytes")

__all__ = ["AUTORUN_ENV_FLAG", "find_free_port", "parse_and_autorun",
           "parse_distributed_args", "run_argv_as_distributed",
           *_DIST_NAMES]


def __getattr__(name: str):
    if name in _DIST_NAMES:
        from . import dist
        return getattr(dist, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
