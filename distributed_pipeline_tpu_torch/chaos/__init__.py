"""Fault injection and goodput accounting for the serving fleet.

The port's copy of the fleet's half of ``distributed_pipeline_tpu/chaos``:
the fault plan (:class:`ChaosPlan`, the JAX package's JSON and kinds), the
serving faults' injector (:class:`ChaosInjector`: replica kills and wedges,
corrupted swap checkpoints) and the fleet-dir layout with the serving
goodput fold (:mod:`.goodput`).

Import-light by design: the fleet parent, which never imports torch,
imports this package.
"""

from .goodput import (
    aggregate_serving,
    append_attempt,
    attempts_path,
    beacon_path,
    list_replica_dirs,
    read_attempts,
    read_beacons,
    read_journal,
    read_serving_records,
    replica_dir,
    replica_id,
    serving_journal_path,
    serving_record_path,
)
from .inject import ChaosInjector, corrupt_checkpoint_payload
from .plan import CHAOS_PLAN_ENV, ChaosFault, ChaosPlan

__all__ = [
    "ChaosFault", "ChaosPlan", "ChaosInjector", "CHAOS_PLAN_ENV",
    "corrupt_checkpoint_payload",
    "append_attempt", "attempts_path", "beacon_path", "read_attempts",
    "read_beacons",
    "aggregate_serving", "list_replica_dirs", "read_journal",
    "read_serving_records", "replica_dir", "replica_id",
    "serving_journal_path", "serving_record_path",
]
