"""Fault injection and goodput accounting for training runs and the
serving fleet.

The port's copy of ``distributed_pipeline_tpu/chaos``: the fault plan
(:class:`ChaosPlan`, the JAX package's JSON and kinds), the injector
(:class:`ChaosInjector`: the training faults — kills, wedges, stragglers,
data stalls, corrupted and torn checkpoints — and the serving ones:
replica kills and wedges, corrupted swap checkpoints) and the run- and
fleet-dir layouts with the training and serving goodput folds
(:mod:`.goodput`), the MPMD pipeline's stage dirs folded stage by stage.

Import-light by design: the fleet parent, which never imports torch,
imports this package.
"""

from .goodput import (
    aggregate_run,
    aggregate_serving,
    append_attempt,
    attempts_path,
    beacon_max_step,
    beacon_path,
    goodput_record_path,
    list_replica_dirs,
    list_stage_dirs,
    read_attempts,
    read_beacons,
    read_goodput_records,
    read_journal,
    read_serving_records,
    replica_dir,
    replica_id,
    serving_journal_path,
    serving_record_path,
    stage_dir,
    stage_id,
)
from .inject import (ChaosInjector, corrupt_checkpoint_payload,
                     corrupt_newest_checkpoint)
from .plan import CHAOS_PLAN_ENV, ChaosFault, ChaosPlan

__all__ = [
    "ChaosFault", "ChaosPlan", "ChaosInjector", "CHAOS_PLAN_ENV",
    "corrupt_checkpoint_payload", "corrupt_newest_checkpoint",
    "append_attempt", "attempts_path", "beacon_path", "read_attempts",
    "read_beacons", "beacon_max_step", "goodput_record_path",
    "read_goodput_records", "aggregate_run",
    "aggregate_serving", "list_replica_dirs", "read_journal",
    "read_serving_records", "replica_dir", "replica_id",
    "serving_journal_path", "serving_record_path", "list_stage_dirs",
    "stage_dir", "stage_id",
]
