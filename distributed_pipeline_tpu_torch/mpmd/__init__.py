"""MPMD runtime: one stage-to-stage send/recv substrate for pipeline
training AND disaggregated prefill/decode serving. The port of
``distributed_pipeline_tpu/mpmd``.

Layering (strictly torch-free above the line: the driver and launcher
side runs in supervisor processes that never import torch):

* ``link.py``       — StageLink transport: FileStageLink (atomic-rename
  host relay) and MemStageLink (in-process), one wire format, epoch
  fencing, backpressure, link_wait accounting;
* ``protocol.py``   — run-dir layout, per-stage paths/beacons/snapshots,
  the 1F1B/GPipe schedule generator, host-side goodput;
* ``driver.py``     — the host pipeline driver: one supervised launcher
  ring PER STAGE, two-phase step broadcast/collect, epoch-fenced rewind
  recovery;
* ``stage_worker.py`` — the per-stage worker process the driver spawns
  (torch-free itself; its ``StageMath`` imports torch on construction);
  --------------------------------------------------------------- torch
* ``stage_math.py`` — per-stage parameter slices, forward/backward
  microbatch math, the per-slice optimizer, and the in-process pipeline
  reference runner;
* ``disagg.py``     — disaggregated serving: PrefillClient + the KV-page
  wire frames feeding ``DecodeServer.submit_prefilled``.

Imports here are lazy (PEP 562) so ``from ..mpmd import PipelineDriver``
in a torch-free process pulls in nothing from the torch side.
"""

from __future__ import annotations

__all__ = [
    "FileStageLink", "MemStageLink", "StageLink", "flatten_tree",
    "unflatten_tree",
    "HostGoodput", "StagePaths", "StageProtocol", "link_dir",
    "read_config", "schedule_for", "write_config",
    "PipelineDriver",
    "StageMath", "run_pipeline_inprocess",
    "StageWorker",
    "PrefillClient", "pack_kv_frame", "serve_disagg_inprocess",
    "unpack_kv_frame",
]

_HOMES = {
    "FileStageLink": "link", "MemStageLink": "link", "StageLink": "link",
    "flatten_tree": "link", "unflatten_tree": "link",
    "HostGoodput": "protocol", "StagePaths": "protocol",
    "StageProtocol": "protocol", "link_dir": "protocol",
    "read_config": "protocol", "schedule_for": "protocol",
    "write_config": "protocol",
    "PipelineDriver": "driver",
    "StageMath": "stage_math", "run_pipeline_inprocess": "stage_math",
    "StageWorker": "stage_worker",
    "PrefillClient": "disagg", "pack_kv_frame": "disagg",
    "serve_disagg_inprocess": "disagg", "unpack_kv_frame": "disagg",
}


def __getattr__(name: str):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(f".{home}", __name__), name)


def __dir__():
    return sorted(__all__)
