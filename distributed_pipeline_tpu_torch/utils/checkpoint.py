"""The port's run-directory format (a subset of
``distributed_pipeline_tpu/utils/checkpoint.py``).

A run directory holds ``training_args.json`` (the settings, as the JAX
package writes them) and, per saved step, the JAX package's file names:

* ``model_NNNNNN.pt`` - the parameters, a torch state dict keyed by flax
  path (``convert.py``);
* ``ema_{rate}_NNNNNN.pt`` - one parameter-shaped state dict per EMA rate;
* ``opt_NNNNNN.pt`` - the AdamW state ``{"mu": ..., "nu": ..., "count"}``;
* ``meta_NNNNNN.json`` - the samples consumed and the batch size, for the
  data fast-forward on resume.

Every file is written to a temporary name and renamed, and the meta file
last, so a step is complete when its meta file exists with all the others:
resume takes the newest complete step. Run directories the JAX package
wrote hold orbax checkpoints instead; importing them needs orbax, which the
GPU machines lack, and waits for ROADMAP A.5.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch

__all__ = ["parse_step_from_name", "find_resume_checkpoint", "save_run",
           "save_checkpoint", "find_complete_step", "load_checkpoint",
           "prune_checkpoints"]

_STEP_RE = re.compile(r"model_(\d+)\.pt$")
_META_RE = re.compile(r"meta_(\d+)\.json$")
# every file of one saved step: model_, ema_{rate}_, opt_ and meta_
_STEP_FILE_RE = re.compile(r"^(?:model|opt|ema_.+)_(\d{6,})\.pt$"
                           r"|^meta_(\d{6,})\.json$")


def parse_step_from_name(name: str) -> Optional[int]:
    """``.../model_012345.pt`` -> 12345."""
    m = _STEP_RE.search(name)
    return int(m.group(1)) if m else None


def find_resume_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest ``model_*.pt`` in the run dir, or None."""
    found = [(parse_step_from_name(n), n) for n in os.listdir(directory)]
    found = sorted((s, n) for s, n in found if s is not None)
    return os.path.join(directory, found[-1][1]) if found else None


def _cpu_copy(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    # a copy per tensor: a view into a flat buffer would otherwise save the
    # whole buffer's storage
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def _save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_run(run_dir: str, training_args: Mapping[str, Any],
             state_dict: Mapping[str, torch.Tensor], step: int) -> str:
    """Write ``training_args.json`` and ``model_{step:06d}.pt``; returns the
    checkpoint path. The state dict is saved from the CPU."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_args.json"), "w") as f:
        json.dump(dict(training_args), f, indent=2)
    path = os.path.join(run_dir, f"model_{step:06d}.pt")
    _save(_cpu_copy(state_dict), path)
    return path


def _paths(run_dir: str, step: int, ema_rates: Sequence[str]) -> dict:
    return {"model": os.path.join(run_dir, f"model_{step:06d}.pt"),
            "opt": os.path.join(run_dir, f"opt_{step:06d}.pt"),
            "meta": os.path.join(run_dir, f"meta_{step:06d}.json"),
            "ema": {r: os.path.join(run_dir, f"ema_{r}_{step:06d}.pt")
                    for r in ema_rates}}


def save_checkpoint(run_dir: str, step: int,
                    params: Mapping[str, torch.Tensor],
                    ema: Mapping[str, Mapping[str, torch.Tensor]],
                    opt: Mapping[str, Any], meta: Mapping[str, Any]) -> None:
    """One step's model, EMA, optimizer and meta files (meta last)."""
    os.makedirs(run_dir, exist_ok=True)
    p = _paths(run_dir, step, list(ema))
    _save(_cpu_copy(params), p["model"])
    for rate, state in ema.items():
        _save(_cpu_copy(state), p["ema"][rate])
    _save({"mu": _cpu_copy(opt["mu"]), "nu": _cpu_copy(opt["nu"]),
           "count": int(opt["count"])}, p["opt"])
    tmp = p["meta"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, **meta}, f)
    os.replace(tmp, p["meta"])


def find_complete_step(run_dir: str, ema_rates: Sequence[str]
                       ) -> Optional[int]:
    """The newest step whose model, optimizer, meta and every EMA file
    exist, or None."""
    if not os.path.isdir(run_dir):
        return None
    steps = sorted((int(m.group(1)) for m in
                    map(_META_RE.search, os.listdir(run_dir)) if m),
                   reverse=True)
    for step in steps:
        p = _paths(run_dir, step, ema_rates)
        if all(os.path.exists(x) for x in
               (p["model"], p["opt"], *p["ema"].values())):
            return step
    return None


def load_checkpoint(run_dir: str, step: int, ema_rates: Sequence[str],
                    device: Optional[torch.device] = None) -> dict:
    """``{"params", "ema": {rate: ...}, "opt": {"mu", "nu", "count"},
    "meta"}`` of one saved step, tensors on ``device``."""
    p = _paths(run_dir, step, ema_rates)

    def load(path):
        return torch.load(path, map_location=device, weights_only=True)

    with open(p["meta"]) as f:
        meta = json.load(f)
    return {"params": load(p["model"]),
            "ema": {r: load(path) for r, path in p["ema"].items()},
            "opt": load(p["opt"]), "meta": meta}


def prune_checkpoints(run_dir: str, keep: int) -> List[int]:
    """Delete every file of all but the newest ``keep`` saved steps (a step
    counts once its meta file, written last, exists): model, every EMA
    rate, opt and meta go together, as the JAX package's
    ``prune_checkpoints`` prunes a step's model and companions. Files of a
    step without its meta (a save in progress or torn) are left alone.
    Returns the pruned steps; ``keep <= 0`` prunes nothing."""
    if keep <= 0 or not os.path.isdir(run_dir):
        return []
    names = os.listdir(run_dir)
    steps = sorted(int(m.group(1)) for m in map(_META_RE.search, names)
                   if m)
    doomed = set(steps[:-keep])
    # meta first: a step whose deletion is cut short is already incomplete,
    # so resume never picks it
    for name in sorted(names, key=lambda n: not n.startswith("meta_")):
        m = _STEP_FILE_RE.match(name)
        if m and int(m.group(1) or m.group(2)) in doomed:
            os.remove(os.path.join(run_dir, name))
    return sorted(doomed)
