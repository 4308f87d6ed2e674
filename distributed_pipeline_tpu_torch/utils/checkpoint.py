"""The port's run-directory format (a subset of
``distributed_pipeline_tpu/utils/checkpoint.py``).

A run directory holds ``training_args.json`` (the settings, as the JAX
package writes them) and, per saved step, the JAX package's file names:

* ``model_NNNNNN.pt`` - the parameters, a torch state dict keyed by flax
  path (``convert.py``);
* ``ema_{rate}_NNNNNN.pt`` - one parameter-shaped state dict per EMA rate;
* ``opt_NNNNNN.pt`` - the AdamW state ``{"mu": ..., "nu": ..., "count"}``;
* ``meta_NNNNNN.json`` - the global samples consumed, the batch size (a
  rank's) and the global batch (the JAX meta's ``global_batch``), for the
  data fast-forward on resume, at the same or another world size.

Under several processes rank 0 alone writes and prunes, and every rank
passes a barrier after it (``TrainLoop.save``).

Every file is written to a temporary name and renamed, and the meta file
last, so a step is finalized when its meta file exists (the meta plays
the JAX package's commit marker). Resume (:func:`restore_resume_state`,
the JAX function's walk-back) tries the finalized steps newest first and
walks back past any whose model file fails to load; a missing or corrupt
EMA companion degrades to a copy of the parameters, a missing or corrupt
optimizer companion to fresh moments. Run directories the JAX package
wrote hold orbax checkpoints instead; importing them needs orbax, which
the GPU machines lack, and waits for ROADMAP A.5.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch

__all__ = ["parse_step_from_name", "find_resume_checkpoint", "save_run",
           "save_checkpoint", "finalized_steps", "restore_resume_state",
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


def finalized_steps(run_dir: str) -> List[int]:
    """The steps whose meta file (written last) and model file exist,
    newest first: the resume walk-back's ladder."""
    if not os.path.isdir(run_dir):
        return []
    names = os.listdir(run_dir)
    steps = sorted((int(m.group(1)) for m in map(_META_RE.search, names)
                    if m), reverse=True)
    return [s for s in steps if f"model_{s:06d}.pt" in names]


def _load(path: str, device: Optional[torch.device]) -> Any:
    return torch.load(path, map_location=device, weights_only=True)


def restore_resume_state(run_dir: str, ema_rates: Sequence[str], *,
                         device: Optional[torch.device] = None,
                         explicit_model_path: str = "",
                         check: Optional[Callable[[Mapping[str, Any]],
                                                  None]] = None,
                         warn: Callable[[str], None] = print
                         ) -> Optional[dict]:
    """The resume state ``{"step", "params", "ema": {rate: ...}, "opt"
    (or None), "meta", "path"}``, tensors on ``device``; None when the run
    dir holds no finalized step (the JAX ``restore_resume_state``).

    The finalized steps are tried newest first: a model file that fails to
    load, or that ``check`` (given the loaded state dict) refuses, is
    reported through ``warn`` and the next older step is tried. When every
    step fails this raises ``RuntimeError``: a silent fresh start in a run
    dir full of checkpoints would overwrite its history. An explicit
    ``model_NNNNNN.pt`` never walks back: its failure raises. The chosen
    step's EMA companions that are missing or fail to load (or ``check``)
    come back as the parameters (the caller copies them), and a missing or
    failed optimizer companion as None (fresh moments); a companion that
    exists but fails to load is reported through ``warn``."""
    if explicit_model_path:
        step = parse_step_from_name(explicit_model_path)
        if step is None:
            raise ValueError(f"resume_checkpoint must name a "
                             f"model_NNNNNN.pt, got {explicit_model_path!r}")
        run_dir = os.path.dirname(os.path.abspath(explicit_model_path))
        candidates = [step]
    else:
        candidates = finalized_steps(run_dir)
        if not candidates:
            return None

    def load_checked(path: str) -> Any:
        state = _load(path, device)
        if check is not None:
            check(state)
        return state

    last_err: Optional[Exception] = None
    for step in candidates:
        p = _paths(run_dir, step, ema_rates)
        try:
            params = load_checked(p["model"])
            with open(p["meta"]) as f:
                meta = json.load(f)
        except Exception as e:  # torch.load surfaces corruption as
            # UnpicklingError/RuntimeError/EOFError/...; any of them means
            # "this step cannot feed a resume"
            if explicit_model_path:
                raise
            warn(f"resume: restoring {p['model']} failed "
                 f"({type(e).__name__}: {str(e)[:200]}); walking back to "
                 f"the next older checkpoint")
            last_err = e
            continue
        break
    else:
        raise RuntimeError(
            f"resume: all {len(candidates)} checkpoint(s) in {run_dir} "
            f"failed to restore; newest error: {last_err}") from last_err
    # a missing companion degrades silently, a corrupt one with a warning
    ema: Dict[str, Any] = {rate: params for rate in ema_rates}
    for rate, path in p["ema"].items():
        if not os.path.exists(path):
            continue
        try:
            ema[rate] = load_checked(path)
        except Exception as e:  # seed from the params
            warn(f"resume: EMA companion {path} failed to restore "
                 f"({type(e).__name__}); seeding from params")
    opt = None
    if os.path.exists(p["opt"]):
        try:
            state = _load(p["opt"], device)
            if check is not None:
                check(state["mu"])
                check(state["nu"])
            opt = {"mu": state["mu"], "nu": state["nu"],
                   "count": int(state["count"])}
        except Exception as e:  # fresh moments beat a dead resume
            warn(f"resume: optimizer companion {p['opt']} failed to "
                 f"restore ({type(e).__name__}); reinitializing")
    return {"step": step, "params": params, "ema": ema, "opt": opt,
            "meta": meta, "path": p["model"]}


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
