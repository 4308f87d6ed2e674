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
passes a barrier after it (``TrainLoop.save``). The files hold the full
tensors whatever the layout the run trained under: a sharded trainer
(``--shard_optimizer``, ``--fsdp``, ``--pipe`` and their compositions:
a stage's slice, cut over fsdp or not) gathers each state to rank 0
before the save, and a resume under any layout cuts its shard from them
(``TrainLoop.load_state``), so a run saved under one layout resumes
under another; the block layouts (named, stacked, stacked MoE groups)
convert on load (``convert.to_layout``).

:class:`AsyncSaver` is the JAX package's saver on this format: the
device-to-host copy runs in the caller (the next step may overwrite the
flat buffers), one writer thread runs ``torch.save`` and the rename of
each file, meta last, and at most one save is in flight. ``wait()`` (before
the next save, before a prune, at exit) joins it and raises the writer's
error, if any; until then the step sits in an in-flight registry that
keeps :func:`prune_checkpoints` off it.

Every file is written to a temporary name and renamed, and the meta file
last, so a step is finalized when its meta file exists (the meta plays
the JAX package's commit marker). Resume (:func:`restore_resume_state`,
the JAX function's walk-back) tries the finalized steps newest first and
walks back past any whose model file fails to load; a missing or corrupt
EMA companion degrades to a copy of the parameters, a missing or corrupt
optimizer companion to fresh moments. Run directories the JAX package
wrote hold orbax checkpoints instead; importing them needs orbax, which
the GPU machines lack, so the port reads none (weights cross over through
``convert.py``).
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch

__all__ = ["parse_step_from_name", "find_resume_checkpoint", "save_run",
           "save_checkpoint", "AsyncSaver", "in_flight_steps",
           "finalized_steps", "restore_resume_state", "prune_checkpoints"]

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


# saves scheduled by this process and not yet durable: {(abs dir, step)}
_IN_FLIGHT: set = set()


def in_flight_steps(run_dir: str) -> set:
    """The steps of ``run_dir`` whose save this process has scheduled and
    not yet seen finish."""
    key = os.path.abspath(run_dir)
    return {s for d, s in _IN_FLIGHT if d == key}


class AsyncSaver:
    """At most one checkpoint save in flight, overlapping training.

    ``save`` waits for the previous save, copies every tensor to the host
    in the caller, registers the step as in flight and starts one writer
    thread that writes the model, EMA and optimizer files and then the meta
    file (the commit marker). ``wait()`` joins the writer, takes the step
    off the registry and raises the writer's error, if there was one.
    ``tear()`` is ``crash_in_save``'s: the payload files written, the meta
    left unwritten (or removed), whatever the writer's timing."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._key: Optional[tuple] = None
        self._meta_path = ""
        self._lock = threading.Lock()
        self._torn = False

    @property
    def in_flight(self) -> bool:
        return self._thread is not None

    def save(self, run_dir: str, step: int,
             params: Mapping[str, torch.Tensor],
             ema: Mapping[str, Mapping[str, torch.Tensor]],
             opt: Mapping[str, Any], meta: Mapping[str, Any],
             wait: bool = False, copied: bool = False) -> None:
        """Schedule one step's model, EMA, optimizer and meta files (meta
        last); ``wait=True`` returns once they are durable. ``copied``:
        the state dicts are host copies the saver may keep as they are
        (a sharded trainer's gathered state), else it copies them."""
        self.wait()
        os.makedirs(run_dir, exist_ok=True)
        p = _paths(run_dir, step, list(ema))
        copy = dict if copied else _cpu_copy
        jobs = [(copy(params), p["model"])]
        jobs += [(copy(state), p["ema"][rate])
                 for rate, state in ema.items()]
        jobs.append(({"mu": copy(opt["mu"]), "nu": copy(opt["nu"]),
                      "count": int(opt["count"])}, p["opt"]))
        self._key = (os.path.abspath(run_dir), step)
        _IN_FLIGHT.add(self._key)
        self._meta_path, self._torn = p["meta"], False
        self._thread = threading.Thread(
            target=self._write, args=(jobs, {"step": step, **meta}),
            name=f"ckpt-save-{step}", daemon=True)
        self._thread.start()
        if wait:
            self.wait()

    def _write(self, jobs: list, meta: dict) -> None:
        try:
            for obj, path in jobs:
                _save(obj, path)
            jobs.clear()
            with self._lock:
                if not self._torn:
                    _write_meta(self._meta_path, meta)
        except BaseException as e:  # raised at the next wait()
            self._error = e

    def wait(self) -> None:
        """Block until the save in flight, if any, is durable; raise its
        writer's error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._key is not None:
            _IN_FLIGHT.discard(self._key)
            self._key = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def tear(self) -> bool:
        """Leave the save in flight torn: its payload files written, its
        meta file absent. Returns False when no save was in flight."""
        if self._thread is None:
            return False
        with self._lock:
            self._torn = True
        meta_path = self._meta_path
        self.wait()
        try:  # the writer may have committed before the flag was set
            os.remove(meta_path)
        except OSError:
            pass
        return True


def _write_meta(path: str, meta: Mapping[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dict(meta), f)
    os.replace(tmp, path)


def save_checkpoint(run_dir: str, step: int,
                    params: Mapping[str, torch.Tensor],
                    ema: Mapping[str, Mapping[str, torch.Tensor]],
                    opt: Mapping[str, Any], meta: Mapping[str, Any]) -> None:
    """One step's model, EMA, optimizer and meta files (meta last),
    durable on return."""
    AsyncSaver().save(run_dir, step, params, ema, opt, meta, wait=True)


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
    step without its meta (a save in progress or torn), and a step whose
    save this process has in flight, are neither counted nor touched.
    Returns the pruned steps; ``keep <= 0`` prunes nothing."""
    if keep <= 0 or not os.path.isdir(run_dir):
        return []
    names = os.listdir(run_dir)
    inflight = in_flight_steps(run_dir)
    steps = sorted(s for s in (int(m.group(1)) for m in
                               map(_META_RE.search, names) if m)
                   if s not in inflight)
    doomed = set(steps[:-keep])
    # meta first: a step whose deletion is cut short is already incomplete,
    # so resume never picks it
    for name in sorted(names, key=lambda n: not n.startswith("meta_")):
        m = _STEP_FILE_RE.match(name)
        if m and int(m.group(1) or m.group(2)) in doomed:
            os.remove(os.path.join(run_dir, name))
    return sorted(doomed)
