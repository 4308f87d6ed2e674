"""The port's run-directory format (a subset of
``distributed_pipeline_tpu/utils/checkpoint.py``).

A run directory holds ``training_args.json`` (the model config, as the JAX
package writes it) and one ``model_NNNNNN.pt`` per saved step: a torch state
dict keyed by flax path (``convert.py``). Run directories the JAX package
wrote hold orbax checkpoints instead; importing them needs orbax, which the
GPU machines lack, and waits for ROADMAP A.5.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional

import torch

__all__ = ["parse_step_from_name", "find_resume_checkpoint", "save_run"]

_STEP_RE = re.compile(r"model_(\d+)\.pt$")


def parse_step_from_name(name: str) -> Optional[int]:
    """``.../model_012345.pt`` -> 12345."""
    m = _STEP_RE.search(name)
    return int(m.group(1)) if m else None


def find_resume_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest ``model_*.pt`` in the run dir, or None."""
    found = [(parse_step_from_name(n), n) for n in os.listdir(directory)]
    found = sorted((s, n) for s, n in found if s is not None)
    return os.path.join(directory, found[-1][1]) if found else None


def save_run(run_dir: str, training_args: Mapping[str, Any],
             state_dict: Mapping[str, torch.Tensor], step: int) -> str:
    """Write ``training_args.json`` and ``model_{step:06d}.pt``; returns the
    checkpoint path. The state dict is saved from the CPU."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_args.json"), "w") as f:
        json.dump(dict(training_args), f, indent=2)
    path = os.path.join(run_dir, f"model_{step:06d}.pt")
    cpu: Dict[str, torch.Tensor] = {k: v.detach().cpu()
                                    for k, v in state_dict.items()}
    torch.save(cpu, path)
    return path
