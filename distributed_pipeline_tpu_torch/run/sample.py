"""Run-directory loading: the port of ``load_run`` from
``distributed_pipeline_tpu/run/sample.py``. The sampling/eval entry point
itself comes with ROADMAP A.7."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..models import GPT2Model, create_model_from_config
from ..utils.checkpoint import find_resume_checkpoint, parse_step_from_name

__all__ = ["load_run"]


def load_run(run_dir: str, step: int = 0, device: Optional[torch.device] = None
             ) -> Tuple[GPT2Model, Dict[str, Any], int]:
    """``(model, training_args, step)`` from a port run directory: the model
    config from ``training_args.json``, the weights from ``model_NNNNNN.pt``
    (the newest unless ``step`` is given), placed on ``device``."""
    with open(os.path.join(run_dir, "training_args.json")) as f:
        targs = json.load(f)
    if step:
        path = os.path.join(run_dir, f"model_{step:06d}.pt")
    else:
        path = find_resume_checkpoint(run_dir)
        if path is None:
            raise FileNotFoundError(f"no model_*.pt checkpoint under {run_dir}")
    model = create_model_from_config(**targs, device=device)
    model.load_state_dict(torch.load(path, map_location=device,
                                     weights_only=True))
    return model.eval(), targs, parse_step_from_name(path) or 0
