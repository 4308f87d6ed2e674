"""Training entry point, one process: the port of
``distributed_pipeline_tpu/run/train.py``.

    python -m distributed_pipeline_tpu_torch.run.train --config_json cfg.json
    python -m distributed_pipeline_tpu_torch.run.train --model_family gpt2 \\
        --seq_len 1024 --batch_size 8 --microbatch 4 ... [--device cpu]

Settings -> run dir -> logger -> ``training_args.json`` -> model ->
``TrainLoop`` (which resumes from the run dir's newest complete checkpoint)
-> data streams fast-forwarded past the samples the checkpoint consumed ->
``run_loop``. Runs on CUDA unless ``--device cpu`` is given, and raises when
CUDA is missing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

from ..config.train import TrainSettings, parse_settings
from ..data import load_data_from_args, skip_batches_for_samples
from ..models import create_model_from_config
from ..utils.device import resolve_device
from ..utils.logger import Logger
from ..utils.trainer import TrainLoop

__all__ = ["main", "train", "resolve_run_dir"]


def resolve_run_dir(args: TrainSettings) -> str:
    """``model_checkpoints/Run_{dataset}_lr{lr}_seed{seed}_{ts}`` unless
    ``checkpoint_path`` names one, as the JAX package resolves it."""
    if args.checkpoint_path:
        return args.checkpoint_path
    ts = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join("model_checkpoints",
                        f"Run_{args.dataset}_lr{args.lr}_seed{args.seed}_{ts}")


def train(args: TrainSettings, stdout: bool = True) -> TrainLoop:
    """Train with ``args`` to ``learning_steps``; returns the loop."""
    device = resolve_device(args.device)
    run_dir = resolve_run_dir(args)
    os.makedirs(run_dir, exist_ok=True)
    logger = Logger(run_dir, stdout=stdout)
    settings = args.to_dict()
    settings.pop("device")  # where a run trained is not part of its config
    with open(os.path.join(run_dir, "training_args.json"), "w") as f:
        json.dump(settings, f, indent=2)
    model = create_model_from_config(**settings, device=device)
    loop = TrainLoop(
        model=model, data=None, batch_size=args.batch_size,
        microbatch=args.microbatch, lr=args.lr, ema_rate=args.ema_rate,
        log_interval=args.log_interval, eval_interval=args.eval_interval,
        save_interval=args.save_interval,
        resume_checkpoint=args.resume_checkpoint,
        gradient_clipping=args.gradient_clipping,
        weight_decay=args.weight_decay, learning_steps=args.learning_steps,
        warmup_steps=args.warmup_steps, checkpoint_dir=run_dir,
        seed=args.seed, dispatch_lag=args.dispatch_lag,
        fused_update=args.fused_update, logger=logger)
    # exact-order resume: skip the samples the restored step consumed
    meta = loop.resume_meta or {}
    consumed = int(meta.get("samples", loop.step * args.batch_size))
    train_skip = skip_batches_for_samples(consumed, args.batch_size)
    eval_skip = int(meta.get("eval_batches_consumed", 0))
    data_args = {k: v for k, v in settings.items() if k != "batch_size"}
    loop.set_data(
        load_data_from_args("train", batch_size=args.batch_size,
                            skip_batches=train_skip, **data_args),
        eval_data=load_data_from_args(
            "valid", batch_size=args.batch_size, skip_batches=eval_skip,
            **{**data_args, "deterministic": True}),
        eval_batches_consumed=eval_skip,
        samples_consumed=consumed if loop.step else None)
    logger.info(f"the parameter count is {loop.n_params} "
                f"({loop.n_params / 1e6:.1f}M); device {device}; "
                f"fused update {loop.fused_update}")
    try:
        loop.run_loop()
    finally:
        logger.close()
    return loop


def main(argv: Optional[Sequence[str]] = None) -> TrainLoop:
    return train(parse_settings(argv))


if __name__ == "__main__":
    main()
