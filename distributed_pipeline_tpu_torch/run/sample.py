"""Sampling/eval entry point: the port of
``distributed_pipeline_tpu/run/sample.py``.

    python -m distributed_pipeline_tpu_torch.run.sample --checkpoint_path RUN
    python -m distributed_pipeline_tpu_torch.run.sample \\
        --checkpoint_path RUN --ema 0.99 --sample_steps 64 --num_batches 4
    python -m distributed_pipeline_tpu_torch.run.sample \\
        --checkpoint_path GPT2_RUN --prompt_len 512 --temperature 0.8 \\
        --top_k 50

Loads a run directory that ``run.train`` wrote (the model config from its
``training_args.json``, raw or EMA parameters from the newest or the given
step) and decodes validation batches: a DiffuSeq run by reverse diffusion
(MBR over ``--mbr`` candidates), scored over the target span; a GPT-2 run
by continuing each row after ``--prompt_len`` (default seq_len/2) through
the serving path (``serving.one_shot_decode``: one ``DecodeServer`` built
on the first batch and reused, a seed a batch), greedy or sampled
(``--temperature``, ``--top_k``, ``--top_p``), scored over the generated
span. Prints one JSON line with ``decode_acc`` and ``eval_loss``, the JAX
entry point's keys; ``--out`` writes the decoded ids as JSONL. Runs on
CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import load_data_from_args
from ..models import Model, compute_losses, create_model_from_config
from ..models.diffuseq import mix_seed, seeded_generator
from ..models.sampling import (diffuseq_sample_mbr, gpt2_decode,
                               target_span_accuracy)
from ..serving.scheduler import DecodeServer, one_shot_decode
from ..utils.checkpoint import find_resume_checkpoint, parse_step_from_name
from ..utils.device import resolve_device

__all__ = ["load_run", "create_parser", "main"]


def load_run(run_dir: str, step: int = 0,
             device: Optional[torch.device] = None, ema: str = ""
             ) -> Tuple[Model, Dict[str, Any], int]:
    """``(model, training_args, step)`` from a port run directory: the model
    (either family) from ``training_args.json``, its weights from
    ``model_NNNNNN.pt`` (the newest unless ``step`` is given), or from
    ``ema_{ema}_NNNNNN.pt`` when ``ema`` names a rate, placed on
    ``device``."""
    with open(os.path.join(run_dir, "training_args.json")) as f:
        targs = json.load(f)
    if step:
        path = os.path.join(run_dir, f"model_{step:06d}.pt")
    else:
        path = find_resume_checkpoint(run_dir)
        if path is None:
            raise FileNotFoundError(f"no model_*.pt checkpoint under "
                                    f"{run_dir}")
    step = parse_step_from_name(path) or 0
    if ema:
        path = os.path.join(run_dir, f"ema_{ema}_{step:06d}.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no ema_{ema}_{step:06d}.pt under "
                                    f"{run_dir}")
    model = create_model_from_config(**targs, device=device)
    model.load_state_dict(torch.load(path, map_location=device,
                                     weights_only=True))
    return model.eval(), targs, step


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--checkpoint_path", required=True,
                   help="run directory written by run.train")
    p.add_argument("--step", type=int, default=0,
                   help="checkpoint step to load (0 = newest)")
    p.add_argument("--ema", default="",
                   help="EMA rate to evaluate (e.g. 0.99); empty = raw params")
    p.add_argument("--split", default="valid")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_batches", type=int, default=2)
    p.add_argument("--sample_steps", type=int, default=64,
                   help="reverse-diffusion steps (diffuseq; <=0 = all)")
    p.add_argument("--mbr", type=int, default=1,
                   help="diffuseq: minimum-Bayes-risk decoding over this "
                        "many candidates (1 = single sample)")
    p.add_argument("--no_clamp", action="store_true",
                   help="disable DiffuSeq's nearest-embedding clamping")
    p.add_argument("--prompt_len", type=int, default=0,
                   help="gpt2: prompt prefix length (0 = seq_len/2)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="gpt2: 0 = greedy; > 0 samples from the "
                        "temperature-scaled distribution")
    p.add_argument("--top_k", type=int, default=0,
                   help="gpt2: restrict sampling to the k most likely "
                        "tokens (0 = off)")
    p.add_argument("--top_p", type=float, default=0.0,
                   help="gpt2: nucleus sampling mass (0 = off)")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--out", default="",
                   help="write decoded batches as JSONL to this path")
    p.add_argument("--device", default="",
                   help="torch device; empty = cuda (fails without CUDA "
                        "unless 'cpu' is asked for)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = create_parser()
    ns = parser.parse_args(argv)
    if (ns.top_k > 0 or ns.top_p > 0) and ns.temperature <= 0:
        parser.error("--top_k/--top_p shape the SAMPLING distribution; with "
                     "the default --temperature 0 decoding is greedy and "
                     "they would be silently ignored. Pass --temperature "
                     "> 0.")
    device = resolve_device(ns.device)
    model, targs, step = load_run(ns.checkpoint_path, ns.step, device,
                                  ns.ema)
    data = load_data_from_args(
        ns.split, **{**targs, "batch_size": ns.batch_size,
                     "deterministic": True, "num_loader_proc": 0,
                     "data_loader_workers": 0})
    plen = ns.prompt_len or model.seq_len // 2
    server: Optional[DecodeServer] = None
    accs, losses, golds, preds = [], [], [], []
    with torch.no_grad():
        for i in range(max(ns.num_batches, 0)):
            host = next(data)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in host.items()}
            # distinct streams for the decoder and the loss's draws
            if model.family == "gpt2" and model.scan_layers:
                # stacked blocks have no paged cache: the dense cache
                # decode, as the JAX entry point routes them
                pred = gpt2_decode(model, batch["input_ids"], plen,
                                   temperature=ns.temperature,
                                   top_k=ns.top_k, top_p=ns.top_p,
                                   seed=mix_seed(ns.seed, i, 0))
                gen = (torch.arange(model.seq_len, device=device)[None, :]
                       >= plen).to(torch.int32) * batch["pad_mask"]
                accs.append(target_span_accuracy(
                    pred, dict(batch, input_mask=gen)))
                pred = pred.cpu().numpy()
            elif model.family == "gpt2":
                if server is None:
                    # built once: each batch brings its own seed
                    server = DecodeServer(
                        model, decode_slots=ns.batch_size,
                        page_size=min(model.seq_len, 64),
                        max_prompt_len=model.seq_len, max_len=model.seq_len,
                        prefill_batch=ns.batch_size,
                        temperature=ns.temperature, top_k=ns.top_k,
                        top_p=ns.top_p, seed=ns.seed, device=device)
                pred = one_shot_decode(model, host["input_ids"], plen,
                                       seed=mix_seed(ns.seed, i, 0),
                                       server=server)
                # the generated span's accuracy, on the host (the
                # prediction is already there)
                m = ((np.arange(model.seq_len)[None, :] >= plen)
                     * host["pad_mask"]).astype(np.float64)
                hit = (pred == host["input_ids"]).astype(np.float64)
                accs.append(float((hit * m).sum() / max(m.sum(), 1.0)))
            else:
                pred = diffuseq_sample_mbr(
                    model, batch, seeded_generator(device, ns.seed, i, 0),
                    ns.mbr, ns.sample_steps, clamp=not ns.no_clamp)
                accs.append(target_span_accuracy(pred, batch))
            losses.append(compute_losses(
                model, batch, seeded_generator(device, ns.seed, i, 1))["loss"])
            if ns.out:
                golds.append(host["input_ids"])
                preds.append(pred if isinstance(pred, np.ndarray)
                             else pred.cpu().numpy())
    accs = [float(a) for a in accs]
    losses = [float(x) for x in losses]
    if ns.out:
        with open(ns.out, "w") as f:
            for gold_b, pred_b in zip(golds, preds):
                for gold, p_row in zip(np.asarray(gold_b).tolist(),
                                       np.asarray(pred_b).tolist()):
                    f.write(json.dumps({"gold": gold, "pred": p_row}) + "\n")
    result = {
        "step": step, "params": f"ema_{ns.ema}" if ns.ema else "raw",
        "decode_acc": sum(accs) / len(accs) if accs else None,
        "eval_loss": sum(losses) / len(losses) if losses else None,
        "num_batches": ns.num_batches, "batch_size": ns.batch_size,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
