#!/usr/bin/env python3
"""Where the time of the PyTorch port's training step goes, on one GPU.

    python3 scripts/profile_torch_train.py [--model_family gpt2|diffuseq]
        [--attention_impl auto|xla|torch] [--fused_update auto|false]
        [--trace train_trace.json]

Trains, with seeded random weights and EMA 0.5/0.9/0.99 through
``TrainLoop``, one of the ``chip_smoke.py`` training configurations:
``gpt2`` (the default), GPT-2 base at full width and its 1024 context on
synthetic-lm batches of 8 in microbatches of 4 at lr 3e-4; or
``diffuseq``, DiffuSeq-base at full width (seq_len 128, vocab 8192) on
synthetic-seq2seq batches of 256 in microbatches of 64 at lr 1e-4, the JAX
package's defaults. 3 warm-up steps, a window of 10 steps timed by the
host clock (each step's metrics fetched before the next, so the window ends
with the device done), and 5 steps under ``torch.profiler`` (device
activity only). The batches
are made before the windows, so data synthesis is not in them. Prints the
step time, tokens/s and MFU of the timed window; the device busy time (sum
of the profiled kernels' device time: one stream, so they do not overlap),
the idle share against the unprofiled per-step wall; the device time of the
port's kernels by name, of the matrix products (cuBLAS/CUTLASS kernels)
and the launch count per step; and the kernels with the most device time.
The last line is the same as one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from distributed_pipeline_tpu_torch.data import load_data_from_args  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.utils.logger import Logger  # noqa: E402
from distributed_pipeline_tpu_torch.utils.perf import mfu  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop  # noqa: E402

# family -> (model config, dataset, batch, microbatch, lr)
RUNS = {
    "gpt2": (dict(model_family="gpt2", vocab_size=50257, seq_len=1024,
                  hidden_size=768, num_layers=12, num_heads=12,
                  dtype="bfloat16"), "synthetic-lm", 8, 4, 3e-4),
    "diffuseq": (dict(model_family="diffuseq", vocab_size=8192, seq_len=128,
                      hidden_size=768, num_layers=12, num_heads=12,
                      diffusion_steps=2000, noise_schedule="sqrt",
                      dtype="bfloat16"), "synthetic-seq2seq", 256, 64, 1e-4),
}
# the bf16 training path's kernels (the f32 arm's FMA kernels never run here)
PORT_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_preprocess_kernel",
                "flash_bwd_sm90_kernel", "flash_bwd_dq_convert_kernel",
                "fused_update_kernel")
# name fragments of the cuBLAS/CUTLASS matrix-product kernels
GEMM_NAMES = ("nvjet", "gemm", "cutlass", "xmma")


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_family", default="gpt2", choices=sorted(RUNS))
    ap.add_argument("--attention_impl", default="auto")
    ap.add_argument("--fused_update", default="auto")
    ap.add_argument("--trace", default="",
                    help="also write a Chrome/Perfetto trace here")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    name = torch.cuda.get_device_name(0)
    cfg, dataset, batch_size, microbatch, lr = RUNS[args.model_family]
    model = create_model_from_config(**cfg, attention_impl=args.attention_impl,
                                     device="cuda")
    loop = TrainLoop(model=model, data=None, batch_size=batch_size,
                     microbatch=microbatch, lr=lr, ema_rate="0.5,0.9,0.99",
                     learning_steps=1000, fused_update=args.fused_update,
                     seed=0, logger=Logger(""))
    data = load_data_from_args("train", batch_size=batch_size,
                               dataset=dataset, seq_len=cfg["seq_len"],
                               vocab_size=cfg["vocab_size"], seed=0)
    batches = [next(data) for _ in range(18)]
    tokens_per_step = batch_size * cfg["seq_len"]

    def steps(bs) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            float(loop.run_step(b)["loss"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    steps(batches[:3])                                  # warm-up
    wall = steps(batches[3:13])
    step_s = wall / 10
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        steps(batches[13:18])
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.key_averages() if _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels) / 5    # per step
    kernels.sort(key=_device_us, reverse=True)
    rows = [{"kernel": e.key[:90], "calls_per_step": e.count / 5,
             "device_ms_per_step": _device_us(e) / 5e3,
             "share_of_busy": _device_us(e) / 5 / busy_us} for e in kernels]
    port = {k: sum(r["device_ms_per_step"] for r in rows if k in r["kernel"])
            for k in PORT_KERNELS}
    gemm_ms = sum(_device_us(e) for e in kernels
                  if any(g in e.key.lower() for g in GEMM_NAMES)) / 5e3
    tps = tokens_per_step / step_s
    out = {"card": card, "model_family": args.model_family,
           "attention_impl": args.attention_impl,
           "fused_update": args.fused_update, "step_time_s": step_s,
           "tokens_per_sec_per_chip": tps,
           "mfu": mfu(tps, loop._flops_per_token, name),
           "device_busy_s_per_step": busy_us / 1e6,
           "idle_share": 1 - busy_us / 1e6 / step_s,
           "port_kernels_ms_per_step": port,
           "gemm_ms_per_step": gemm_ms,
           "gemm_share_of_busy": gemm_ms / (busy_us / 1e3),
           "kernel_launches_per_step": sum(e.count for e in kernels) / 5,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "top_kernels": rows[:args.top]}
    print(f"step {step_s * 1e3:.3f} ms, {tps:.1f} tok/s, mfu {out['mfu']:.4f}"
          f", device busy {busy_us / 1e3:.3f} ms/step, idle share "
          f"{out['idle_share']:.4f}")
    print(f"port kernels (ms/step): {port}; GEMMs {gemm_ms:.3f} ms/step "
          f"({out['gemm_share_of_busy']:.4f} of busy); "
          f"{out['kernel_launches_per_step']:.0f} launches/step")
    for r in rows[:args.top]:
        print(f"{r['device_ms_per_step']:10.3f} ms {r['share_of_busy']:7.4f} "
              f"{r['calls_per_step']:7.1f}  {r['kernel']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
