#!/usr/bin/env python3
"""Where the time of the PyTorch port's serving path goes, on one GPU.

    python3 scripts/profile_torch_serve.py [--kv_quant fp|int8]
        [--trace serve_trace.json]

Serves the ``chip_smoke.py`` workload (GPT-2 base at full width, seeded
random weights, 32 slots, 64 requests of 256 prompt tokens, 128 new tokens,
greedy, decode_span 4) over a bf16 (``fp``) or ``int8`` KV pool three
times: a warm-up, a window timed by the host
clock, and the same window under ``torch.profiler`` (device activity only).
Prints the timed window's wall time, tokens/s and host time in the
engine's prefill and decode calls; the device busy time (sum of the
profiled kernels' device time: one stream, so they do not overlap) and the
idle share against the unprofiled wall; and the kernels with the most device
time. The last line is the same as one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_pipeline_tpu_torch.convert import init_params  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.serving.scheduler import \
    DecodeServer  # noqa: E402

CFG = dict(model_family="gpt2", vocab_size=50257, seq_len=1024,
           hidden_size=768, num_layers=12, num_heads=12, dtype="bfloat16")


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default="",
                    help="also write a Chrome/Perfetto trace here")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--kv_quant", default="fp", choices=("fp", "int8"),
                    help="paged KV storage of the served pool")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    model = create_model_from_config(**CFG, device="cuda")
    model.load_state_dict(init_params(CFG, seed=0))
    server = DecodeServer(model, decode_slots=32, page_size=16,
                          max_prompt_len=512, decode_span=4, dispatch_lag=2,
                          kv_quant=args.kv_quant, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, CFG["vocab_size"], (256,)).astype(np.int32)
               for _ in range(64)]

    host_s = {"prefill": 0.0, "decode": 0.0}
    for name in host_s:
        inner = getattr(server.engine, name)

        def timed(*a, _inner=inner, _name=name):
            t = time.perf_counter()
            out = _inner(*a)
            host_s[_name] += time.perf_counter() - t
            return out
        setattr(server.engine, name, timed)

    def window() -> dict:
        """Serve the 64 requests once; wall time, tokens and dispatches."""
        steps0 = (server.prefill_steps, server.decode_steps)
        tokens0 = server.tokens_fetched
        host_s.update(prefill=0.0, decode=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts:
            server.submit(p, max_new_tokens=128)
        server.drain()
        torch.cuda.synchronize()
        return {"wall_s": time.perf_counter() - t0,
                "tokens": server.tokens_fetched - tokens0,
                "prefill_dispatches": server.prefill_steps - steps0[0],
                "decode_dispatches": server.decode_steps - steps0[1],
                "host_prefill_s": host_s["prefill"],
                "host_decode_s": host_s["decode"]}

    window()                                     # warm-up
    timed_run = window()                         # wall clock, no profiler
    # the same window again under the profiler (device activity only): the
    # kernels' device times, whose sum over the unprofiled wall gives the
    # busy share
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        window()
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.key_averages() if _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels)
    kernels.sort(key=_device_us, reverse=True)
    rows = [{"kernel": e.key[:90], "calls": e.count,
             "device_ms": _device_us(e) / 1e3,
             "share_of_busy": _device_us(e) / busy_us} for e in kernels]
    wall = timed_run["wall_s"]
    busy_s = busy_us / 1e6
    print(f"wall {wall:.4f} s, device busy {busy_s:.4f} s, idle share "
          f"{1 - busy_s / wall:.4f}, {timed_run['tokens']} tokens, "
          f"{timed_run['tokens'] / wall:.1f} tok/s")
    print(f"host time in engine.prefill {timed_run['host_prefill_s']:.4f} s"
          f", engine.decode {timed_run['host_decode_s']:.4f} s "
          f"({timed_run['prefill_dispatches']} prefill, "
          f"{timed_run['decode_dispatches']} decode dispatches)")
    for r in rows[:args.top]:
        print(f"{r['device_ms']:10.3f} ms {r['share_of_busy']:7.4f} "
              f"{r['calls']:7d}  {r['kernel']}")
    print(json.dumps({"card": card, "kv_quant": args.kv_quant,
                      "kv_pool_bytes": server.engine.kv_pool_bytes(),
                      **timed_run, "device_busy_s": busy_s,
                      "idle_share": 1 - busy_s / wall,
                      "tokens_per_s": timed_run["tokens"] / wall,
                      "top_kernels": rows[:args.top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
