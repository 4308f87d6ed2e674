#!/usr/bin/env python3
"""Where the time of the PyTorch port's serving path goes, on one GPU.

    python3 scripts/profile_torch_serve.py [--kv_quant fp|int8]
        [--spec_tokens K --spec_draft ngram|model] [--requests N]
        [--trace serve_trace.json]

Serves the ``chip_smoke.py`` workload (GPT-2 base at full width, seeded
random weights, 32 slots, 64 requests of 256 prompt tokens, 128 new tokens,
greedy, decode_span 4) over a bf16 (``fp``) or ``int8`` KV pool three
times: a warm-up, a window timed by the host
clock, and the same window under ``torch.profiler`` (device activity only).
Prints the timed window's wall time, tokens/s and host time in the
engine's prefill and decode calls; the device busy time (sum of the
profiled kernels' device time: one stream, so they do not overlap) and the
idle share against the unprofiled wall; the busy time split into the span
kernel, the decode kernel, the GEMMs and the rest by kernel name; and the
kernels with the most device time.

With ``--spec_tokens K`` the server verifies K-token drafts (``--spec_draft``,
``--draft_layers``) and a fourth window runs under the profiler with host
activity too, the span writers (``write_span_kv`` and the int8
``write_span_kv_q8`` with its O(pool) rescale) and the span seam each
inside a ``record_function`` range, so that the device time of the
kernels each launches is summed per range. The last line is the whole
result as one JSON object. Needs a CUDA device.
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
from distributed_pipeline_tpu_torch.models import backbone  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.serving.scheduler import \
    DecodeServer  # noqa: E402

CFG = dict(model_family="gpt2", vocab_size=50257, seq_len=1024,
           hidden_size=768, num_layers=12, num_heads=12, dtype="bfloat16")


# the functions the span window times as record_function ranges (the
# names the model's attention calls them by)
SPAN_RANGES = ("write_span_kv", "write_span_kv_q8", "paged_span_attention")
# kernel-name parts of the busy-time split (cuBLAS GEMMs on Hopper are
# "nvjet" or "*gemm*" kernels)
PARTS = {"span_kernel": ("flash_span",), "decode_kernel": ("flash_decode",),
         "gemm": ("gemm", "nvjet", "cutlass", "xmma")}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def _part(kernel: str) -> str:
    low = kernel.lower()
    return next((part for part, keys in PARTS.items()
                 if any(k in low for k in keys)), "other")


def _ranged(fn, name):
    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapped


def span_ranges(window) -> dict:
    """One more window under the profiler (host and device activity), each
    of ``SPAN_RANGES`` wrapped in a record_function range: per range, its
    calls and the device ms of the kernels launched inside it."""
    saved = {name: getattr(backbone, name) for name in SPAN_RANGES}
    for name, fn in saved.items():
        setattr(backbone, name, _ranged(fn, name))
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            window()
    finally:
        for name, fn in saved.items():
            setattr(backbone, name, fn)
    out = {}
    for name in SPAN_RANGES:
        events = [e for e in prof.events() if e.name == name
                  and e.device_type == torch.autograd.DeviceType.CPU]
        us = sum(float(getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0)))
                 for e in events)
        out[name] = {"calls": len(events), "device_ms": us / 1e3}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default="",
                    help="also write a Chrome/Perfetto trace here")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--kv_quant", default="fp", choices=("fp", "int8"),
                    help="paged KV storage of the served pool")
    ap.add_argument("--spec_tokens", type=int, default=0,
                    help="speculative decoding: K draft tokens a verify")
    ap.add_argument("--spec_draft", default="ngram",
                    choices=("ngram", "model"))
    ap.add_argument("--draft_layers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=64,
                    help="requests a window (256 prompt, 128 new tokens)")
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
                          kv_quant=args.kv_quant,
                          spec_tokens=args.spec_tokens,
                          spec_draft=args.spec_draft,
                          draft_layers=args.draft_layers, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, CFG["vocab_size"], (256,)).astype(np.int32)
               for _ in range(args.requests)]

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
        steps0 = (server.prefill_steps, server.decode_steps,
                  server.spec_rounds)
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
                "spec_rounds": server.spec_rounds - steps0[2],
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

    ranges = span_ranges(window) if args.spec_tokens else {}

    kernels = [e for e in prof.key_averages() if _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels)
    kernels.sort(key=_device_us, reverse=True)
    rows = [{"kernel": e.key[:90], "calls": e.count,
             "device_ms": _device_us(e) / 1e3,
             "share_of_busy": _device_us(e) / busy_us} for e in kernels]
    parts = {part: {"device_ms": 0.0, "calls": 0}
             for part in (*PARTS, "other")}
    for e in kernels:
        part = parts[_part(e.key)]
        part["device_ms"] += _device_us(e) / 1e3
        part["calls"] += e.count
    wall = timed_run["wall_s"]
    busy_s = busy_us / 1e6
    print(f"wall {wall:.4f} s, device busy {busy_s:.4f} s, idle share "
          f"{1 - busy_s / wall:.4f}, {timed_run['tokens']} tokens, "
          f"{timed_run['tokens'] / wall:.1f} tok/s")
    print(f"host time in engine.prefill {timed_run['host_prefill_s']:.4f} s"
          f", engine.decode {timed_run['host_decode_s']:.4f} s "
          f"({timed_run['prefill_dispatches']} prefill, "
          f"{timed_run['decode_dispatches']} decode dispatches)")
    for name, part in parts.items():
        print(f"busy split: {name} {part['device_ms']:.3f} ms "
              f"({part['device_ms'] * 1e3 / busy_us:.4f} of busy, "
              f"{part['calls']} launches)")
    for name, r in ranges.items():
        print(f"range {name}: {r['calls']} calls, device {r['device_ms']:.3f}"
              f" ms")
    for r in rows[:args.top]:
        print(f"{r['device_ms']:10.3f} ms {r['share_of_busy']:7.4f} "
              f"{r['calls']:7d}  {r['kernel']}")
    print(json.dumps({"card": card, "kv_quant": args.kv_quant,
                      "spec_tokens": args.spec_tokens,
                      "spec_draft": args.spec_draft if args.spec_tokens
                      else None, "requests": args.requests,
                      "kv_pool_bytes": server.engine.kv_pool_bytes(),
                      **timed_run, "device_busy_s": busy_s,
                      "idle_share": 1 - busy_s / wall,
                      "tokens_per_s": timed_run["tokens"] / wall,
                      "busy_split": parts, "span_ranges": ranges,
                      "top_kernels": rows[:args.top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
