#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card: ``nvidia-smi`` name and power limit; CUDA must be available;
2. build: every CUDA kernel from ``distributed_pipeline_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel), with each kernel's registers,
   shared memory and spills from the compiler's report;
3. decode kernel: ``flash_decode`` against its plain version
   ``torch_paged_decode`` at the serving shapes (H=12, Dh=64, page_size 16,
   32 slots, 64-page reservations; an empty slot, page edges, interior and
   full-reservation positions, a shared page), over fp pools in f32 and
   bf16 and int8 pools (per-page scales) with f32 and bf16 q, plus one slot
   at position 1023 (64 one-page chunks) and positions on both sides of
   every chunk edge; two calls on the same inputs must be bitwise equal.
   The bf16 and int8 kernels are timed by ``torch.profiler`` device time
   (clean cold L2, and after a dirty flush) in turns beside one
   ``scaled_dot_product_attention`` call over pre-gathered (and, for int8,
   dequantized) K/V (a yardstick the port never calls), with the plain
   version's time and the bound: the kernel's own bytes,
   ``decode_hbm_bytes(step_table=False)``, over the card's memory rate;
4. flash kernels: ``flash_forward`` / ``flash_backward`` against
   ``torch_flash_forward`` / ``torch_flash_backward`` at the training shape
   (B=4, H=12, L=1024, Dh=64, causal, bf16, the all-ones pad mask the model
   passes), a padded ragged bf16 case (L=1000, lengths 1000/733/1/0),
   small f32 cases (Dh 64 and 128), and bf16 cases at Dh=128 (L=1024),
   at L = 1, 65 and 129 (ragged against the 128-row tile) and non-causal
   with a dead row; bf16 is held against the plain version evaluated in
   f32 from the same bf16 inputs, and two bf16 backward calls on the same
   inputs must give bitwise-equal dq, dk and dv (dq's parts are summed in a
   fixed order), as must a call whose key tiles are split over several
   launches (the dq scratch cap made small). Times at the training
   shape beside ``scaled_dot_product_attention(is_causal)`` and its
   autograd backward (yardsticks), in turns in one call: device time from
   ``torch.profiler`` (the CUDA-event time, which also counts the host's
   enqueue, beside it), with the plain versions' times, achieved TFLOP/s,
   share of the bound and the ratio to the library;
5. fused update: ``fused_adamw_ema`` against ``torch_fused_update`` over
   GPT-2 base's parameter count with 3 EMA rates, bitwise over 3 steps,
   timed beside its byte bound and ``torch.optim.AdamW(fused=True)`` (a
   yardstick only: another op order and no EMA);
6. small-model check: greedy serving of a small f32 GPT-2 on the GPU
   (through the kernel) gives the same tokens as on the CPU (plain
   version);
7. serve: GPT-2 base at full width (hidden 768, 12 layers, 12 heads, vocab
   50257, seq_len 1024) with seeded random weights, through ``run.serve``
   on 32 slots, 64 requests of 256 prompt tokens, 128 new tokens each,
   greedy, twice: over a bf16 KV pool and with ``--kv_quant int8``. Every
   request must get its tokens, the kernel must have run 12 x decode_span
   x decode_steps times over that run's page type (and never over the
   other); then one decode step from a live state through the kernel and
   through the plain version, logits compared and next tokens equal (the
   int8 pool at f32 compute, where both arms read the same K/V values; its
   bf16 comparison is printed), and the kernel timed at that state's
   depths beside its bound there. The int8 pool must hold at most 0.55x
   the fp pool's bytes;
7b. speculative decoding: the span seam's kernel arm at the serve shapes
   (32 slots x (K + 1) links, K = 4) over bf16 and int8 pools against
   ``torch_paged_span_decode``: bf16 q on the span kernel ``flash_span``
   (launches on its counter, none on the decode kernel's), f32 q on the
   decode kernel over 32 x (K + 1) pseudo-slots (the decode phase's bars;
   two calls bitwise equal); the span kernel timed beside its bound
   (``span_hbm_bytes``), the pseudo-slot route on the same bf16 inputs and
   one ``scaled_dot_product_attention`` call over pre-gathered K/V with a
   [K + 1, Lmax] mask; then ``run.serve --spec_tokens 4`` at GPT-2 base
   width: the ngram draft over a bf16 pool (the serve phase's 64
   requests) and the model draft (``--draft_layers 2``) over an int8 pool
   (16 requests): every request's tokens, the span launches (12 a verify
   round, all on the span kernel), tokens/s and ``accept_rate`` beside the
   non-spec run's; in bf16 the share of streams identical to the non-spec
   run's and the top-2 logit gap at every first divergence (each at most
   2% of that position's largest |logit|); and at f32 compute (the pseudo-slot
   route), 32 requests of 64 tokens on each pool, the spec streams equal
   the non-spec ones token for token;
8. train: GPT-2 base at full width and its 1024 context through
   ``run.train`` (synthetic-lm, batch 8 in microbatches of 4, 20 steps, lr
   3e-4, EMA 0.5/0.9/0.99, attention and update ``auto``): the flash
   kernels must run 12 x 2 x 20 times each and the update once a step,
   every loss must be finite and the last below the first, the run dir
   must hold the final model/EMA/optimizer files and ``run.serve`` must
   answer 4 requests from it; then one step from the saved state with the
   kernels and with the plain versions, loss and grad norm compared, and a
   second kernel step from the same state bitwise equal to the first
   (loss, grad norm, every gradient);
9. diffuseq: DiffuSeq-base at full width (hidden 768, 12 layers, 12 heads,
   emb_dim 128, vocab 8192, seq_len 128, 2000 ``sqrt`` diffusion steps;
   91,039,872 parameters) through ``run.train`` with the JAX package's
   defaults (no family flag; batch 256 in microbatches of 64, 20 steps,
   EMA 0.5/0.9/0.99, attention and update ``auto``): the update must run
   once a step and the flash kernels never (the dense arm at 128, the JAX
   rule), every loss finite and the last below the first, the run dir's
   final files present; one step from the saved state with the fused
   update and with its plain version; then DiffuSeq-base at seq_len 1024
   (batch 8 in microbatches of 4, padded rows), one step through ``auto``
   (the flash kernels' bidirectional, pad-masked arm: 24 + 24 launches, 1
   update) and one through the plain versions (none), loss within 0.5% and
   grad norm within 3%; then ``run.sample`` on the trained run dir (2
   batches of 32, 20 reverse-diffusion steps): ``decode_acc`` in [0, 1],
   ``eval_loss`` finite. The fused update is also held against its plain
   version and timed at DiffuSeq-base's parameter count (phase 5's checks).

Before and after every timed phase a ``# clocks`` line gives the card's SM
and memory clocks, power draw and temperature (``nvidia-smi``). The line
before the last is ``{"kernels": [...]}`` and the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

GPT2_BASE = dict(model_family="gpt2", model_size="base", vocab_size=50257,
                 seq_len=1024, hidden_size=768, num_layers=12, num_heads=12,
                 dtype="bfloat16")
DIFFUSEQ_BASE = dict(model_family="diffuseq", model_size="base",
                     vocab_size=8192, seq_len=128, hidden_size=768,
                     num_layers=12, num_heads=12, diffusion_steps=2000,
                     noise_schedule="sqrt", dtype="bfloat16")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def clocks(tag: str) -> None:
    """The card's SM and memory clocks, power draw and temperature, on a
    line of their own beside a timed phase."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# clocks {tag}: {out}", flush=True)


def clocked(tag: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` between two ``# clocks`` lines; the second
    also gives the phase's wall time."""
    clocks(f"before {tag}")
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        clocks(f"after {tag} ({time.perf_counter() - t0:.1f} s)")


def time_ms(fn, torch, flush, reps: int = 30) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up,
    each launch with a cold L2 (``flush`` overwrites a buffer larger than
    the cache between launches, outside the timed window)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, torch, flush, reps: int = 20,
              clean_l2: bool = False) -> tuple:
    """Device time of one ``fn()`` call and its split by kernel name: the
    kernels (and memsets) it launches, summed from ``torch.profiler``'s CUDA
    activity over ``reps`` calls, each after an L2 flush whose own kernels
    are left out. The flush writes ``flush`` (``zero_``), which leaves the
    cache full of dirty lines that the call's reads must first evict, or
    with ``clean_l2`` reads it, which leaves the cache cold and clean.
    Unlike ``time_ms`` it does not count the host's enqueue time, which
    exceeds the device time of a call this short."""
    wipe = (lambda: flush.max()) if clean_l2 else flush.zero_
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):   # a reduction's memsets come and go
            wipe()
        torch.cuda.synchronize()
    skip = {e.key for e in prof.key_averages()}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            wipe()
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        if us > 0 and e.key not in skip:
            split[e.key[:80]] = us / reps / 1e3
    return sum(split.values()), split


def decode_case(torch, B, n, pos, seed, shared=True, H=12, Dh=64, ps=16):
    """Seeded q and pools on the card (f32), the same pools as int8 pages
    with per-page scales (absmax / 127, as the serving writers make them),
    a block table of distinct pages (slot 2's first page shared with slot
    1's when ``shared``) and the positions."""
    dev = torch.device("cuda")
    P = 1 + B * n
    g = torch.Generator(device=dev).manual_seed(seed)
    table = 1 + torch.arange(B * n, dtype=torch.int32, device=dev).view(B, n)
    if shared:
        table[2, 0] = table[1, 0]
    c = {"table": table, "ps": ps, "H": H, "Dh": Dh,
         "positions": torch.tensor(pos, dtype=torch.int32, device=dev),
         "q": torch.randn((B, H, Dh), generator=g, device=dev)}
    for name in ("k", "v"):
        pages = torch.randn((P, ps, H, Dh), generator=g, device=dev)
        scale = pages.abs().amax(dim=(1, 2, 3)) / 127.0
        c["p" + name] = pages
        c[name + "8"] = torch.clamp(torch.round(pages / scale[:, None, None,
                                                              None]),
                                    -127, 127).to(torch.int8)
        c["s" + name] = scale
    return c


def decode_args(c, dtype, int8: bool) -> tuple:
    """flash_decode's arguments for a case: q in ``dtype``, and fp pools in
    ``dtype`` or the int8 pools with their scales."""
    q = c["q"].to(dtype)
    if int8:
        return (q, c["k8"], c["v8"], c["table"], c["positions"], c["sk"],
                c["sv"])
    return (q, c["pk"].to(dtype), c["pv"].to(dtype), c["table"],
            c["positions"])


def decode_check(torch, fd, c, dtype, int8: bool) -> float:
    """One kernel call against the plain version evaluated in f32 from the
    same inputs (int8: the same int8 pages and scales); dead slots must be
    zero. f32 within 1e-4 rel / 1e-5 abs (another summation order); bf16
    within 8e-3 rel and abs (the kernel rounds its f32 result to bf16
    once). Returns the max abs error."""
    args = decode_args(c, dtype, int8)
    got = fd.flash_decode(*args)
    torch.cuda.synchronize()
    f32 = [a.float() if a.dtype in (torch.float32, torch.bfloat16) else a
           for a in args]
    ref = fd.torch_paged_decode(*f32)
    tol = (1e-4, 1e-5) if dtype == torch.float32 else (8e-3, 8e-3)
    err = (got.float() - ref).abs()
    check(bool(torch.all(err <= tol[1] + tol[0] * ref.abs())),
          f"flash_decode {dtype} {'int8' if int8 else 'fp'} pools disagree "
          f"with the plain version: max abs err {float(err.max())}")
    dead = (c["positions"] < 0).nonzero().flatten().tolist()
    check(all(bool(torch.all(got[b] == 0)) for b in dead),
          "a dead slot is not zero")
    return float(err.max())


def kernel_phase(torch, fd, bw, bf16_peak) -> list:
    """flash_decode vs torch_paged_decode over fp and int8 pools at the
    serving shapes, a long split slot and chunk-edge positions; two calls
    bitwise equal; both branches timed beside their bounds and the library
    in one call."""
    from distributed_pipeline_tpu_torch.serving.paged_kv import (
        dequant_gathered, gather_kv)

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    B, n = 32, 64
    # dead slot, one live key, exact page ends and starts, interior, full
    # reservation, then the serve phase's depths (256 prompt + decode)
    main = decode_case(torch, B, n, [-1, 0, 15, 16, 31, 255, 256, 1023]
                       + [256 + 5 * i for i in range(B - 8)], seed=0)
    # one slot at the end of its reservation: one page a chunk, 64 chunks
    long_slot = decode_case(torch, 1, n, [1023], seed=1, shared=False)
    # both sides of every 4-page chunk edge of the serving plan
    edges = decode_case(torch, B, n, [min(64 * k + d, 1023)
                                      for k in range(1, 17)
                                      for d in (-1, 0)], seed=2)
    plans = {name: fd.decode_plan(len(c["positions"]), 12, 64, 16, n, kb,
                                  *fd.device_limits(dev))._asdict()
             for name, c, kb in (("main_bf16", main, 2), ("main_int8", main, 1),
                                 ("long_slot", long_slot, 2))}
    print(f"# decode plans: {json.dumps(plans)}", flush=True)
    errs = {}
    for int8 in (False, True):
        kind = "int8" if int8 else "fp"
        for dtype in (f32, bf16):
            errs[f"{kind}_{str(dtype)[6:]}"] = decode_check(torch, fd, main,
                                                            dtype, int8)
        errs[f"{kind}_long_slot"] = decode_check(torch, fd, long_slot, bf16,
                                                 int8)
        errs[f"{kind}_chunk_edges"] = decode_check(torch, fd, edges, bf16,
                                                   int8)
        args = decode_args(main, bf16, int8)
        a, b = fd.flash_decode(*args), fd.flash_decode(*args)
        check(torch.equal(a, b), f"two {kind} calls on the same inputs "
              f"differ by {float((a.float() - b.float()).abs().max())}")
    print(f"# decode check: max abs err {json.dumps(errs)}; two calls "
          f"bitwise equal (fp and int8 pools)", flush=True)

    # times at the main path's dtype (bf16 q), both pool types
    table, positions = main["table"], main["positions"]
    ps = main["ps"]
    fp_args, q8_args = decode_args(main, bf16, False), decode_args(main, bf16,
                                                                   True)
    q = fp_args[0][:, :, None]
    live = (torch.arange(n * ps, device=dev)[None, :]
            <= positions[:, None])[:, None, None, :]
    # the library's inputs are gathered (and dequantized) beforehand: only
    # the attention itself is timed
    ks, vs = gather_kv(fp_args[1], table), gather_kv(fp_args[2], table)
    ks8 = dequant_gathered(gather_kv(main["k8"], table), main["sk"], table,
                           ps, bf16)
    vs8 = dequant_gathered(gather_kv(main["v8"], table), main["sv"], table,
                           ps, bf16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {"fp": lambda: fd.flash_decode(*fp_args),
           "fp_lib": lambda: sdpa(q, ks, vs, attn_mask=live),
           "int8": lambda: fd.flash_decode(*q8_args),
           "int8_lib": lambda: sdpa(q, ks8, vs8, attn_mask=live)}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    # device ms, one per turn: after a clean flush of L2 (the bound's
    # assumption: every input comes from device memory, nothing is written
    # back), and after a dirty one (a write of the flush buffer)
    runs = {name: [] for name in fns}
    dirty = {name: [] for name in fns}
    event = {name: [] for name in fns}      # CUDA-event ms, host included
    split = {}
    for order in (("fp", "fp_lib", "int8", "int8_lib"),
                  ("fp_lib", "fp", "int8_lib", "int8")):
        for name in order:
            total, split[name] = device_ms(fns[name], torch, flush,
                                           clean_l2=True)
            runs[name].append(total)
            dirty[name].append(device_ms(fns[name], torch, flush)[0])
            event[name].append(time_ms(fns[name], torch, flush))
    ms = {name: statistics.median(t) for name, t in runs.items()}
    plain = {"fp": time_ms(lambda: fd.torch_paged_decode(*fp_args), torch,
                           flush),
             "int8": time_ms(lambda: fd.torch_paged_decode(*q8_args), torch,
                             flush)}
    rows = []
    for kind in ("fp", "int8"):
        int8 = kind == "int8"
        row = {
            "name": "flash_decode_int8" if int8 else "flash_decode",
            "route": "cuda",
            "source": "distributed_pipeline_tpu_torch/ops/csrc/"
                      "flash_decode.cu",
            "replaces": "distributed_pipeline_tpu/ops/flash_decode.py:155",
            "launches": None,
            "max_abs_err": errs[f"{kind}_bfloat16"],
            "max_abs_err_f32": errs[f"{kind}_float32"],
            "max_abs_err_long_slot": errs[f"{kind}_long_slot"],
            "max_abs_err_chunk_edges": errs[f"{kind}_chunk_edges"],
            "ms": ms[kind], "ms_runs": runs[kind],
            "ms_dirty_l2": statistics.median(dirty[kind]),
            "event_ms": event[kind], "kernels_ms": split[kind],
            "plain_ms": plain[kind],
            **kernel_bound(fd, table, positions, ps, 12, 64, bw, bf16_peak,
                           quantized=int8),
            "library_ms": ms[kind + "_lib"],
            "library_ms_runs": runs[kind + "_lib"],
            "library_ms_dirty_l2": statistics.median(dirty[kind + "_lib"]),
            "library_event_ms": event[kind + "_lib"],
            "library_kernels_ms": split[kind + "_lib"],
            "library_call": "scaled_dot_product_attention over pre-gathered "
                            + ("and dequantized bf16 K/V (gather and "
                               "dequant excluded)" if int8 else
                               "K/V (the gather excluded)"),
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["x_library"] = row["ms"] / row["library_ms"]
        print(f"# decode timing: {row['name']} {row['ms']:.6f} ms "
              f"({row['share_of_bound']:.3f} of the bound "
              f"{row['bound_ms']:.6f} ms, {row['x_library']:.3f}x the "
              f"library's {row['library_ms']:.6f} ms; device time, clean "
              f"cold L2; after a dirty flush {row['ms_dirty_l2']:.6f} vs "
              f"{row['library_ms_dirty_l2']:.6f} ms; CUDA events, host "
              f"enqueue included: {row['event_ms']} vs "
              f"{row['library_event_ms']}; plain {row['plain_ms']:.5f} ms)",
              flush=True)
        rows.append(row)
    return rows


def kernel_bound(fd, table, positions, ps, H, Dh, bw, bf16_peak,
                 quantized: bool = False) -> dict:
    """The least time the card could take for one flash_decode call with
    bf16 q on these inputs: the larger of the kernel's own bytes
    (``decode_hbm_bytes(step_table=False)``: distinct live K/V pages, 2
    bytes an element or 1 for int8 pools, q, out, live table entries,
    positions, and for int8 the two scales of each live entry) over the
    memory rate and its flops (q.k and p.v over the live keys) over the
    bf16 peak."""
    bt, pos = table.cpu().numpy(), positions.cpu().numpy()
    hbm_bytes = fd.decode_hbm_bytes(bt, pos, ps, H, Dh, dtype_bytes=2,
                                    quantized=quantized, step_table=False)
    live_keys = sum(min(int(p) + 1, bt.shape[1] * ps) for p in pos if p >= 0)
    flops = 4 * live_keys * H * Dh                 # q.k and p.v, 2 each
    bytes_ms, ops_ms = hbm_bytes / bw * 1e3, flops / bf16_peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "hbm_bytes": hbm_bytes}


def span_bound(fd, table, positions, ps, H, Dh, bw, bf16_peak,
               quantized: bool = False) -> dict:
    """The least time the card could take for one span call with bf16 q
    (``positions`` [B, L]): the larger of the span kernel's own bytes
    (``span_hbm_bytes``: distinct live K/V pages once, 2 bytes an element
    or 1 for int8 pools, q and out per link, each slot's live table
    entries once, a position a link, and for int8 the two scales of each
    live entry) over the memory rate and its flops (q.k and p.v over each
    link's live keys) over the bf16 peak."""
    bt, pos = table.cpu().numpy(), positions.cpu().numpy()
    live_keys = sum(min(int(p) + 1, bt.shape[1] * ps)
                    for p in pos.reshape(-1) if p >= 0)
    return bound(fd.span_hbm_bytes(bt, pos, ps, H, Dh, dtype_bytes=2,
                                   quantized=quantized),
                 4 * live_keys * H * Dh, bw, bf16_peak)  # q.k and p.v


def span_phase(torch, fd, bw, bf16_peak) -> list:
    """The span seam's kernel arm (``paged_span_attention``) against its
    plain twin ``torch_paged_span_decode`` at the serve shapes (32 slots,
    H=12, Dh=64, page 16, 64-page reservations, K=4), over bf16 and int8
    pools: bf16 q on the span kernel (``flash_span``: one launch on its
    counter, none on the decode kernel's), f32 q on the decode kernel over
    B*(K+1) pseudo-slots (the strict bar), with the decode check's bars;
    two bf16 calls bitwise equal. Timed in turns (clean cold L2): the span
    kernel beside its bound (``span_hbm_bytes``), the pseudo-slot route
    on the same bf16 inputs, and one ``scaled_dot_product_attention`` over
    pre-gathered K/V with a [K+1, Lmax] mask."""
    from distributed_pipeline_tpu_torch.serving.paged_kv import (
        dequant_gathered, gather_kv)

    dev = torch.device("cuda")
    B, n, K, H, Dh, ps = 32, 64, 4, 12, 64, 16
    L = K + 1
    # the serve phase's depths, a slot at position 0, one straddling a
    # page edge, and two at the end of the reservation (clamped links)
    idx = [0, 12, 1019, 1022] + [256 + 5 * i for i in range(B - 4)]
    c = decode_case(torch, B, n, idx, seed=4)
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((B, H, L, Dh), generator=g, device=dev)
    pos = torch.clamp(c["positions"][:, None] + torch.arange(
        L, dtype=torch.int32, device=dev)[None, :], max=n * ps - 1)
    table = c["table"]
    pools = {"fp": lambda dt: (c["pk"].to(dt), c["pv"].to(dt)),
             "int8": lambda dt: (c["k8"], c["v8"], c["sk"], c["sv"])}

    def span(kind, dt, impl="cuda", upcast=False):
        # upcast: the same ``dt`` inputs, evaluated in f32
        pk, pv, *sc = pools[kind](dt)
        qd = q.to(dt)
        if upcast:
            qd = qd.float()
            pk, pv = (t.float() if t.is_floating_point() else t
                      for t in (pk, pv))
        return fd.paged_span_attention(qd, pk, pv, table, pos,
                                       impl=impl, scales_k=(sc or [None])[0],
                                       scales_v=(sc or [None, None])[1])

    errs = {}
    for kind in ("fp", "int8"):
        for dt in (torch.float32, torch.bfloat16):
            fd.reset_launch_count()
            got = span(kind, dt)
            torch.cuda.synchronize()
            # bf16 on the span kernel, f32 on the decode kernel
            routed = ((fd.span_kernel_launch_count(kind), fd.launch_count())
                      if dt == torch.bfloat16 else
                      (fd.launch_count(kind), fd.span_kernel_launch_count()))
            check(routed == (1, 0), f"span {kind} {dt}: launches (route, "
                  f"other kernel) {routed}, expected (1, 0)")
            ref = span(kind, dt, impl="torch", upcast=True)
            tol = (1e-4, 1e-5) if dt == torch.float32 else (8e-3, 8e-3)
            err = (got.float() - ref).abs()
            check(bool(torch.all(err <= tol[1] + tol[0] * ref.abs())),
                  f"span kernel {kind} {dt} disagrees with the plain twin: "
                  f"max abs err {float(err.max())}")
            errs[f"{kind}_{str(dt)[6:]}"] = float(err.max())
        a, b = span(kind, torch.bfloat16), span(kind, torch.bfloat16)
        check(torch.equal(a, b), f"two {kind} span calls differ")
    print(f"# span check: max abs err {json.dumps(errs)} (bf16: the span "
          f"kernel, f32: the decode kernel over pseudo-slots); two bf16 "
          f"calls bitwise equal (fp and int8 pools)", flush=True)
    plans = {kind: fd.span_plan(B, L, H, Dh, ps, n, kb,
                                *fd.device_limits(dev))._asdict()
             for kind, kb in (("fp", 2), ("int8", 1))}
    print(f"# span plans: {json.dumps(plans)}", flush=True)

    bf16 = torch.bfloat16
    live = (torch.arange(n * ps, device=dev)[None, None, :]
            <= pos[:, :, None])[:, None]                 # [B, 1, L, Lmax]
    ks, vs = gather_kv(c["pk"].to(bf16), table), gather_kv(c["pv"].to(bf16),
                                                           table)
    ks8 = dequant_gathered(gather_kv(c["k8"], table), c["sk"], table, ps,
                           bf16)
    vs8 = dequant_gathered(gather_kv(c["v8"], table), c["sv"], table, ps,
                           bf16)
    qb = q.to(bf16)
    args = {"fp": (qb, *pools["fp"](bf16), table, pos),
            "int8": (qb, c["k8"], c["v8"], table, pos)}
    scales = {"fp": {}, "int8": {"scales_k": c["sk"], "scales_v": c["sv"]}}

    def seam(kind, impl="cuda"):
        return fd.paged_span_attention(*args[kind], impl=impl,
                                       **scales[kind])

    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {"fp": lambda: seam("fp"),
           "fp_pseudo": lambda: fd.pseudo_slot_span(*args["fp"]),
           "fp_lib": lambda: sdpa(qb, ks, vs, attn_mask=live),
           "int8": lambda: seam("int8"),
           "int8_pseudo": lambda: fd.pseudo_slot_span(*args["int8"],
                                                      **scales["int8"]),
           "int8_lib": lambda: sdpa(qb, ks8, vs8, attn_mask=live)}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    runs = {name: [] for name in fns}
    split = {}
    for order in (("fp", "fp_pseudo", "fp_lib", "int8", "int8_pseudo",
                   "int8_lib"),
                  ("fp_lib", "fp_pseudo", "fp", "int8_lib", "int8_pseudo",
                   "int8")):
        for name in order:
            total, split[name] = device_ms(fns[name], torch, flush,
                                           clean_l2=True)
            runs[name].append(total)
    ms = {name: statistics.median(t) for name, t in runs.items()}
    rows = []
    for kind in ("fp", "int8"):
        plain = time_ms(lambda: seam(kind, impl="torch"), torch, flush,
                        reps=10)
        kernel = [v for k, v in split[kind].items() if "flash_span" in k]
        row = {"name": "flash_decode_span" + ("_int8" if kind == "int8"
                                              else ""),
               "route": "cuda",
               "source": "distributed_pipeline_tpu_torch/ops/csrc/"
                         "flash_span.cu",
               "replaces": "distributed_pipeline_tpu/ops/flash_decode.py:328",
               "call_site": "ops/flash_decode.py paged_span_attention, "
                            f"{B} slots x {L} links",
               "launches": None, "max_abs_err": errs[f"{kind}_bfloat16"],
               "max_abs_err_f32_pseudo_slot": errs[f"{kind}_float32"],
               "ms": ms[kind], "ms_runs": runs[kind],
               "kernels_ms": split[kind], "span_kernel_ms": sum(kernel),
               "pseudo_slot_ms": ms[kind + "_pseudo"],
               "pseudo_slot_ms_runs": runs[kind + "_pseudo"],
               "pseudo_slot_kernels_ms": split[kind + "_pseudo"],
               "plain_ms": plain,
               **span_bound(fd, table, pos, ps, H, Dh, bw, bf16_peak,
                            quantized=kind == "int8"),
               "library_ms": ms[kind + "_lib"],
               "library_ms_runs": runs[kind + "_lib"],
               "library_call": "scaled_dot_product_attention over "
                               "pre-gathered " + ("and dequantized " if
                                                  kind == "int8" else "")
                               + "K/V with a [K+1, Lmax] mask"}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["x_library"] = row["ms"] / row["library_ms"]
        row["x_pseudo_slot"] = row["ms"] / row["pseudo_slot_ms"]
        print(f"# span timing: {row['name']} {row['ms']:.6f} ms, of it "
              f"the span kernel {row['span_kernel_ms']:.6f} ms "
              f"({row['share_of_bound']:.3f} of the bound "
              f"{row['bound_ms']:.6f} ms, {row['x_library']:.3f}x the "
              f"library's {row['library_ms']:.6f} ms, "
              f"{row['x_pseudo_slot']:.3f}x the pseudo-slot route's "
              f"{row['pseudo_slot_ms']:.6f} ms; device time, clean cold "
              f"L2; plain {plain:.5f} ms)", flush=True)
        rows.append(row)
    return rows


def spec_run(torch, fd, run, draft: str, kv_quant: str, requests: int,
             base: dict) -> dict:
    """``run.serve --spec_tokens 4`` at GPT-2 base width: every request's
    tokens, the span launches (12 a verify round, over the run's page
    type only), and, against the non-spec run of the same pool (``base``:
    its summary and streams), tokens/s, the share of identical streams
    and the top-2 logit gap at each first divergence (bf16: the two paths
    run different GEMM shapes and split-K plans)."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.run.serve import serve

    K, new_tokens, layers = 4, 128, GPT2_BASE["num_layers"]
    settings = parse_settings([
        "--checkpoint_path", run, "--decode_slots", "32",
        "--page_size", "16", "--max_prompt_len", "512",
        "--synthetic_requests", str(requests), "--synthetic_prompt_len",
        "256", "--max_new_tokens", str(new_tokens), "--temperature", "0",
        "--decode_impl", "auto", "--kv_quant", kv_quant,
        "--spec_tokens", str(K), "--spec_draft", draft,
        "--draft_layers", "2"])
    fd.reset_launch_count()
    summary, server, reqs = serve(settings)
    check(len(reqs) == requests, f"{len(reqs)} requests served")
    for r in reqs:
        check(len(r.tokens) == new_tokens
              and all(0 <= t < GPT2_BASE["vocab_size"] for t in r.tokens),
              f"spec request {r.id} returned {len(r.tokens)} tokens")
    rounds = server.spec_rounds
    span = fd.span_launch_count()
    span_kernel = fd.span_kernel_launch_count(kv_quant)
    draft_launches = 2 * K * rounds if draft == "model" else 0
    other = "fp" if kv_quant == "int8" else "int8"
    # every verify (bf16 q) runs on the span kernel, over the run's page
    # type; the decode kernel runs only the model draft's steps
    check(span == span_kernel == summary["span_kernel_launches"]
          == layers * rounds
          and fd.launch_count(kv_quant) == draft_launches
          and fd.launch_count(other) == 0
          and fd.span_kernel_launch_count(other) == 0,
          f"spec {draft}/{kv_quant}: span launches {span} ({span_kernel} "
          f"on the span kernel) over {rounds} rounds, "
          f"{fd.launch_count(kv_quant)} decode kernel launches")
    # against the non-spec run's streams of the same requests
    same, gaps = divergence_gaps(torch, server.engine.model, reqs,
                                 base["streams"][:requests])
    out = {"draft": draft, "kv_quant": kv_quant, "requests": requests,
           "spec_rounds": rounds, "span_launches": span,
           "span_kernel_launches": span_kernel,
           "draft_decode_launches": draft_launches,
           "accept_rate": summary["accept_rate"],
           "decode_tokens_per_s_per_chip":
               summary["decode_tokens_per_s_per_chip"],
           "nonspec_tokens_per_s_per_chip":
               base["decode_tokens_per_s_per_chip"],
           "nonspec_requests": len(base["streams"]),
           "identical_streams": same / requests,
           "first_divergence_gaps": gaps, "wall_s": summary["wall_s"]}
    print(f"# spec serve: {json.dumps(out)}", flush=True)
    check_near_ties(gaps, f"spec {draft}/{kv_quant}")
    del server
    torch.cuda.empty_cache()
    return out


def divergence_gaps(torch, model, reqs, refs) -> tuple:
    """(identical streams, one record a diverging stream): the position of
    its first divergence from ``refs`` and the top-2 gap of ``model``'s
    next-token logits there, from a dense forward over the prompt and the
    common prefix."""
    same, gaps = 0, []
    for r, ref in zip(reqs, refs):
        if r.tokens == ref:
            same += 1
            continue
        i = next(i for i, (a, b) in enumerate(zip(r.tokens, ref)) if a != b)
        ids = torch.tensor(list(r.prompt) + ref[:i], device="cuda")
        with torch.inference_mode():
            logits = model(ids[None])[0, -1].float()
        top = logits.topk(2).values
        gaps.append({"request": r.id, "position": i,
                     "gap": float(top[0] - top[1]),
                     "max_abs_logit": float(logits.abs().max())})
    return same, gaps


def check_near_ties(gaps, what: str) -> None:
    """Streams may part only at a near-tie: the top-2 gap at a first
    divergence is at most 2% of that position's largest |logit| (the bar
    stated before the first run)."""
    bad = [d for d in gaps if d["gap"] > 0.02 * d["max_abs_logit"]]
    check(not bad, f"{what}: streams diverge from the non-spec run where "
          f"the top-2 gap is not a near-tie: {bad}")


def spec_identity_f32(torch, fd, run) -> dict:
    """At f32 compute, 32 requests of 256 prompt tokens and 64 new ones:
    over an fp (f32) pool with the ngram draft the greedy spec streams
    equal the non-spec streams token for token. Over an int8 pool (the
    model draft) they need not: a verify writes all K+1 links' rows
    before it attends, and rescale-on-grow then quantizes a page under
    the largest row of the whole span (rejected links included), where
    the non-spec path saw the rows one at a time; so the pool's int8
    values differ between the paths (the JAX writers behave the same).
    There the share of identical streams is printed and every first
    divergence must be a near-tie (``check_near_ties``)."""
    import numpy as np
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.run.sample import load_run
    from distributed_pipeline_tpu_torch.serving.scheduler import \
        DecodeServer

    bf, _, _ = load_run(run, device=torch.device("cuda"))
    m32 = create_model_from_config(**{**GPT2_BASE, "dtype": "float32"},
                                   device="cuda")
    m32.load_state_dict(bf.state_dict())
    del bf
    rng = np.random.default_rng(11)
    prompts = [rng.integers(4, GPT2_BASE["vocab_size"], (256,))
               .astype(np.int32) for _ in range(32)]
    out = {}
    for kv_quant, draft in (("fp", "ngram"), ("int8", "model")):
        streams = {}
        for spec in (0, 4):
            srv = DecodeServer(m32, decode_slots=32, page_size=16,
                               max_prompt_len=512, kv_quant=kv_quant,
                               spec_tokens=spec, spec_draft=draft,
                               draft_layers=2, device="cuda")
            fd.reset_launch_count()
            reqs = [srv.submit(p, max_new_tokens=64) for p in prompts]
            srv.drain()
            streams[spec] = reqs
            if spec:
                # f32 verifies take the decode kernel over pseudo-slots
                check(fd.span_launch_count() == 12 * srv.spec_rounds > 0
                      and fd.span_kernel_launch_count() == 0,
                      f"f32 spec run: {fd.span_launch_count()} span "
                      f"launches over {srv.spec_rounds} rounds, "
                      f"{fd.span_kernel_launch_count()} of them on the "
                      f"span kernel")
                out[f"{kv_quant}_{draft}_accept_rate"] = srv.accept_rate
            del srv
        same, gaps = divergence_gaps(torch, m32, streams[4],
                                     [r.tokens for r in streams[0]])
        out[f"{kv_quant}_{draft}_identical"] = same / len(prompts)
        out[f"{kv_quant}_{draft}_first_divergence_gaps"] = gaps
        if kv_quant == "fp":
            check(same == len(prompts), f"f32 fp pool, {draft} draft: "
                  f"{len(prompts) - same} spec streams differ from "
                  f"non-spec: {gaps}")
        check_near_ties(gaps, f"f32 {kv_quant} pool, {draft} draft")
    print(f"# spec identity at f32 compute: {json.dumps(out)}", flush=True)
    del m32
    torch.cuda.empty_cache()
    return out


def small_model_phase(torch) -> None:
    """Greedy tokens of a small f32 GPT-2 on the GPU (kernel) equal those
    on the CPU (plain version)."""
    from distributed_pipeline_tpu_torch.convert import init_params
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.ops import flash_decode as fd
    from distributed_pipeline_tpu_torch.serving.scheduler import DecodeServer

    cfg = dict(vocab_size=256, seq_len=64, hidden_size=128, num_layers=2,
               num_heads=2)
    sd = init_params(cfg, seed=3)
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(4, 256, (int(k),), generator=rng).numpy()
               for k in (3, 17, 9, 30, 1, 12)]
    outs = {}
    for device in ("cuda", "cpu"):
        model = create_model_from_config(model_family="gpt2", dtype="float32",
                                         device=device, **cfg)
        model.load_state_dict(sd)
        srv = DecodeServer(model, decode_slots=2, page_size=16,
                           max_prompt_len=32, decode_span=3, device=device)
        before = fd.launch_count()
        reqs = [srv.submit(p, max_new_tokens=10 + i)
                for i, p in enumerate(prompts)]
        srv.drain()
        outs[device] = [r.tokens for r in reqs]
        if device == "cuda":
            check(fd.launch_count() > before, "small model never launched "
                  "the kernel")
    check(outs["cuda"] == outs["cpu"],
          "small-model greedy tokens differ between GPU kernel and CPU")
    print("# small-model check: GPU (kernel) tokens == CPU (plain) tokens",
          flush=True)


def serve_phase(torch, fd, bw, bf16_peak) -> tuple:
    """GPT-2 base at full width through run.serve, once over an fp (bf16)
    KV pool and once with ``--kv_quant int8``; the int8 pool must hold at
    most 0.55x the fp pool's bytes. Then the speculative runs on the same
    weights (``spec_run``, ``spec_identity_f32``). Returns the non-spec
    and the spec results."""
    from distributed_pipeline_tpu_torch.convert import init_params
    from distributed_pipeline_tpu_torch.utils.checkpoint import save_run

    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "gpt2_base")
        t0 = time.perf_counter()
        save_run(run, GPT2_BASE, init_params(GPT2_BASE, seed=0), step=1)
        print(f"# serve: wrote seeded GPT-2 base weights in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        runs = {kv: clocked(f"serve {kv}", serve_run, torch, fd, run, kv,
                            bw, bf16_peak) for kv in ("fp", "int8")}
        spec = {"ngram_fp": clocked("spec serve ngram fp", spec_run, torch,
                                    fd, run, "ngram", "fp", 64, runs["fp"]),
                "model_int8": clocked("spec serve model int8", spec_run,
                                      torch, fd, run, "model", "int8", 16,
                                      runs["int8"]),
                "identity_f32": spec_identity_f32(torch, fd, run)}
    for r in runs.values():
        del r["streams"]
    ratio = runs["int8"]["kv_pool_bytes"] / runs["fp"]["kv_pool_bytes"]
    print(f"# serve: int8 KV pool {runs['int8']['kv_pool_bytes']} bytes, "
          f"{ratio:.4f} of the fp pool's {runs['fp']['kv_pool_bytes']}",
          flush=True)
    check(ratio <= 0.55, f"the int8 KV pool is {ratio:.4f} of the fp pool "
          f"(at most 0.55)")
    return runs, spec


def serve_run(torch, fd, run, kv_quant: str, bw, bf16_peak) -> dict:
    """One run.serve pass (which prints its JSON summary) over a KV pool of
    ``kv_quant`` pages: the kernel's launches over that page type, every
    request's tokens, one decode step from a live state through the kernel
    and through the plain version, and the kernel's time and bound at that
    state's depths."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.run.serve import serve

    new_tokens = 128
    settings = parse_settings([
        "--checkpoint_path", run, "--decode_slots", "32",
        "--page_size", "16", "--max_prompt_len", "512",
        "--synthetic_requests", "64", "--synthetic_prompt_len", "256",
        "--max_new_tokens", str(new_tokens), "--temperature", "0",
        "--decode_impl", "auto", "--kv_quant", kv_quant])
    fd.reset_launch_count()
    summary, server, reqs = serve(settings)
    other = "fp" if kv_quant == "int8" else "int8"
    launches = fd.launch_count(kv_quant)

    eng = server.engine
    streams = [list(r.tokens) for r in reqs]
    check(len(reqs) == 64, f"{len(reqs)} requests served")
    for r in reqs:
        check(len(r.tokens) == new_tokens
              and all(0 <= t < GPT2_BASE["vocab_size"] for t in r.tokens),
              f"request {r.id} returned {len(r.tokens)} tokens")
    want = GPT2_BASE["num_layers"] * eng.decode_span * server.decode_steps
    check(launches == want == summary["decode_kernel_launches"]
          and fd.launch_count(other) == 0,
          f"{kv_quant} kernel launches {launches} ({other}: "
          f"{fd.launch_count(other)}), expected {want}")
    check(all(t.is_cuda for entry in eng.kv_cache for t in entry),
          "the KV pool is not on the GPU")
    check(summary["kv_quant"] == kv_quant
          and eng.kv_cache[0][0].dtype == (torch.int8 if kv_quant == "int8"
                                           else torch.bfloat16),
          f"the {kv_quant} run's pool is {eng.kv_cache[0][0].dtype}")

    # one decode step from a live state, kernel vs plain version
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    prompts = [r.prompt for r in reqs[:32]]
    for p in prompts:
        server.submit(p, max_new_tokens=8)
    server.step()
    server.step()
    saved = [tuple(t.clone() for t in entry) for entry in eng.kv_cache]
    logits = one_step(torch, eng, eng.model, saved, kv_quant)
    if kv_quant == "int8":
        # An int8 pool holds the same values for any compute dtype. In
        # bf16 the plain version rounds the dequantized K/V to bf16 where
        # the kernel (like the JAX kernel) keeps them in f32, so near-tied
        # slots may pick differently; that comparison is printed with the
        # flipped slots' top-2 gaps, and the check runs at f32 compute,
        # where both arms read the same K/V values.
        report_step(torch, logits, "int8 pool, bf16 compute")
        from distributed_pipeline_tpu_torch.models import \
            create_model_from_config
        m32 = create_model_from_config(**{**GPT2_BASE, "dtype": "float32"},
                                       device="cuda")
        m32.load_state_dict(eng.model.state_dict())
        logits = one_step(torch, eng, m32, saved, kv_quant)
        del m32

    # the kernel alone at this live state's depths (layer 0's pool, a fresh
    # bf16 q), beside its bound on the same inputs
    pool = eng.kv_cache[0]
    H = GPT2_BASE["num_heads"]
    q = torch.randn((eng.decode_slots, H, pool[0].shape[-1]), device="cuda",
                    dtype=torch.bfloat16)
    table, positions = eng.block_table, eng.positions
    depth_ms, depth_split = device_ms(
        lambda: fd.flash_decode(q, pool[0], pool[1], table, positions,
                                *pool[2:]), torch, flush, clean_l2=True)
    depth = {"serve_depth_ms": depth_ms,
             "serve_depth_kernels_ms": depth_split}
    depth.update({f"serve_depth_{key}": val for key, val in kernel_bound(
        fd, table, positions, pool[0].shape[1], H, pool[0].shape[-1], bw,
        bf16_peak, quantized=kv_quant == "int8").items()})
    pos = positions.cpu()
    print(f"# serve {kv_quant}: kernel at the live state (depths "
          f"{int(pos.min())}-{int(pos.max())}): {depth}", flush=True)
    server.drain()
    pool_bytes = eng.kv_pool_bytes()
    check(pool_bytes == summary["kv_pool_bytes"],
          f"kv_pool_bytes {pool_bytes} vs the summary's "
          f"{summary['kv_pool_bytes']}")

    report_step(torch, logits, f"{kv_quant} pool, "
                f"{'f32' if kv_quant == 'int8' else 'bf16'} compute",
                strict=True)
    del server, eng, saved, pool
    torch.cuda.empty_cache()
    return {"launches": launches, "kv_pool_bytes": pool_bytes,
            "streams": streams,
            "decode_tokens_per_s_per_chip":
                summary["decode_tokens_per_s_per_chip"],
            "ttft_p50_s": summary["ttft_p50_s"],
            "ttft_p95_s": summary["ttft_p95_s"], **depth}


def one_step(torch, eng, model, saved, kv_quant: str) -> dict:
    """The logits of one decode step of ``model`` from the engine's live
    state, through the kernel and through the plain version, each from the
    same saved pool."""
    logits = {}
    with torch.inference_mode():
        for impl in ("cuda", "torch"):
            for entry, entry0 in zip(eng.kv_cache, saved):
                for t, t0 in zip(entry, entry0):
                    t.copy_(t0)
            logits[impl] = model(
                eng.tokens[:, None], None, cache_index=eng.positions,
                block_table=eng.block_table, kv_cache=eng.kv_cache,
                decode_impl=impl, kv_quant=kv_quant)[:, 0].float()
    return logits


def report_step(torch, logits, what: str, strict: bool = False) -> None:
    """Kernel-path logits against the plain version's: finite, within 5% of
    the logit scale (through 12 layers the plain version rounds logits and
    probabilities to the compute dtype in every layer, the kernel keeps
    f32), and, when ``strict``, the same next token in every slot. Prints
    the top-2 gap of the plain logits in any slot whose pick differs."""
    a, b = logits["cuda"], logits["torch"]
    check(bool(torch.isfinite(a).all()), "kernel-path logits not finite")
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    differ = (a.argmax(-1) != b.argmax(-1)).nonzero().flatten().tolist()
    agree = 1.0 - len(differ) / a.shape[0]
    top2 = b.topk(2, dim=-1).values
    gaps = {s: float(top2[s, 0] - top2[s, 1]) for s in differ}
    print(f"# serve: one decode step ({what}), kernel vs plain: max |logit| "
          f"{scale}, max abs diff {diff}, argmax agreement {agree}"
          + (f"; slots that differ and their top-2 gaps {gaps}"
             if differ else ""), flush=True)
    check(diff <= 0.05 * scale, f"decode logits differ by {diff} "
          f"(scale {scale})")
    if strict:
        check(agree == 1.0, f"kernel and plain version pick different next "
              f"tokens for {1 - agree:.4f} of the slots")


def close_enough(got, ref, rtol: float, atol: float) -> float:
    """Max abs error; raises unless |got - ref| <= atol + rtol |ref|."""
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    check(not bool(bad.any()), f"{int(bad.sum())} of {bad.numel()} "
          f"entries off (max abs err {float(err.max())}, rtol {rtol}, "
          f"atol {atol})")
    return float(err.max())


def bound(hbm_bytes: float, flops: float, bw: float, peak: float) -> dict:
    bytes_ms, ops_ms = hbm_bytes / bw * 1e3, flops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "hbm_bytes": hbm_bytes, "flops": flops}


def flash_check(torch, fa, B, H, L, Dh, dtype, causal, lens, seed,
                long_rows: bool = False):
    """Kernel forward and backward vs the plain versions on one case; bf16
    against the plain version in f32 from the same bf16 inputs. Returns
    the max abs errors, and for bf16 the max difference between two
    backward calls on the same inputs, which must be bitwise equal (dq's
    parts are summed in a fixed order).
    ``long_rows`` (bf16, every row hundreds of live keys) holds ``out`` to
    its rounding bound instead (``long_rows_out``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn((B, H, L, Dh), generator=g, device=dev)
                     .to(dtype) for _ in range(4))
    mask = (torch.arange(L, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
    out, lse = fa.flash_forward(q, k, v, mask, causal)
    dq, dk, dv = fa.flash_backward(q, k, v, mask, causal, out, lse, dout)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = fa.torch_flash_forward(*f, mask, causal)
    # the backward's reference takes the kernel's own (rounded) out and lse
    refs = fa.torch_flash_backward(*f, mask, causal, out.float(), lse,
                                   dout.float())
    if dtype == torch.float32:
        tol = dict(rtol=1e-4, atol=1e-5)   # another summation order
        tol_b = dict(rtol=1e-4, atol=1e-4)
    else:
        # one bf16 rounding of an f32 result (2^-8 relative), p rounded to
        # bf16 before p.v (as the JAX kernel's p.astype(v.dtype)), plus f32
        # cancellation in the sums: atol 1e-3 of the largest entry
        tol = dict(rtol=8e-3, atol=1e-3 * float(ref_out.abs().max()))
        tol_b = None
    if long_rows:
        errs = long_rows_out(torch, fa, q, k, v, mask, causal, out, ref_out,
                             ref_lse)
    else:
        errs = {"out": close_enough(out, ref_out, **tol)}
    errs["lse"] = close_enough(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        # bf16: p and ds enter their products as bf16 (2^-9 relative each)
        # and dq's parts are summed in f32 in another order. A row with
        # few live keys has ds = p (dp - delta), a difference of nearly
        # equal terms, so those roundings are large against that row's own
        # gradient: entrywise atol 1e-2 of the largest entry (at least
        # 1e-4, for gradients that are zero in exact arithmetic), and the
        # whole tensor within 1e-2 in relative Frobenius norm
        if tol_b is None:
            ref = ref.float()
            rel = float((got.float() - ref).norm() / ref.norm().clamp_min(
                1e-30))
            check(rel <= 1e-2 or float(ref.norm()) < 1e-3,
                  f"{name}: relative Frobenius error {rel}")
            errs[name + "_rel_fro"] = rel
        t = tol_b or dict(rtol=1e-2,
                          atol=max(1e-2 * float(ref.abs().max()), 1e-4))
        errs[name] = close_enough(got, ref, **t)
    dead = [b for b, n in enumerate(lens) if n == 0]
    for b in dead:   # fully masked rows: zero output, zero gradients
        check(bool(torch.all(out[b] == 0)) and bool(torch.all(dq[b] == 0))
              and bool(torch.all(dk[b] == 0))
              and bool(torch.all(dv[b] == 0)), "masked rows not zero")
    if dtype == torch.bfloat16:
        again = fa.flash_backward(q, k, v, mask, causal, out, lse, dout)
        errs["rerun_max_diff"] = max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(again, (dq, dk, dv)))
        check(all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))),
              f"two bf16 backward calls on the same inputs differ by "
              f"{errs['rerun_max_diff']}")
        # the key tiles split over several launches (a small dq scratch
        # cap): the same sums in the same order, so the same bits
        cap = fa.DQ_SCRATCH_CAP
        fa.DQ_SCRATCH_CAP = max(1, B * H * L * Dh * 4 * 2)
        try:
            errs["dq_launches_split"] = fa.dq_launch_plan(B, H, L, Dh)[2]
            split = fa.flash_backward(q, k, v, mask, causal, out, lse, dout)
        finally:
            fa.DQ_SCRATCH_CAP = cap
        check(all(torch.equal(a, b) for a, b in zip(split, (dq, dk, dv))),
              f"the backward split over {errs['dq_launches_split']} "
              f"launches differs from one launch")
    return errs


def long_rows_out(torch, fa, q, k, v, mask, causal, out, ref_out,
                  ref_lse) -> dict:
    """The bf16 forward's ``out`` where every row attends to hundreds of
    keys. Each p is rounded to bf16 (2^-9 relative) before p.v and ``out``
    once more, so |out - ref| <= 2^-9 (p.|v|) + 2^-9 |ref| in exact
    arithmetic: held entrywise at twice that, and in relative Frobenius
    norm within 1e-2. A bar of 1e-3 of the largest entry (the short and
    causal cases') is not met here by the plain version itself in bf16:
    the p-rounding error of an entry scales with p.|v|, which stays near
    E|v| while the entry itself averages towards 0 over long rows; both
    are printed. The plain version with the pad mask dropped must fall
    outside the bars."""
    f = [t.float() for t in (q, k, v)]
    live = mask.bool()[:, None, None, :]
    if causal:
        L = q.shape[-2]
        live = live & torch.ones((L, L), dtype=torch.bool,
                                 device=q.device).tril()
    s = torch.einsum("bhld,bhmd->bhlm", f[0], f[1]) * q.shape[-1] ** -0.5
    p = torch.where(live, torch.exp(s - ref_lse[..., None]), 0.0)
    del s
    bound = 2.0 ** -8 * (p @ f[2].abs() + ref_out.abs())
    del p
    ref = ref_out.float()

    def judge(got) -> dict:
        err = (got.float() - ref).abs()
        return {"max_abs_err": float(err.max()),
                "max_err_over_bound": float((err / bound).max()),
                "rel_fro": float((got.float() - ref).norm() / ref.norm()),
                "outside_global_max_bar": int((err > 1e-3 * float(
                    ref.abs().max()) + 8e-3 * ref.abs()).sum())}

    kernel = judge(out)
    plain = judge(fa.torch_flash_forward(q, k, v, mask, causal)[0])
    wrong = judge(fa.torch_flash_forward(*f, None, causal)[0])
    print(f"# flash check, long rows: kernel {kernel}; the plain version "
          f"in bf16 {plain}; the plain version without the pad mask "
          f"{wrong}", flush=True)
    check(kernel["max_err_over_bound"] <= 1.0 and kernel["rel_fro"] <= 1e-2,
          f"long rows: out outside its rounding bound: {kernel}")
    check(wrong["max_err_over_bound"] > 1.0 and wrong["rel_fro"] > 1e-2,
          f"long rows: the bars cannot tell a dropped pad mask: {wrong}")
    return {"out": kernel["max_abs_err"], "out_rel_fro": kernel["rel_fro"],
            "out_err_over_bound": kernel["max_err_over_bound"],
            "plain_bf16_out_err_over_bound": plain["max_err_over_bound"],
            "out_outside_global_max_bar": kernel["outside_global_max_bar"],
            "plain_bf16_outside_global_max_bar":
                plain["outside_global_max_bar"]}


def build_report(log_path: str) -> list:
    """Registers, shared memory and spills of every kernel in the build
    log's ``-Xptxas -v`` report."""
    import re
    rows, name = [], None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and name:
                rows.append({"kernel": name, "spill_stores": int(m.group(1)),
                             "spill_loads": int(m.group(2))})
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and rows and rows[-1]["kernel"] == name:
                smem = re.search(r"(\d+) bytes smem", line)
                rows[-1].update(registers=int(m.group(1)),
                                smem_bytes=int(smem.group(1)) if smem else 0)
    return rows


def flash_phase(torch, bw, bf16_peak) -> list:
    """The flash kernels vs their plain versions on every case, and their
    times at the training shape beside the library calls, in turns."""
    from distributed_pipeline_tpu_torch.ops import flash_attention as fa

    B, H, L, Dh = 4, 12, 1024, 64
    bf16 = torch.bfloat16
    cases = {
        "train_bf16": (B, H, L, Dh, bf16, True, [L] * B),
        "ragged_bf16": (B, H, 1000, Dh, bf16, True, [1000, 733, 1, 0]),
        "f32_dh64": (2, 3, 200, 64, torch.float32, True, [200, 77]),
        "f32_dh128_noncausal": (2, 3, 130, 128, torch.float32, False,
                                [130, 0]),
        "dh128_bf16": (2, 4, 1024, 128, bf16, True, [1024, 1024]),
        "l1_bf16": (2, 4, 1, Dh, bf16, True, [1, 1]),
        "l65_bf16": (2, 4, 65, Dh, bf16, True, [65, 30]),
        "l129_bf16": (2, 4, 129, 128, bf16, True, [129, 129]),
        "noncausal_dead_bf16": (2, 4, 200, Dh, bf16, False, [200, 0]),
    }
    # the DiffuSeq seq-1024 step's two microbatches: bidirectional, with the
    # pad mask live inside every row (diffuseq_long_step drives this path)
    lens = long_batch()["pad_mask"].sum(1).tolist()
    for mb in range(2):
        cases[f"diffuseq_seq1024_mb{mb}_bf16"] = (
            B, H, L, Dh, bf16, False, lens[4 * mb:4 * mb + 4])
    errs = {name: flash_check(torch, fa, *c, seed=i,
                              long_rows=name.startswith("diffuseq"))
            for i, (name, c) in enumerate(cases.items())}
    print(f"# flash check: max abs err {json.dumps(errs)}", flush=True)
    split = {n: e["dq_launches_split"] for n, e in errs.items()
             if "dq_launches_split" in e}
    print(f"# flash determinism: two bf16 backward calls on the same inputs "
          f"bitwise equal in all {len(split)} bf16 cases, and equal to the "
          f"backward split over several launches {split}", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, dout = (torch.randn((B, H, L, Dh), generator=g, device=dev)
                     .to(bf16) for _ in range(4))
    mask = torch.ones((B, L), dtype=torch.int32, device=dev)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    out, lse = fa.flash_forward(q, k, v, mask, True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(ql, kl, vl, is_causal=True)
    fns = {
        "fwd": lambda: fa.flash_forward(q, k, v, mask, True),
        "fwd_lib": lambda: sdpa(q, k, v, is_causal=True),
        "bwd": lambda: fa.flash_backward(q, k, v, mask, True, out, lse,
                                         dout),
        "bwd_lib": lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dout, retain_graph=True),
    }
    runs = {name: [] for name in fns}      # device ms, one per turn
    event = {name: [] for name in fns}     # CUDA-event ms, host included
    split = {}
    for order in (("fwd_lib", "fwd", "bwd_lib", "bwd"),
                  ("fwd", "fwd_lib", "bwd", "bwd_lib")):
        for name in order:
            total, split[name] = device_ms(fns[name], torch, flush)
            runs[name].append(total)
            event[name].append(time_ms(fns[name], torch, flush))
    ms = {name: statistics.median(t) for name, t in runs.items()}
    fwd_plain = time_ms(lambda: fa.torch_flash_forward(q, k, v, mask, True),
                        torch, flush, reps=20)
    bwd_plain = time_ms(lambda: fa.torch_flash_backward(
        q, k, v, mask, True, out, lse, dout), torch, flush, reps=20)
    src = "distributed_pipeline_tpu_torch/ops/csrc/flash_attention.cu"
    main = errs["train_bf16"]
    rows = [
        {"name": "flash_forward", "route": "cuda", "source": src,
         "replaces": "distributed_pipeline_tpu/ops/flash_attention.py:185",
         "launches": None,
         "max_abs_err": max(main["out"], main["lse"]),
         "ms": ms["fwd"], "ms_runs": runs["fwd"], "event_ms": event["fwd"],
         "kernels_ms": split["fwd"], "plain_ms": fwd_plain,
         **bound(fa.flash_hbm_bytes(B, H, L, Dh, 2, True),
                 fa.flash_flops(B, H, L, Dh, True), bw, bf16_peak),
         "library_ms": ms["fwd_lib"], "library_ms_runs": runs["fwd_lib"],
         "library_event_ms": event["fwd_lib"],
         "library_kernels_ms": split["fwd_lib"],
         "library_call": "scaled_dot_product_attention(is_causal=True)"},
        {"name": "flash_backward", "route": "cuda", "source": src,
         "replaces": "distributed_pipeline_tpu/ops/flash_attention.py:240",
         "launches": None,
         "max_abs_err": max(main["dq"], main["dk"], main["dv"]),
         "rerun_max_diff": main["rerun_max_diff"],
         "ms": ms["bwd"], "ms_runs": runs["bwd"], "event_ms": event["bwd"],
         "kernels_ms": split["bwd"], "plain_ms": bwd_plain,
         **bound(fa.flash_hbm_bytes(B, H, L, Dh, 2, True, backward=True),
                 fa.flash_flops(B, H, L, Dh, True, backward=True), bw,
                 bf16_peak),
         "library_ms": ms["bwd_lib"], "library_ms_runs": runs["bwd_lib"],
         "library_event_ms": event["bwd_lib"],
         "library_kernels_ms": split["bwd_lib"],
         "library_call": "autograd backward of scaled_dot_product_attention"
                         "(is_causal=True)"},
    ]
    for row in rows:
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["x_library"] = row["ms"] / row["library_ms"]
        print(f"# flash timing: {row['name']} {row['ms']:.5f} ms "
              f"({row['tflops']:.1f} TFLOP/s, {row['share_of_bound']:.3f} of "
              f"the bound {row['bound_ms']:.6f} ms, {row['x_library']:.2f}x "
              f"the library's {row['library_ms']:.5f} ms; device time; "
              f"CUDA events, host enqueue included: {row['event_ms']} vs "
              f"{row['library_event_ms']})", flush=True)
    return rows


def param_shapes(cfg: dict) -> list:
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    model = create_model_from_config(**cfg, device="meta")
    return [tuple(p.shape) for p in model.parameters()]


def update_phase(torch, bw, f32_peak, cfg: dict,
                 name: str = "fused_adamw_ema") -> dict:
    """The fused update vs its plain version, bitwise over 3 steps, at the
    parameter count of the model ``cfg`` with 3 EMA rates; its time beside
    its bound."""
    from distributed_pipeline_tpu_torch.ops import fused_update as fu

    dev = torch.device("cuda")
    shapes = param_shapes(cfg)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    n, rates = sum(sizes), [0.5, 0.9, 0.99]
    g = torch.Generator(device=dev).manual_seed(11)
    base = [torch.randn(n, generator=g, device=dev) * 0.02 for _ in range(4)]
    base[3] = base[3] * base[3]                      # nu >= 0
    ema0 = torch.randn((3, n), generator=g, device=dev) * 0.02
    arms = {name: [t.clone() for t in base] + [ema0.clone()]
            for name in ("kernel", "plain")}
    count = torch.zeros((), dtype=torch.int32, device=dev)

    def lr_fn(c):
        return torch.tensor(3e-4, device=dev) * torch.clamp(
            1.0 - c.float() / 20, min=0.0)

    for _ in range(3):
        scal = fu.update_scalars(count, lr_fn)
        fu.fused_adamw_ema(*arms["kernel"], scal, rates, weight_decay=0.01)
        fu.torch_fused_update(*arms["plain"], scal, rates, weight_decay=0.01)
        count += 1
    torch.cuda.synchronize()
    for a, b in zip(arms["kernel"], arms["plain"]):
        check(torch.equal(a, b), "fused update differs from its plain "
              "version (must be bitwise)")
    print(f"# update check ({cfg['model_family']}): {n} elements x 3 steps, "
          f"kernel == plain bitwise", flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    scal = fu.update_scalars(count, lr_fn)
    st = arms["kernel"]
    ms = time_ms(lambda: fu.fused_adamw_ema(*st, scal, rates,
                                            weight_decay=0.01), torch, flush)
    plain_ms = time_ms(lambda: fu.torch_fused_update(
        *st, scal, rates, weight_decay=0.01), torch, flush, reps=20)
    leaves = [torch.zeros(s, device=dev, requires_grad=True) for s in shapes]
    for p in leaves:
        p.grad = torch.randn(p.shape, generator=g, device=dev) * 0.02
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.01, fused=True)
    library_ms = time_ms(opt.step, torch, flush)
    del arms, base, ema0, leaves, opt
    return {"name": name, "route": "cuda",
            "source": "distributed_pipeline_tpu_torch/ops/csrc/"
                      "fused_update.cu",
            "replaces": "distributed_pipeline_tpu/ops/fused_update.py:90",
            "launches": None, "max_abs_err": 0.0, "elements": n,
            "ms": ms, "plain_ms": plain_ms,
            # 16 f32 operations per element for the Adam tail, 3 per EMA
            **bound(fu.update_hbm_bytes([n], 3, per_leaf_scalars=False),
                    25.0 * n, bw, f32_peak),
            "library_ms": library_ms,
            "library_call": "torch.optim.AdamW(fused=True).step() over the "
                            "same leaves (yardstick only: another op order, "
                            "no EMA)"}


def train_phase(torch, fa, fu) -> dict:
    """GPT-2 base, seq 1024, 20 steps through run.train; then the run dir
    served, and one step from the saved state through the kernels and
    through the plain versions."""
    from distributed_pipeline_tpu_torch.run import serve as serve_mod
    from distributed_pipeline_tpu_torch.run.train import main as train_main

    steps, layers, n_micro = 20, GPT2_BASE["num_layers"], 2
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "gpt2_base_train")
        argv = ["--checkpoint_path", run, "--model_family", "gpt2",
                "--model_size", "base", "--vocab_size", "50257",
                "--seq_len", "1024", "--hidden_size", "768",
                "--num_layers", "12", "--num_heads", "12",
                "--dtype", "bfloat16", "--dataset", "synthetic-lm",
                "--batch_size", "8", "--microbatch", "4",
                "--learning_steps", str(steps), "--lr", "3e-4",
                "--ema_rate", "0.5,0.9,0.99", "--attention_impl", "auto",
                "--fused_update", "auto", "--log_interval", "5",
                "--save_interval", "0", "--seed", "0"]
        fa.reset_launch_counts()
        fu.reset_launch_count()
        t0 = time.perf_counter()
        loop = train_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_forward": fa.forward_launch_count(),
                    "flash_backward": fa.backward_launch_count(),
                    "fused_adamw_ema": fu.launch_count()}
        want = layers * n_micro * steps
        check(launches["flash_forward"] == want
              and launches["flash_backward"] == want,
              f"flash launches {launches}, expected {want} each")
        check(launches["fused_adamw_ema"] == steps,
              f"update launches {launches['fused_adamw_ema']}, expected "
              f"{steps} (one a step)")
        losses = [h["loss"] for h in loop.history]
        check(len(losses) == steps and all(
            x == x and abs(x) < float("inf") for x in losses),
            f"losses not finite: {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        with open(os.path.join(run, "progress.csv")) as f:
            rows = f.read().splitlines()
        last = dict(zip(rows[0].split(","), rows[-1].split(",")))
        gauges = {k: float(last[k]) for k in
                  ("tokens_per_sec_per_chip", "mfu", "step_time_s")}
        print(f"# train: {steps} steps in {wall:.1f} s, losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches}, "
              f"last window {gauges}", flush=True)
        for name in ("model_000020.pt", "opt_000020.pt", "meta_000020.json",
                     "ema_0.5_000020.pt", "ema_0.9_000020.pt",
                     "ema_0.99_000020.pt"):
            check(os.path.exists(os.path.join(run, name)), f"no {name}")
        del loop
        torch.cuda.empty_cache()

        summary = serve_mod.main([
            "--checkpoint_path", run, "--decode_slots", "4",
            "--max_prompt_len", "128", "--synthetic_requests", "4",
            "--max_new_tokens", "16"])
        check(summary["requests"] == 4 and summary["decode_tokens"] == 64
              and summary["step"] == steps,
              f"serving the trained run dir: {summary}")
        torch.cuda.empty_cache()
        twice = one_step_twice(torch, fa, fu, run, argv)
    return {"launches": launches, "losses": losses, "wall_s": wall,
            **gauges, **twice}


def one_step_twice(torch, fa, fu, run, argv) -> dict:
    """One step from the run dir's saved state with the kernels, and one
    with ``attention_impl torch`` and ``fused_update false``."""
    from distributed_pipeline_tpu_torch.config.train import parse_settings
    from distributed_pipeline_tpu_torch.data import load_data_from_args
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.utils.logger import Logger
    from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop

    args = parse_settings(argv)
    batch = next(load_data_from_args(
        "train", batch_size=8, dataset="synthetic-lm", seq_len=1024,
        vocab_size=50257, seed=0, skip_batches=20))
    out, grads = {}, {}
    # the saved parameters as the loops' initial ones (the resume loads
    # them again with the rest of the state): no random init per arm
    saved = torch.load(os.path.join(run, "model_000020.pt"),
                       map_location="cuda", weights_only=True)
    for arm, (attn, fused) in (("kernels", ("auto", "auto")),
                               ("kernels_again", ("auto", "auto")),
                               ("plain", ("torch", "false"))):
        model = create_model_from_config(**{**GPT2_BASE,
                                            "attention_impl": attn},
                                         device="cuda")
        loop = TrainLoop(
            model=model, data=None, batch_size=8, microbatch=4, lr=args.lr,
            ema_rate=args.ema_rate, learning_steps=args.learning_steps,
            checkpoint_dir=run, fused_update=fused, init_params=saved,
            logger=Logger(""))
        check(loop.step == 20, f"resumed at step {loop.step}, not 20")
        fa.reset_launch_counts()
        fu.reset_launch_count()
        m = loop.run_step(batch)
        out[arm] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
        grads[arm] = loop.grads.clone()
        n = (fa.forward_launch_count(), fa.backward_launch_count(),
             fu.launch_count())
        check(n == ((0, 0, 0) if arm == "plain" else (24, 24, 1)),
              f"{arm} arm launches {n}")
        del loop, model
        torch.cuda.empty_cache()
    a, b = out["kernels"], out["plain"]
    same = torch.equal(grads["kernels"], grads["kernels_again"])
    print(f"# train: one step from the saved state, kernels {a}, again "
          f"{out['kernels_again']} (every gradient bitwise equal: {same}), "
          f"plain {b}", flush=True)
    check(out["kernels_again"] == a and same,
          f"two kernel steps from one saved state differ: {a} vs "
          f"{out['kernels_again']}, gradients equal {same}")
    del grads
    # bf16 through 12 layers: both arms round p to bf16 before p.v; the
    # plain backward runs f32 einsums where the kernel feeds p and ds to
    # its products as bf16; allow 0.5% of the loss and 3% of the gradient
    # norm
    check(abs(a["loss"] - b["loss"]) <= 5e-3 * abs(b["loss"]),
          f"one-step loss differs: {a} vs {b}")
    check(abs(a["grad_norm"] - b["grad_norm"]) <= 3e-2 * b["grad_norm"],
          f"one-step grad norm differs: {a} vs {b}")
    return {"one_step": out}


def diffuseq_phase(torch, fa, fu) -> dict:
    """DiffuSeq-base through run.train with the JAX package's defaults, one
    step from its saved state with the fused update and with the plain
    one, one step at seq_len 1024 through the flash kernels and through
    their plain versions, and run.sample on the trained run dir."""
    from distributed_pipeline_tpu_torch.run import sample as sample_mod
    from distributed_pipeline_tpu_torch.run.train import main as train_main

    steps = 20
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "diffuseq_base_train")
        argv = ["--checkpoint_path", run, "--batch_size", "256",
                "--microbatch", "64", "--learning_steps", str(steps),
                "--ema_rate", "0.5,0.9,0.99", "--attention_impl", "auto",
                "--fused_update", "auto", "--log_interval", "5",
                "--save_interval", "0", "--seed", "0"]
        fa.reset_launch_counts()
        fu.reset_launch_count()
        t0 = time.perf_counter()
        loop = train_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_forward": fa.forward_launch_count(),
                    "flash_backward": fa.backward_launch_count(),
                    "fused_adamw_ema": fu.launch_count()}
        check(loop.model.family == "diffuseq"
              and loop.n_params == 91_039_872,
              f"trained {loop.model.family} with {loop.n_params} parameters")
        check(launches == {"flash_forward": 0, "flash_backward": 0,
                           "fused_adamw_ema": steps},
              f"launches {launches}: expected the update once a step and "
              f"no flash kernel (dense arm at seq_len 128)")
        losses = [h["loss"] for h in loop.history]
        check(len(losses) == steps and all(
            x == x and abs(x) < float("inf") for x in losses),
            f"losses not finite: {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        with open(os.path.join(run, "progress.csv")) as f:
            rows = f.read().splitlines()
        last = dict(zip(rows[0].split(","), rows[-1].split(",")))
        gauges = {k: float(last[k]) for k in
                  ("tokens_per_sec_per_chip", "mfu", "step_time_s")}
        print(f"# diffuseq train: {steps} steps in {wall:.1f} s, losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches}, "
              f"last window {gauges}", flush=True)
        for name in (f"model_{steps:06d}.pt", f"opt_{steps:06d}.pt",
                     f"meta_{steps:06d}.json", f"ema_0.5_{steps:06d}.pt",
                     f"ema_0.9_{steps:06d}.pt", f"ema_0.99_{steps:06d}.pt"):
            check(os.path.exists(os.path.join(run, name)), f"no {name}")
        del loop
        torch.cuda.empty_cache()
        update_step = diffuseq_update_step(torch, fu, run, steps)

        t0 = time.perf_counter()
        pred_path = os.path.join(tmp, "pred.jsonl")
        sampled = sample_mod.main(["--checkpoint_path", run,
                                   "--batch_size", "32", "--num_batches",
                                   "2", "--sample_steps", "20", "--mbr", "1",
                                   "--out", pred_path])
        sample_wall = time.perf_counter() - t0
        check(sampled["step"] == steps
              and 0.0 <= sampled["decode_acc"] <= 1.0
              and math.isfinite(sampled["eval_loss"]),
              f"run.sample on the trained run dir: {sampled}")
        check_predictions(pred_path, run, sampled["decode_acc"])
        print(f"# diffuseq sample: decode_acc {sampled['decode_acc']}, "
              f"eval_loss {sampled['eval_loss']}, {sample_wall:.2f} s",
              flush=True)
    long_ctx = diffuseq_long_step(torch, fa, fu)
    return {"launches": launches, "losses": losses, "wall_s": wall,
            **gauges, "update_step": update_step, "seq1024": long_ctx,
            "sample": {**sampled, "wall_s": sample_wall}}


def check_predictions(path: str, run: str, decode_acc: float) -> None:
    """run.sample's ``--out`` rows against the valid batches it decoded:
    the gold ids are those batches, the prediction keeps every id off the
    target span (the anchored source, the padding), its ids are in the
    vocabulary, and the target-span accuracy recomputed from the rows is
    the ``decode_acc`` it printed."""
    import numpy as np
    from distributed_pipeline_tpu_torch.data import load_data_from_args

    with open(os.path.join(run, "training_args.json")) as f:
        targs = json.load(f)
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    data = load_data_from_args("valid", **{
        **targs, "batch_size": 32, "deterministic": True,
        "num_loader_proc": 0, "data_loader_workers": 0})
    check(len(rows) == 64, f"run.sample wrote {len(rows)} rows, not 64")
    accs = []
    for b in range(2):
        batch = next(data)
        gold = np.array([r["gold"] for r in rows[32 * b:32 * b + 32]])
        pred = np.array([r["pred"] for r in rows[32 * b:32 * b + 32]])
        tgt = batch["input_mask"] * batch["pad_mask"]
        check(np.array_equal(gold, batch["input_ids"]),
              f"batch {b}: the written gold ids are not the valid batch")
        check(pred.shape == gold.shape and np.array_equal(
            pred[batch["input_mask"] == 0], gold[batch["input_mask"] == 0]),
            f"batch {b}: the prediction changed ids off the target span")
        check(int(pred.min()) >= 0 and int(pred.max()) < targs["vocab_size"],
              f"batch {b}: predicted ids outside the vocabulary")
        accs.append(float(((pred == gold) * tgt).sum() / max(tgt.sum(), 1)))
    check(abs(sum(accs) / 2 - decode_acc) <= 1e-6,
          f"decode_acc {decode_acc} is not the rows' {sum(accs) / 2}")


def diffuseq_update_step(torch, fu, run, steps: int) -> dict:
    """One step from the run dir's saved state with the fused update and
    one with its plain version (attention on the dense arm in both). The
    forward is the same computation, so the losses must agree to 1e-6; the
    embedding gradient is summed by atomics, so the grad norms are held to
    1e-4; the updated state must be bitwise equal where the gradients are
    (the update is bitwise its plain version)."""
    from distributed_pipeline_tpu_torch.data import load_data_from_args
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.utils.logger import Logger
    from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop

    batch = next(load_data_from_args("train", batch_size=256, seq_len=128,
                                     vocab_size=8192, seed=0,
                                     skip_batches=steps))
    out, state = {}, {}
    saved = torch.load(os.path.join(run, f"model_{steps:06d}.pt"),
                       map_location="cuda", weights_only=True)
    for arm, fused in (("kernel", "auto"), ("plain", "false")):
        loop = TrainLoop(
            model=create_model_from_config(**DIFFUSEQ_BASE, device="cuda"),
            data=None, batch_size=256, microbatch=64,
            ema_rate="0.5,0.9,0.99", learning_steps=steps + 1, seed=0,
            checkpoint_dir=run, fused_update=fused, init_params=saved,
            logger=Logger(""))
        check(loop.step == steps, f"resumed at step {loop.step}")
        fu.reset_launch_count()
        m = loop.run_step(batch)
        out[arm] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
        check(fu.launch_count() == (1 if arm == "kernel" else 0),
              f"{arm} arm: {fu.launch_count()} update launches")
        state[arm] = [t.clone() for t in (loop.grads, loop.params, loop.mu,
                                          loop.nu, loop.ema)]
        del loop
    a, b = out["kernel"], out["plain"]
    same_grads = torch.equal(state["kernel"][0], state["plain"][0])
    same_state = all(torch.equal(x, y) for x, y in zip(state["kernel"][1:],
                                                       state["plain"][1:]))
    del state
    torch.cuda.empty_cache()
    print(f"# diffuseq: one step from the saved state, fused update {a}, "
          f"plain {b}; gradients bitwise equal {same_grads}, updated state "
          f"bitwise equal {same_state}", flush=True)
    check(abs(a["loss"] - b["loss"]) <= 1e-6 * abs(b["loss"]),
          f"one-step loss differs: {a} vs {b}")
    check(abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * b["grad_norm"],
          f"one-step grad norm differs: {a} vs {b}")
    check(same_state or not same_grads,
          "equal gradients gave a different updated state")
    return {**out, "grads_bitwise_equal": same_grads,
            "state_bitwise_equal": same_state}


def long_batch() -> dict:
    """The DiffuSeq seq-1024 step's batch: 8 padded synthetic seq2seq rows,
    as numpy arrays."""
    from distributed_pipeline_tpu_torch.data import load_data_from_args
    return next(load_data_from_args("train", batch_size=8, seq_len=1024,
                                    vocab_size=8192, seed=0))


def attention_grads(loop) -> dict:
    """Each block's attention weight gradients (qkv, out) after a step."""
    return {name: g.detach().float().clone()
            for name, g in loop.state_dict_of(loop.grads).items()
            if ".attn." in name}


def worst_leaf(grads: dict, ref: dict) -> tuple:
    """(leaf, relative Frobenius error) of the leaf furthest from ``ref``."""
    errs = {n: float((grads[n] - ref[n]).norm() / ref[n].norm()) for n in ref}
    name = max(errs, key=errs.get)
    return name, errs[name]


def diffuseq_long_step(torch, fa, fu) -> dict:
    """DiffuSeq-base at seq_len 1024 (seeded random weights, padded rows):
    one step through ``auto`` (the flash kernels, bidirectional and
    pad-masked, and the fused update) and one through the plain versions,
    held to each other by the loss, the grad norm and every block's
    attention weight gradients. Two more plain steps, with the pad mask
    dropped from attention and with attention made causal, show what a
    kernel that got the mask wrong would give: the same bars must reject
    both."""
    from distributed_pipeline_tpu_torch.convert import init_params
    from distributed_pipeline_tpu_torch.models import \
        backbone, create_model_from_config
    from distributed_pipeline_tpu_torch.utils.logger import Logger
    from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop

    cfg = {**DIFFUSEQ_BASE, "seq_len": 1024}
    batch = long_batch()
    lens = batch["pad_mask"].sum(1).tolist()
    check(min(lens) < 1024, f"no padded row at seq_len 1024: {lens}")
    sd = init_params(cfg, seed=0)
    attend = backbone.dot_product_attention
    wrong = {
        "no_pad_mask": lambda q, k, v, pad_mask, causal, impl:
            attend(q, k, v, None, causal=causal, impl=impl),
        "causal": lambda q, k, v, pad_mask, causal, impl:
            attend(q, k, v, pad_mask, causal=True, impl=impl),
    }
    out, grads = {}, {}
    for arm, (attn, fused) in (("kernels", ("auto", "auto")),
                               ("plain", ("torch", "false")),
                               ("no_pad_mask", ("torch", "false")),
                               ("causal", ("torch", "false"))):
        loop = TrainLoop(
            model=create_model_from_config(**{**cfg, "attention_impl": attn},
                                           device="cuda"),
            data=None, batch_size=8, microbatch=4, lr=1e-4,
            ema_rate="0.5,0.9,0.99", learning_steps=20, seed=0,
            init_params=sd, checkpoint_dir="", fused_update=fused,
            logger=Logger(""))
        fa.reset_launch_counts()
        fu.reset_launch_count()
        backbone.dot_product_attention = wrong.get(arm, attend)
        try:
            m = loop.run_step(batch)
        finally:
            backbone.dot_product_attention = attend
        out[arm] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
        grads[arm] = attention_grads(loop)
        n = (fa.forward_launch_count(), fa.backward_launch_count(),
             fu.launch_count())
        out[arm]["launches"] = n
        check(n == ((24, 24, 1) if arm == "kernels" else (0, 0, 0)),
              f"seq_len 1024 {arm} arm launches {n}")
        del loop
        torch.cuda.empty_cache()
    b = out["plain"]
    # the bars of the GPT-2 step (train phase): bf16 through 12 layers.
    # Per attention leaf, 3% in relative Frobenius norm: the kernel's dq,
    # dk and dv are held to 1e-2 each (flash_check), and a weight gradient
    # sums them over 8,192 tokens and carries them through 12 layers
    failed = {}
    for arm in ("kernels", "no_pad_mask", "causal"):
        a = out[arm]
        leaf, err = worst_leaf(grads[arm], grads["plain"])
        a.update(worst_attention_leaf=leaf, worst_attention_rel_fro=err)
        failed[arm] = [what for what, bad in (
            ("loss", abs(a["loss"] - b["loss"]) > 5e-3 * abs(b["loss"])),
            ("grad_norm",
             abs(a["grad_norm"] - b["grad_norm"]) > 3e-2 * b["grad_norm"]),
            ("attention_grads", err > 3e-2)) if bad]
        a["bars_failed"] = failed[arm]
    del grads
    print(f"# diffuseq seq_len 1024 (row lengths {lens}): one step, kernels "
          f"{out['kernels']}, plain {b}; a wrong mask: pad mask dropped "
          f"{out['no_pad_mask']}, causal {out['causal']}", flush=True)
    check(not failed["kernels"],
          f"seq_len 1024 kernels against plain: {failed['kernels']} outside "
          f"the bars: {out}")
    for arm in ("no_pad_mask", "causal"):
        check(bool(failed[arm]),
              f"seq_len 1024: the bars cannot tell a {arm} attention from "
              f"the right one: {out[arm]} vs {b}")
    return {**out, "row_lengths": lens}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from distributed_pipeline_tpu_torch.ops import _build
    from distributed_pipeline_tpu_torch.ops import flash_attention as fa
    from distributed_pipeline_tpu_torch.ops import flash_decode as fd
    from distributed_pipeline_tpu_torch.ops import fused_update as fu
    from distributed_pipeline_tpu_torch.utils.perf import card_rates

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    bw, bf16_peak, f32_peak = card_rates(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = t0 = time.perf_counter()
    _build.load_library()
    print(f"# build: CUDA kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for row in build_report(_build.build_log_path()):
        print(f"# build: {json.dumps(row)}", flush=True)
    lib = _build.load_library()
    print("# build: bf16 flash kernels' dynamic shared memory (bytes): " +
          json.dumps({f"{'bwd' if b else 'fwd'}_dh{dh}":
                      lib.dpt_flash_smem_bytes(b, dh)
                      for b in (0, 1) for dh in (64, 128)}), flush=True)

    decode = clocked("decode kernels", kernel_phase, torch, fd, bw,
                     bf16_peak)
    span = clocked("span kernels", span_phase, torch, fd, bw, bf16_peak)
    flash = clocked("flash kernels", flash_phase, torch, bw, bf16_peak)
    update = clocked("fused update", update_phase, torch, bw, f32_peak,
                     GPT2_BASE)
    update_dq = clocked("fused update diffuseq", update_phase, torch, bw,
                        f32_peak, DIFFUSEQ_BASE,
                        name="fused_adamw_ema_diffuseq")
    small_model_phase(torch)
    t0 = time.perf_counter()
    serve, spec = serve_phase(torch, fd, bw, bf16_peak)
    print(f"# serve phase, spec runs included: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for row, kv_quant in zip(decode, ("fp", "int8")):
        run = dict(serve[kv_quant])
        row["launches"] = run.pop("launches")
        row.update({k: v for k, v in run.items() if k.startswith("serve_")})
    for row, key in zip(span, ("ngram_fp", "model_int8")):
        row["launches"] = spec[key]["span_kernel_launches"]
    train = clocked("train", train_phase, torch, fa, fu)
    for row in (*flash, update):
        row["launches"] = train["launches"][row["name"]]
    diffuseq = clocked("diffuseq", diffuseq_phase, torch, fa, fu)
    update_dq["launches"] = diffuseq["launches"]["fused_adamw_ema"]
    for row, n in zip(flash, diffuseq["seq1024"]["kernels"]["launches"]):
        row["launches_diffuseq_seq1024"] = n
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"spec": spec}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"diffuseq": diffuseq}), flush=True)
    print(f"# chip_smoke: all phases in {time.perf_counter() - start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [*decode, *span, *flash, update,
                                  update_dq]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
