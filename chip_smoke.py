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
   full-reservation positions, a shared page), in f32 and bf16, with its
   time beside the plain version's, one ``scaled_dot_product_attention``
   call over pre-gathered K/V (a yardstick the port never calls) and the
   bound: the kernel's own bytes, ``decode_hbm_bytes(step_table=False)``,
   over the card's memory rate;
4. flash kernels: ``flash_forward`` / ``flash_backward`` against
   ``torch_flash_forward`` / ``torch_flash_backward`` at the training shape
   (B=4, H=12, L=1024, Dh=64, causal, bf16, the all-ones pad mask the model
   passes), a padded ragged bf16 case (L=1000, lengths 1000/733/1/0),
   small f32 cases (Dh 64 and 128), and bf16 cases at Dh=128 (L=1024),
   at L = 1, 65 and 129 (ragged against the 128-row tile) and non-causal
   with a dead row; bf16 is held against the plain version evaluated in
   f32 from the same bf16 inputs, and two bf16 backward calls on the same
   inputs are compared (dq is summed by atomics). Times at the training
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
   greedy; every request must get its tokens, the kernel must have run
   12 x decode_span x decode_steps times; then one decode step from a live
   state through the kernel and through the plain version, logits compared
   and next tokens equal, and the kernel timed at that state's depths
   beside its bound there;
8. train: GPT-2 base at full width and its 1024 context through
   ``run.train`` (synthetic-lm, batch 8 in microbatches of 4, 20 steps, lr
   3e-4, EMA 0.5/0.9/0.99, attention and update ``auto``): the flash
   kernels must run 12 x 2 x 20 times each and the update once a step,
   every loss must be finite and the last below the first, the run dir
   must hold the final model/EMA/optimizer files and ``run.serve`` must
   answer 4 requests from it; then one step from the saved state with the
   kernels and with the plain versions, loss and grad norm compared.

The line before the last is ``{"kernels": [...]}`` and the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

GPT2_BASE = dict(model_family="gpt2", model_size="base", vocab_size=50257,
                 seq_len=1024, hidden_size=768, num_layers=12, num_heads=12,
                 dtype="bfloat16")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def device_ms(fn, torch, flush, reps: int = 20) -> tuple:
    """Device time of one ``fn()`` call and its split by kernel name: the
    kernels (and memsets) it launches, summed from ``torch.profiler``'s CUDA
    activity over ``reps`` calls, each after an L2 flush whose own fill
    kernel is left out. Unlike ``time_ms`` it does not count the host's
    enqueue time, which exceeds the device time of a call this short."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        if us > 0 and "FillFunctor" not in e.key:
            split[e.key[:80]] = us / reps / 1e3
    return sum(split.values()), split


def kernel_phase(torch, fd, bw, bf16_peak) -> dict:
    """flash_decode vs torch_paged_decode at the serving shapes."""
    from distributed_pipeline_tpu_torch.serving.paged_kv import gather_kv

    dev = torch.device("cuda")
    B, H, Dh, ps, n = 32, 12, 64, 16, 64
    P = 1 + B * n
    g = torch.Generator(device=dev).manual_seed(0)
    table = 1 + torch.arange(B * n, dtype=torch.int32, device=dev).view(B, n)
    table[2, 0] = table[1, 0]                      # one shared page
    # dead slot, one live key, exact page ends and starts, interior, full
    # reservation, then the serve phase's depths (256 prompt + decode)
    pos = [-1, 0, 15, 16, 31, 255, 256, 1023] + [256 + 5 * i
                                                 for i in range(B - 8)]
    positions = torch.tensor(pos, dtype=torch.int32, device=dev)
    base = [torch.randn(shape, generator=g, device=dev)
            for shape in ((B, H, Dh), (P, ps, H, Dh), (P, ps, H, Dh))]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, pk, pv = (t.to(dtype) for t in base)
        got = fd.flash_decode(q, pk, pv, table, positions)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            ref = fd.torch_paged_decode(q, pk, pv, table, positions)
            rtol, atol = 1e-4, 1e-5    # another summation order
        else:
            # the plain version in f32 from the same bf16 inputs; the
            # kernel rounds its f32 result to bf16 once
            ref = fd.torch_paged_decode(q.float(), pk.float(), pv.float(),
                                        table, positions)
            rtol, atol = 8e-3, 8e-3
        err = (got.float() - ref).abs()
        errs[str(dtype)] = float(err.max())
        check(bool(torch.all(err <= atol + rtol * ref.abs())),
              f"flash_decode {dtype} disagrees with the plain version: "
              f"max abs err {float(err.max())}")
        check(bool(torch.all(got[0] == 0)), "dead slot is not zero")
    print(f"# kernel check: max abs err {errs}", flush=True)

    # times at the main path's dtype (bf16)
    q, pk, pv = (t.to(torch.bfloat16) for t in base)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: fd.flash_decode(q, pk, pv, table, positions),
                 torch, flush)
    plain_ms = time_ms(
        lambda: fd.torch_paged_decode(q, pk, pv, table, positions),
        torch, flush)
    ks, vs = gather_kv(pk, table), gather_kv(pv, table)
    live = (torch.arange(n * ps, device=dev)[None, :]
            <= positions[:, None])[:, None, None, :]
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], ks, vs, attn_mask=live), torch, flush)
    bound = kernel_bound(fd, table, positions, ps, H, Dh, bw, bf16_peak)
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "distributed_pipeline_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "distributed_pipeline_tpu/ops/flash_decode.py:155",
        "launches": None, "max_abs_err": errs[str(torch.bfloat16)],
        "max_abs_err_f32": errs[str(torch.float32)],
        "ms": ms, "plain_ms": plain_ms, **bound,
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention over pre-gathered "
                        "K/V (the gather excluded)",
    }


def kernel_bound(fd, table, positions, ps, H, Dh, bw, bf16_peak) -> dict:
    """The least time the card could take for one bf16 flash_decode call on
    these inputs: the larger of the kernel's own bytes
    (``decode_hbm_bytes(step_table=False)``: distinct live K/V pages, q,
    out, live table entries, positions) over the memory rate and its flops
    (q.k and p.v over the live keys) over the bf16 peak."""
    bt, pos = table.cpu().numpy(), positions.cpu().numpy()
    hbm_bytes = fd.decode_hbm_bytes(bt, pos, ps, H, Dh, dtype_bytes=2,
                                    step_table=False)
    live_keys = sum(min(int(p) + 1, bt.shape[1] * ps) for p in pos if p >= 0)
    flops = 4 * live_keys * H * Dh                 # q.k and p.v, 2 each
    bytes_ms, ops_ms = hbm_bytes / bw * 1e3, flops / bf16_peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "hbm_bytes": hbm_bytes}


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


def serve_phase(torch, fd, bw, bf16_peak):
    """GPT-2 base at full width through run.serve (which prints its JSON
    summary); returns the kernel's launches in that run and the kernel's
    time and bound at a live serving state."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.convert import init_params
    from distributed_pipeline_tpu_torch.run.serve import serve
    from distributed_pipeline_tpu_torch.utils.checkpoint import save_run

    new_tokens = 128
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "gpt2_base")
        t0 = time.perf_counter()
        save_run(run, GPT2_BASE, init_params(GPT2_BASE, seed=0), step=1)
        print(f"# serve: wrote seeded GPT-2 base weights in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        settings = parse_settings([
            "--checkpoint_path", run, "--decode_slots", "32",
            "--page_size", "16", "--max_prompt_len", "512",
            "--synthetic_requests", "64", "--synthetic_prompt_len", "256",
            "--max_new_tokens", str(new_tokens), "--temperature", "0",
            "--decode_impl", "auto"])
        fd.reset_launch_count()
        summary, server, reqs = serve(settings)
        launches = fd.launch_count()

    eng = server.engine
    check(len(reqs) == 64, f"{len(reqs)} requests served")
    for r in reqs:
        check(len(r.tokens) == new_tokens
              and all(0 <= t < GPT2_BASE["vocab_size"] for t in r.tokens),
              f"request {r.id} returned {len(r.tokens)} tokens")
    want = GPT2_BASE["num_layers"] * eng.decode_span * server.decode_steps
    check(launches == want == summary["decode_kernel_launches"],
          f"kernel launches {launches}, expected {want}")
    check(all(t.is_cuda for pair in eng.kv_cache for t in pair),
          "the KV pool is not on the GPU")

    # one decode step from a live state, kernel vs plain version
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    prompts = [r.prompt for r in reqs[:32]]
    for p in prompts:
        server.submit(p, max_new_tokens=8)
    server.step()
    server.step()
    saved = [(k.clone(), v.clone()) for k, v in eng.kv_cache]
    logits = {}
    with torch.inference_mode():
        for impl in ("cuda", "torch"):
            for (k, v), (k0, v0) in zip(eng.kv_cache, saved):
                k.copy_(k0)
                v.copy_(v0)
            logits[impl] = eng.model(
                eng.tokens[:, None], None, cache_index=eng.positions,
                block_table=eng.block_table, kv_cache=eng.kv_cache,
                decode_impl=impl)[:, 0].float()

    # the kernel alone at this live state's depths (layer 0's pool, a fresh
    # bf16 q), beside its bound on the same inputs
    k0, v0 = eng.kv_cache[0]
    H = GPT2_BASE["num_heads"]
    q = torch.randn((eng.decode_slots, H, k0.shape[-1]), device="cuda",
                    dtype=k0.dtype)
    table, positions = eng.block_table, eng.positions
    depth = {"serve_depth_ms": time_ms(
        lambda: fd.flash_decode(q, k0, v0, table, positions), torch, flush)}
    depth.update({f"serve_depth_{key}": val for key, val in kernel_bound(
        fd, table, positions, k0.shape[1], H, k0.shape[-1], bw,
        bf16_peak).items()})
    pos = positions.cpu()
    print(f"# serve: kernel at the live state (depths {int(pos.min())}-"
          f"{int(pos.max())}): {depth}", flush=True)
    server.drain()

    a, b = logits["cuda"], logits["torch"]
    check(bool(torch.isfinite(a).all()), "kernel-path logits not finite")
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"# serve: one decode step, kernel vs plain: max |logit| {scale}, "
          f"max abs diff {diff}, argmax agreement {agree}", flush=True)
    # bf16 through 12 layers: the plain version rounds logits and
    # probabilities to bf16 in every layer, the kernel keeps f32; allow 5%
    # of the logit scale, and every slot must pick the same next token
    check(diff <= 0.05 * scale, f"decode logits differ by {diff} "
          f"(scale {scale})")
    check(agree == 1.0, f"kernel and plain version pick different next "
          f"tokens for {1 - agree:.4f} of the slots")
    return launches, depth


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


def flash_check(torch, fa, B, H, L, Dh, dtype, causal, lens, seed):
    """Kernel forward and backward vs the plain versions on one case; bf16
    against the plain version in f32 from the same bf16 inputs. Returns
    the max abs errors, and for bf16 the max difference between two
    backward calls on the same inputs (dq is summed by atomics)."""
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
    errs = {"out": close_enough(out, ref_out, **tol),
            "lse": close_enough(lse, ref_lse, rtol=1e-5, atol=1e-4)}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        # bf16: p and ds enter their products as bf16 (2^-9 relative each)
        # and dq is summed by f32 atomics in a varying order. A row with
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
    return errs


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
    errs = {name: flash_check(torch, fa, *c, seed=i)
            for i, (name, c) in enumerate(cases.items())}
    print(f"# flash check: max abs err {json.dumps(errs)}", flush=True)
    rerun = max(e.get("rerun_max_diff", 0.0) for e in errs.values())
    print(f"# flash determinism: max diff between two bf16 backward calls "
          f"on the same inputs {rerun}", flush=True)

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


def gpt2_base_param_shapes():
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    model = create_model_from_config(**GPT2_BASE, device="meta")
    return [tuple(p.shape) for p in model.parameters()]


def update_phase(torch, bw, f32_peak) -> dict:
    """The fused update vs its plain version, bitwise over 3 steps, at GPT-2
    base's parameter count with 3 EMA rates; its time beside its bound."""
    from distributed_pipeline_tpu_torch.ops import fused_update as fu

    dev = torch.device("cuda")
    shapes = gpt2_base_param_shapes()
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
    print(f"# update check: {n} elements x 3 steps, kernel == plain "
          f"bitwise", flush=True)
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
    return {"name": "fused_adamw_ema", "route": "cuda",
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
    out = {}
    for arm, (attn, fused) in (("kernels", ("auto", "auto")),
                               ("plain", ("torch", "false"))):
        model = create_model_from_config(**{**GPT2_BASE,
                                            "attention_impl": attn},
                                         device="cuda")
        loop = TrainLoop(
            model=model, data=None, batch_size=8, microbatch=4, lr=args.lr,
            ema_rate=args.ema_rate, learning_steps=args.learning_steps,
            checkpoint_dir=run, fused_update=fused, logger=Logger(""))
        check(loop.step == 20, f"resumed at step {loop.step}, not 20")
        fa.reset_launch_counts()
        fu.reset_launch_count()
        m = loop.run_step(batch)
        out[arm] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
        n = (fa.forward_launch_count(), fa.backward_launch_count(),
             fu.launch_count())
        check(n == ((24, 24, 1) if arm == "kernels" else (0, 0, 0)),
              f"{arm} arm launches {n}")
        del loop, model
        torch.cuda.empty_cache()
    a, b = out["kernels"], out["plain"]
    print(f"# train: one step from the saved state, kernels {a}, plain {b}",
          flush=True)
    # bf16 through 12 layers: both arms round p to bf16 before p.v; the
    # plain backward runs f32 einsums where the kernel feeds p and ds to
    # its products as bf16 and sums dq by atomics; allow 0.5% of the loss
    # and 3% of the gradient norm
    check(abs(a["loss"] - b["loss"]) <= 5e-3 * abs(b["loss"]),
          f"one-step loss differs: {a} vs {b}")
    check(abs(a["grad_norm"] - b["grad_norm"]) <= 3e-2 * b["grad_norm"],
          f"one-step grad norm differs: {a} vs {b}")
    return {"one_step": out}


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

    t0 = time.perf_counter()
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

    decode = kernel_phase(torch, fd, bw, bf16_peak)
    flash = flash_phase(torch, bw, bf16_peak)
    update = update_phase(torch, bw, f32_peak)
    small_model_phase(torch)
    launches, depth = serve_phase(torch, fd, bw, bf16_peak)
    decode.update(depth, launches=launches)
    train = train_phase(torch, fa, fu)
    for row in (*flash, update):
        row["launches"] = train["launches"][row["name"]]
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"kernels": [decode, *flash, update]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
