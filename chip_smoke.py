#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card: ``nvidia-smi`` name and power limit; CUDA must be available;
2. build: the CUDA kernels from ``distributed_pipeline_tpu_torch/ops/csrc``;
3. kernel: ``flash_decode`` against its plain version
   ``torch_paged_decode`` at the serving shapes (H=12, Dh=64, page_size 16,
   32 slots, 64-page reservations; an empty slot, page edges, interior and
   full-reservation positions, a shared page), in f32 and bf16, with its
   time beside the plain version's, one ``scaled_dot_product_attention``
   call over pre-gathered K/V (a yardstick the port never calls) and the
   bound: the kernel's own bytes, ``decode_hbm_bytes(step_table=False)``,
   over the card's memory rate;
4. small-model check: greedy serving of a small f32 GPT-2 on the GPU
   (through the kernel) gives the same tokens as on the CPU (plain
   version);
5. serve: GPT-2 base at full width (hidden 768, 12 layers, 12 heads, vocab
   50257, seq_len 1024) with seeded random weights, through ``run.serve``
   on 32 slots, 64 requests of 256 prompt tokens, 128 new tokens each,
   greedy; every request must get its tokens, the kernel must have run
   12 x decode_span x decode_steps times; then one decode step from a live
   state through the kernel and through the plain version, logits compared
   and next tokens equal, and the kernel timed at that state's depths
   beside its bound there.

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

# Published rates of the cards this port targets (NVIDIA data sheets; dense,
# no sparsity): HBM bytes/s and bf16 tensor-core flop/s, matched on the name
# nvidia-smi reports.
CARDS = {
    "H100 80GB HBM3": (3.35e12, 989e12),  # H100 SXM
    "H100 NVL": (3.9e12, 835e12),
    "H100 PCIe": (2.0e12, 756e12),
    "H200": (4.8e12, 989e12),
}

GPT2_BASE = dict(model_family="gpt2", model_size="base", vocab_size=50257,
                 seq_len=1024, hidden_size=768, num_layers=12, num_heads=12,
                 dtype="bfloat16")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_rates(name: str):
    for key, rates in CARDS.items():
        if key in name:
            return rates
    raise RuntimeError(f"chip_smoke: no published memory rate for {name!r}")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from distributed_pipeline_tpu_torch.ops import _build
    from distributed_pipeline_tpu_torch.ops import flash_decode as fd

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    bw, bf16_peak = card_rates(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load_library()
    print(f"# build: CUDA kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    kernel = kernel_phase(torch, fd, bw, bf16_peak)
    small_model_phase(torch)
    launches, depth = serve_phase(torch, fd, bw, bf16_peak)
    kernel.update(depth, launches=launches)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
