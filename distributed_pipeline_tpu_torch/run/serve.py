"""Serving entry point, single replica: the port of the single mode of
``distributed_pipeline_tpu/run/serve.py``.

Requests (a JSONL prompt file or a synthetic workload) stream through one
in-process :class:`serving.scheduler.DecodeServer`: prefill and decode over
the paged KV cache, free slots re-admitting queued requests every step, the
decode-step attention through the flash-decode CUDA kernel on the GPU.

    python -m distributed_pipeline_tpu_torch.run.serve --checkpoint_path RUN \
        --decode_slots 32 --page_size 16 --max_new_tokens 128

stdout carries one JSON summary line (throughput, TTFT mean/p50/p95, step
counts, wall time, device, decode-kernel launches, the KV pool's storage
``kv_quant`` and its bytes ``kv_pool_bytes``). ``--kv_quant int8`` serves
from an int8 page pool with per-page scales. ``--spec_tokens K`` serves by
speculative decoding (``--spec_draft ngram|model``, ``--draft_layers``);
the summary then adds ``spec_tokens``, ``accept_rate``,
``accepted_tokens_per_s`` and the verify dispatches' span-kernel launches.
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.serve import ServeSettings, parse_settings
from ..ops import flash_decode as fd
from ..serving.scheduler import DecodeServer
from ..utils.device import resolve_device
from .sample import load_run

__all__ = ["main", "serve"]


def _load_requests(settings: ServeSettings, max_prompt_len: int,
                   vocab_size: int) -> List[Tuple[np.ndarray, int]]:
    """(prompt int32 [L], max_new_tokens) pairs from the prompt file, or a
    synthetic workload of random prompts (0 = the settings' budget)."""
    if settings.prompt_file:
        out = []
        with open(settings.prompt_file) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                prompt = np.asarray(row["prompt_ids"], np.int32)
                if prompt.shape[0] > max_prompt_len:
                    # keep the TAIL — the context a continuation wants
                    print(f"# serve: truncating a {prompt.shape[0]}-token "
                          f"prompt to the last {max_prompt_len}",
                          file=sys.stderr)
                    prompt = prompt[-max_prompt_len:]
                out.append((np.minimum(prompt, vocab_size - 1),
                            int(row.get("max_new_tokens",
                                        settings.max_new_tokens))))
        return out
    rng = np.random.default_rng(settings.seed)
    plen = min(settings.synthetic_prompt_len or max_prompt_len,
               max_prompt_len)
    return [(rng.integers(4, vocab_size, (plen,)).astype(np.int32), 0)
            for _ in range(settings.synthetic_requests)]


def serve(settings: ServeSettings) -> Tuple[dict, DecodeServer, list]:
    """Serve the settings' workload to completion. Returns the summary (also
    printed as one JSON line), the server and the requests in submission
    order. Raises when the device is CUDA and CUDA is unavailable."""
    device = resolve_device(settings.device)
    model, _targs, step = load_run(settings.checkpoint_path, settings.step,
                                   device)
    max_len = settings.max_len or model.seq_len
    max_prompt_len = settings.max_prompt_len or max(2, max_len // 2)
    server = DecodeServer(
        model, decode_slots=settings.decode_slots,
        page_size=settings.page_size, max_pages=settings.max_pages,
        max_prompt_len=max_prompt_len, max_len=max_len,
        prefill_batch=settings.prefill_batch,
        decode_span=settings.decode_span,
        dispatch_lag=settings.dispatch_lag,
        temperature=settings.temperature, top_k=settings.top_k,
        top_p=settings.top_p, seed=settings.seed,
        eos_id=settings.eos_id if settings.eos_id >= 0 else None,
        decode_impl=settings.decode_impl, kv_quant=settings.kv_quant,
        spec_tokens=settings.spec_tokens, spec_draft=settings.spec_draft,
        draft_layers=settings.draft_layers, device=device)

    pending = _load_requests(settings, max_prompt_len, model.vocab_size)
    print(f"# serve: {len(pending)} requests on {settings.decode_slots} "
          f"slots (page_size={settings.page_size}, "
          f"pool={server.mgr.num_pages} pages, kv_quant="
          f"{settings.kv_quant}, device={device})",
          file=sys.stderr, flush=True)

    launches0 = fd.launch_count()
    span0 = fd.span_launch_count()
    t0 = time.perf_counter()
    submitted = []
    cadence = settings.arrival_every_steps
    steps = 0
    if cadence <= 0:
        # saturating workload: everything queued up front
        for prompt, n in pending:
            submitted.append(server.submit(prompt,
                                           n or settings.max_new_tokens))
        pending = []
    while pending or server.busy:
        if pending and steps % cadence == 0:
            prompt, n = pending.pop(0)
            submitted.append(server.submit(prompt,
                                           n or settings.max_new_tokens))
        server.step()
        steps += 1
    server.drain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0

    if settings.out:
        with open(settings.out, "w") as f:
            for req in submitted:
                f.write(json.dumps({
                    "id": req.id, "prompt": req.prompt.tolist(),
                    "tokens": req.tokens,
                    "ttft_s": round(req.ttft_s or 0.0, 4)}) + "\n")

    ttft = server.ttft.summary()
    result = {
        "step": step, "params": "raw",
        "requests": len(submitted),
        "decode_tokens": server.tokens_fetched,
        # one device serves the whole state: the service rate IS the
        # per-chip rate
        "decode_tokens_per_s_per_chip": round(
            server.tokens_fetched / max(wall_s, 1e-9), 1),
        "time_to_first_token_s": round(ttft["mean"], 4),
        "ttft_p50_s": round(ttft["p50"], 4),
        "ttft_p95_s": round(ttft["p95"], 4),
        "decode_steps": server.decode_steps,
        "prefill_steps": server.prefill_steps,
        "decode_slots": settings.decode_slots,
        "page_size": settings.page_size,
        "decode_span": settings.decode_span,
        "traffic": settings.traffic,
        "wall_s": round(wall_s, 2),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "decode_kernel_launches": fd.launch_count() - launches0,
        "kv_quant": settings.kv_quant,
        "kv_pool_bytes": server.engine.kv_pool_bytes(),
    }
    if settings.spec_tokens > 0:
        # every fetched token is target-verified, so the accepted rate IS
        # the service rate; accept_rate is the draft's hit rate
        result["spec_tokens"] = settings.spec_tokens
        result["spec_draft"] = settings.spec_draft
        result["spec_rounds"] = server.spec_rounds
        result["accept_rate"] = round(server.accept_rate, 4)
        result["accepted_tokens_per_s"] = result[
            "decode_tokens_per_s_per_chip"]
        result["span_kernel_launches"] = fd.span_launch_count() - span0
    print(json.dumps(result), flush=True)
    return result, server, submitted


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return serve(parse_settings(argv))[0]


if __name__ == "__main__":
    main()
