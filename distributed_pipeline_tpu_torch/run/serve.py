"""Serving entry point: continuous-batching decode, single replica or fleet,
the port of ``distributed_pipeline_tpu/run/serve.py``.

Three modes:

* SINGLE (default): requests (a JSONL prompt file or a synthetic workload)
  stream through one in-process :class:`serving.scheduler.DecodeServer`:
  prefill and decode over the paged KV cache, each phase captured once as a
  CUDA graph and replayed on the GPU, free slots re-admitting queued
  requests every step, the decode-step attention through the flash-decode
  CUDA kernel. Arrivals come from the step cadence (``--traffic steps``,
  ``--arrival_every_steps``) or a seeded wall-clock process (``--traffic
  poisson|bursty|diurnal``, ``--rate_rps``; ``--shared_prefix_len`` makes
  the synthetic prompts open with one shared token run).
* FLEET (``--replicas N``): N replica WORKER processes — each its own
  supervised launcher ring (``parallel/launcher.py``) with restart
  budget/backoff and the beacon-mtime hang watchdog — behind a
  health-gated, load-aware request router with a durable journal
  (``serving/router.py``): in-flight requests on a killed or wedged
  replica replay on a sibling; ``--swap_after_requests`` rolls a newer
  checkpoint through the fleet with at least N-1 replicas serving at every
  instant (a corrupt target aborts on the canary); ``--autoscale`` grows
  and shrinks the replica set; ``--serve_transport socket`` moves the data
  plane onto TCP; ``--disagg 1`` turns the replicas into prefill workers
  that stream each request's KV pages to one decode worker. The fleet
  parent never imports torch; on a CUDA fleet it builds the kernels once
  before the first replica starts.
* WORKER (internal, ``--fleet_worker_dir``): one replica — loads the
  checkpoint, captures every phase's CUDA graph in a warm-up request
  before its first beacon, serves its inbox, beacons every tick, executes
  hot-swap commands (weights copied in place into the captured tensors),
  and writes the serving goodput sidecar.

    python -m distributed_pipeline_tpu_torch.run.serve --checkpoint_path RUN \\
        --decode_slots 32 --page_size 16 --max_new_tokens 128
    python -m distributed_pipeline_tpu_torch.run.serve --checkpoint_path RUN \\
        --replicas 2 --traffic poisson --rate_rps 8 --synthetic_requests 64

stdout carries one JSON summary line. Single mode: throughput, TTFT
mean/p50/p95, step counts, wall time, device, ``compile_time_s`` (graph
captures), decode-kernel launches (replays included), the KV pool's
storage ``kv_quant`` and its bytes ``kv_pool_bytes``. ``--kv_quant int8``
serves from an int8 page pool with per-page scales; ``--serve_quant int8``
serves int8-round-tripped weights. ``--spec_tokens K`` serves by
speculative decoding (``--spec_draft ngram|model``, ``--draft_layers``);
the summary then adds ``spec_tokens``, ``accept_rate``,
``accepted_tokens_per_s`` and the verify dispatches' span-kernel
launches. ``--prefix_cache true`` adds the cache's ``prefix_*`` gauges,
``--cost_ledger true`` a ``ledger`` of per-phase rows (``obs/ledger.py``),
and ``--sanitize true`` ``recompile_count`` (captures after the first
fetched token, 0 in a sound run) and ``xla_compiles_total`` (all
captures), with the evidence in ``sanitize_report.json`` beside the
checkpoint. ``--ema RATE`` serves the step's ``ema_{RATE}_NNNNNN.pt``
weights (``"params": "ema_RATE"``). ``--trace true`` prints that tracing
instruments fleet mode only. Fleet mode: the JAX package's keys
(``"mode": "fleet"``, ``completed``, ``dropped``, ``replayed``, ``swap``,
``replica_rcs``, ``serving_goodput``, ``autoscale``, ...) plus the
replicas' summed ``decode_kernel_launches`` and their ``device``; each
replica's clean-exit sidecar (``<fleet_dir>/replica_K/
serving_attempt*.json``) holds its kernel launches, its calls of the
plain decode version and its peak device memory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional, Sequence, Tuple

from ..config.serve import ServeSettings, parse_settings

__all__ = ["main", "serve", "fleet_workload"]

_MODULE = "distributed_pipeline_tpu_torch.run.serve"

# worker argv: every serve setting EXCEPT the fleet-parent-only knobs (the
# fleet appends --fleet_worker_dir/--replica_id per replica), so anything
# added to ServeSettings reaches the replica workers. The disagg knobs are
# parent-only too: the parent appends explicit --disagg_role/
# --disagg_links/--disagg_peers per worker tier.
_PARENT_ONLY = {"replicas", "fleet_dir", "fleet_worker_dir",
                "replica_id", "out", "prompt_file",
                "disagg", "disagg_role", "disagg_links", "disagg_peers"}


def _worker_argv(settings: ServeSettings) -> list:
    argv = []
    for f in dataclasses.fields(settings):
        if f.name in _PARENT_ONLY:
            continue
        argv += [f"--{f.name}", str(getattr(settings, f.name))]
    return argv


def _load_requests(settings: ServeSettings, max_prompt_len: int,
                   vocab_size: int) -> list:
    """(prompt int32 [L], max_new_tokens) pairs from the prompt file, or a
    synthetic workload of random prompts (0 = the settings' budget)."""
    import numpy as np

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
    if settings.traffic != "steps" or settings.shared_prefix_len > 0:
        # traffic-process synthetic workload: prompts come from the same
        # seeded generator as the schedule
        plen = min(settings.synthetic_prompt_len or max_prompt_len,
                   max_prompt_len)
        reqs = _generator(settings).requests(
            settings.synthetic_requests, vocab_size=vocab_size,
            prompt_len=plen, max_new_tokens=settings.max_new_tokens,
            shared_prefix_len=min(settings.shared_prefix_len, plen))
        return [(r.prompt, r.max_new_tokens) for r in reqs]
    rng = np.random.default_rng(settings.seed)
    plen = min(settings.synthetic_prompt_len or max_prompt_len,
               max_prompt_len)
    return [(rng.integers(4, vocab_size, (plen,)).astype(np.int32), 0)
            for _ in range(settings.synthetic_requests)]


def _generator(settings: ServeSettings, default: str = "poisson"):
    """The settings' traffic process ('steps' maps to ``default``: the
    fleet parent has no scheduler-step clock to count, and a shared-prefix
    workload's synthetic prompts come from a wall-clock process)."""
    from ..serving.traffic import TrafficGenerator

    process = settings.traffic if settings.traffic != "steps" else default
    return TrafficGenerator(
        process, settings.rate_rps, settings.seed,
        burst_every_s=settings.burst_every_s,
        burst_size=settings.burst_size,
        diurnal_period_s=settings.diurnal_period_s,
        diurnal_floor=settings.diurnal_floor)


def _quantized(settings: ServeSettings, state_dict):
    """``--serve_quant int8``: the state dict round-tripped through int8
    storage (``serving/quantize.py``); raises ``QuantizationError`` on a
    leaf that fails the guard — at load that fails the replica before
    ready, inside a hot swap it fails the swap's ack, so the canary keeps
    a bad quantization off the fleet."""
    if settings.serve_quant == "off":
        return state_dict
    from ..serving.quantize import quantize_state_dict
    return quantize_state_dict(state_dict)


def _resolve_chaos_plan(settings: ServeSettings):
    """--chaos_plan flag or the DPT_CHAOS_PLAN env; None when neither is
    set."""
    from ..chaos import CHAOS_PLAN_ENV, ChaosPlan

    src = settings.chaos_plan or os.environ.get(CHAOS_PLAN_ENV, "")
    return ChaosPlan.parse(src) if src else None


def _geometry(settings: ServeSettings, seq_len: int) -> Tuple[int, int]:
    max_len = settings.max_len or seq_len
    return max_len, settings.max_prompt_len or max(2, max_len // 2)


def _load_model(settings: ServeSettings, step: int):
    """(model, step, device) for a worker or the single server: the run
    dir's weights (``--serve_quant`` applied) on ``--device``, which raises
    when it is CUDA and CUDA is unavailable — there is no CPU fallback."""
    from ..utils.device import resolve_device
    from .sample import load_run

    device = resolve_device(settings.device)
    model, _targs, step = load_run(settings.checkpoint_path, step, device,
                                   settings.ema)
    if settings.serve_quant != "off":
        model.load_state_dict(_quantized(settings, model.state_dict()))
    return model, step, device


def _build_server(settings: ServeSettings, model, device, *,
                  cuda_graphs: bool = True, colocated: bool = True):
    """The settings' DecodeServer over ``model``; ``colocated=False`` is
    the disaggregated decode worker's (fp pool, no speculation, no prefix
    cache: the transferred frames are fp pages)."""
    from ..serving.scheduler import DecodeServer

    max_len, max_prompt_len = _geometry(settings, model.seq_len)
    extra = {}
    if colocated:
        extra = dict(kv_quant=settings.kv_quant,
                     spec_tokens=settings.spec_tokens,
                     spec_draft=settings.spec_draft,
                     draft_layers=settings.draft_layers,
                     prefix_cache=settings.prefix_cache,
                     census=settings.cost_ledger)
    return DecodeServer(
        model, decode_slots=settings.decode_slots,
        page_size=settings.page_size, max_pages=settings.max_pages,
        max_prompt_len=max_prompt_len, max_len=max_len,
        prefill_batch=settings.prefill_batch,
        decode_span=settings.decode_span,
        dispatch_lag=settings.dispatch_lag,
        temperature=settings.temperature, top_k=settings.top_k,
        top_p=settings.top_p, seed=settings.seed,
        eos_id=settings.eos_id if settings.eos_id >= 0 else None,
        decode_impl=settings.decode_impl, sanitize=settings.sanitize,
        cuda_graphs=cuda_graphs, device=device, **extra)


# =========================================================== single replica

def serve(settings: ServeSettings, cuda_graphs: bool = True) -> tuple:
    """Serve the settings' workload to completion in this process. Returns
    the summary (also printed as one JSON line), the server and the
    requests in submission order. Raises when the device is CUDA and CUDA
    is unavailable. ``cuda_graphs=False`` serves through eager engines
    (the graph engines' reference on the card)."""
    import torch

    from ..ops import flash_decode as fd

    if settings.trace:
        # tracing instruments the fleet's protocol layers; the in-process
        # single-replica path has nothing to stitch, so say so instead of
        # silently writing nothing
        print("# serve: --trace instruments fleet mode (--replicas N); "
              "ignored on the single-replica path", file=sys.stderr,
              flush=True)
    model, step, device = _load_model(settings, settings.step)
    server = _build_server(settings, model, device, cuda_graphs=cuda_graphs)
    max_prompt_len = server.engine.max_prompt_len

    pending = _load_requests(settings, max_prompt_len, model.vocab_size)
    print(f"# serve: {len(pending)} requests on {settings.decode_slots} "
          f"slots (page_size={settings.page_size}, "
          f"pool={server.mgr.num_pages} pages, kv_quant="
          f"{settings.kv_quant}, device={device})",
          file=sys.stderr, flush=True)

    # wall-clock arrival schedule; None keeps the step cadence
    offsets = (None if settings.traffic == "steps"
               else _generator(settings).schedule(len(pending)))
    launches0 = fd.launch_count()
    span0 = fd.span_launch_count()
    t0 = time.perf_counter()
    submitted = []
    cadence = settings.arrival_every_steps
    steps = 0
    warm_compiles = None  # captures up to the first fetched token: every
    # phase has been captured by then, so growth past it is a steady-state
    # recapture
    try:  # submits included: a bad request must still finalize the report
        if offsets is None and cadence <= 0:
            # saturating workload: everything queued up front
            for prompt, n in pending:
                submitted.append(server.submit(
                    prompt, n or settings.max_new_tokens))
            pending = []
        while pending or server.busy:
            if offsets is not None:
                now = time.perf_counter() - t0
                while pending and offsets[len(submitted)] <= now:
                    prompt, n = pending.pop(0)
                    submitted.append(server.submit(
                        prompt, n or settings.max_new_tokens))
                if pending and not server.busy:
                    # idle gap before the next arrival: sleep it off
                    # instead of spinning empty scheduler ticks
                    time.sleep(min(max(0.0, offsets[len(submitted)] - now),
                                   0.005))
            elif pending and cadence > 0 and steps % cadence == 0:
                prompt, n = pending.pop(0)
                submitted.append(server.submit(
                    prompt, n or settings.max_new_tokens))
            server.step()
            if warm_compiles is None and server.tokens_fetched > 0:
                warm_compiles = server.recompile_count
            steps += 1
        server.drain()
    finally:
        recompiles = server.stop_sanitizer()
        # evidence sidecar beside the served checkpoint
        report_dir = settings.checkpoint_path
        if report_dir and not os.path.isdir(report_dir):
            report_dir = os.path.dirname(report_dir) or "."
        server.write_sanitize_report(report_dir)
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
        "step": step,
        "params": f"ema_{settings.ema}" if settings.ema else "raw",
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
        "compile_time_s": round(server.compile_time_s, 3),
        "wall_s": round(wall_s, 2),
        "device": _device_name(device),
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
    result.update(server.prefix_stats())
    if settings.serve_quant != "off":
        result["serve_quant"] = settings.serve_quant
    if settings.cost_ledger:
        # per-phase rows over the run's wall; one device serves the whole
        # state, so the per-chip rate is the service rate
        result["ledger"] = server.cost_ledger(wall_s=wall_s, n_devices=1)
    if settings.sanitize:
        # growth past the warm snapshot must be 0: each phase is captured
        # exactly once, during warm-up
        result["recompile_count"] = (recompiles - warm_compiles
                                     if warm_compiles is not None
                                     else recompiles)
        result["xla_compiles_total"] = recompiles
    print(json.dumps(result), flush=True)
    return result, server, submitted


def _device_name(device) -> str:
    import torch
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


# ============================================================ fleet worker

def _warm(server) -> None:
    """Capture every phase the server will replay BEFORE the first beacon
    arms the watchdog: a 2-token request with a budget of 2 runs the
    prefill and one decode dispatch (the first token comes out of
    prefill), or with ``--spec_tokens`` one verify round and the model
    draft's prefill and decode; on the card each phase's first dispatch
    captures its CUDA graph. The first routed request then pays service
    time, not a capture, and a capture can never look like a hang."""
    import numpy as np

    server.submit(np.full((2,), 4, np.int32), max_new_tokens=2)
    server.drain()
    server.reset_stats()


def _worker_counters(device, launches0: int, span0: int) -> dict:
    """The port's per-worker counters for the sidecar: decode- and
    span-kernel launches since warm-up ended, the calls the decode seams
    routed to the plain versions over the whole process (0 on the card),
    the device and its peak allocated memory."""
    import torch

    from ..ops import flash_decode as fd

    out = {"device": _device_name(device),
           "decode_kernel_launches": fd.launch_count() - launches0,
           "span_kernel_launches": fd.span_kernel_launch_count() - span0,
           "plain_decode_calls": fd.plain_call_count()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        out["peak_memory_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    return out


def _swap_state(settings: ServeSettings, cmd: dict):
    """The state dict a hot-swap command names: ``model_NNNNNN.pt`` (or,
    under ``--ema``, the same step's ``ema_{rate}_NNNNNN.pt``), loaded on
    the host and re-quantized under ``--serve_quant``. A corrupt or
    missing file raises here, so the swap acks not-ok."""
    import torch

    path = cmd["target"]
    if settings.ema:
        path = os.path.join(os.path.dirname(path),
                            f"ema_{settings.ema}_{int(cmd['step']):06d}.pt")
    return _quantized(settings, torch.load(path, map_location="cpu",
                                           weights_only=True))


def _fleet_worker_main(settings: ServeSettings) -> dict:
    """One replica: serve the inbox until told to stop. Runs under a
    supervising launcher ring — beacons every tick (hang-watchdog liveness
    and the kill flight recorder), clears stale inbox entries at startup
    (the router replays them), executes hot-swap commands with a local
    drain, and books drain/swap time so the fleet goodput ledger accounts
    every second."""
    import collections

    import numpy as np

    from ..chaos import ChaosInjector
    from ..ops import flash_decode as fd
    from ..serving.fleet import ReplicaPaths, WorkerProtocol
    from ..serving.transport import prefix_block_hashes

    rid = settings.replica_id
    paths = ReplicaPaths.at(settings.fleet_worker_dir, rid)
    proto = WorkerProtocol(paths, rid,
                           trace_armed=True if settings.trace else None,
                           transport=settings.serve_transport)
    pin = proto.startup()  # inbox cleared; params pin from a prior swap

    plan = _resolve_chaos_plan(settings)
    injector = (ChaosInjector(plan, rank=rid, run_dir=paths.root)
                if plan else None)

    model, step, device = _load_model(
        settings, int(pin["step"]) if pin else settings.step)
    server = _build_server(settings, model, device)

    def _engine_step() -> None:
        """One scheduler step, span-attributed by phase: the prefill-vs-
        decode split is read off the server's own counters."""
        if not proto.tracer.enabled:
            server.step()
            return
        p0 = server.prefill_steps
        t0_wall = time.time()
        server.step()
        proto.tracer.complete(
            "prefill" if server.prefill_steps > p0 else "decode_span",
            "engine", t0_wall, time.time() - t0_wall,
            args={"in_flight": len(in_flight)})

    _warm(server)
    launches0 = fd.launch_count()
    span0 = fd.span_kernel_launch_count()

    # per-replica cost ledger: --cost_ledger snapshots the roofline
    # attribution into <replica>/perf_ledger.json
    t_serve0 = time.perf_counter()
    last_ledger = [0.0]

    def _write_ledger(force: bool = False) -> None:
        if not settings.cost_ledger:
            return
        now = time.perf_counter()
        if not force and now - last_ledger[0] < 2.0:
            return  # snapshot cadence: telemetry, not a per-tick duty
        last_ledger[0] = now
        from ..obs import ledger as ledger_lib
        try:
            rows = server.cost_ledger(wall_s=now - t_serve0, n_devices=1)
            ledger_lib.write_ledger(paths.root, rows, t=time.time())
        except Exception as e:  # telemetry must never kill the replica
            print(f"[serve-worker {rid}] ledger write failed: {e}",
                  file=sys.stderr, flush=True)

    tick = 0
    admitted = 0
    in_flight = {}  # router req id -> (server Request, inbox payload)
    completed = 0
    tokens_out = 0
    current_step = [step]

    # prefix-affinity advertisement: a bounded LRU of the page-aligned
    # prefix-block hashes this replica has served, riding every beacon
    # (file transport) and heartbeat (socket transport); only with the
    # prefix cache on
    prefix_index: dict = collections.OrderedDict()

    def _index_prefix(prompt) -> None:
        if not settings.prefix_cache:
            return
        for h in prefix_block_hashes(prompt, settings.page_size):
            prefix_index.pop(h, None)
            prefix_index[h] = None
        while len(prefix_index) > 256:
            prefix_index.popitem(last=False)

    def _beacon_extra() -> dict:
        extra = {}
        if settings.prefix_cache:
            stats = server.prefix_stats()
            extra.update({"prefix_index": list(prefix_index),
                          "prefix_hits": int(stats.get("prefix_hits", 0)),
                          "prefix_misses": int(
                              stats.get("prefix_misses", 0))})
        if settings.spec_tokens > 0:
            extra["accept_rate"] = round(server.accept_rate, 4)
            extra["accepted_tokens_per_s"] = round(
                server.tokens_fetched
                / max(time.perf_counter() - t_serve0, 1e-9), 1)
        return extra

    proto.write_beacon(tick)
    proto.announce_ready(step)
    print(f"[serve-worker {rid}] ready at step {step} on {device} "
          f"(attempt {proto.attempt})", file=sys.stderr, flush=True)

    def _report_done() -> None:
        nonlocal completed, tokens_out
        for rk, (req, payload) in list(in_flight.items()):
            if not req.finished:
                continue
            # TTFT relative to the ROUTER's submit stamp: queue wait and
            # any replay delay are inside the number a user feels
            ttft = None
            if req.ttft_s is not None:
                lag = payload["_t_local"] - float(
                    payload.get("submit_t", payload["_t_local"]))
                ttft = max(0.0, lag) + req.ttft_s
            proto.write_result({
                "id": int(payload["id"]),
                "tokens": [int(t) for t in req.tokens],
                "ttft_s": ttft, "params_step": current_step[0],
                "replays": int(payload.get("replays", 0))})
            completed += 1
            tokens_out += len(req.tokens)
            del in_flight[rk]

    def _handle_swap(cmd: dict) -> None:
        # local drain first: anything in flight finishes on the OLD params
        nonlocal tick
        with proto.tracker.timed("drain_s"):
            while server.busy:
                _engine_step()
                tick += 1
                proto.write_beacon(tick)
        _report_done()
        with proto.tracker.timed("swap_s"):
            proto.write_beacon(tick)  # restore time is not a hang
            try:
                server.set_params(_swap_state(settings, cmd))
                ok, err = True, ""
            except Exception as e:  # corrupt/missing payload: keep old
                ok, err = False, f"{type(e).__name__}: {e}"
            proto.write_beacon(tick)
        if ok:
            current_step[0] = int(cmd["step"])
            proto.announce_ready(current_step[0])
        proto.ack_swap(int(cmd["id"]), ok, current_step[0], err)
        print(f"[serve-worker {rid}] swap -> step {cmd['step']}: "
              f"{'ok' if ok else err}", file=sys.stderr, flush=True)

    try:
        while not proto.stop_requested():
            cmd = proto.pending_swap()
            if cmd is not None:
                _handle_swap(cmd)
            if injector is not None:
                injector.on_serve_tick(admitted, len(in_flight))
            moved = False
            for payload in proto.poll_inbox():
                try:
                    req = server.submit(
                        np.asarray(payload["prompt"], np.int32),
                        int(payload["max_new_tokens"]))
                except ValueError as e:
                    proto.write_result({"id": int(payload["id"]),
                                        "tokens": [], "ttft_s": None,
                                        "error": str(e)})
                    proto.consume(int(payload["id"]))
                    continue
                payload["_t_local"] = time.time()
                in_flight[int(payload["id"])] = (req, payload)
                proto.consume(int(payload["id"]))
                _index_prefix(np.asarray(payload["prompt"], np.int32))
                admitted += 1
                moved = True
            if server.busy:
                _engine_step()
                moved = True
            _report_done()
            tick += 1
            proto.write_beacon(tick, extra=_beacon_extra())
            _write_ledger()
            if not moved:
                time.sleep(0.005)
    finally:
        server.stop_sanitizer()
        server.write_sanitize_report(paths.root)
    # graceful stop: drain whatever is still in flight before exiting 0
    with proto.tracker.timed("drain_s"):
        while server.busy:
            _engine_step()
            tick += 1
            proto.write_beacon(tick)
    _report_done()
    _write_ledger(force=True)  # final snapshot covers the whole attempt
    proto.tracer.close()
    summary = {"ticks": tick, "admitted": admitted, "completed": completed,
               "tokens": tokens_out, "params_step": current_step[0],
               **server.prefix_stats(),
               "compile_time_s": round(server.compile_time_s, 3),
               **_worker_counters(device, launches0, span0)}
    if settings.spec_tokens > 0:
        summary["accept_rate"] = round(server.accept_rate, 4)
    proto.write_sidecar(summary)
    proto.close()  # data-plane endpoint down AFTER the final results
    #                were drained by the router (it polls until all done)
    print(f"[serve-worker {rid}] stopping: {json.dumps(summary)}",
          file=sys.stderr, flush=True)
    return summary


# ============================================== disaggregated fleet workers

def _disagg_prefill_main(settings: ServeSettings) -> dict:
    """One PREFILL worker of a disaggregated fleet: router requests come
    through the normal replica inbox, but instead of decoding locally the
    worker runs ONLY the prompt forward and streams the request — paged-KV
    pages + first token — over its kv StageLink to the decode ring, then
    relays the decode ring's token replies back to the router outbox. TTFT
    is stamped HERE: the first token exists the moment prefill
    completes."""
    import numpy as np

    from ..mpmd.disagg import PrefillClient, pack_kv_frame
    from ..mpmd.link import FileStageLink
    from ..serving.fleet import ReplicaPaths, WorkerProtocol

    rid = settings.replica_id
    paths = ReplicaPaths.at(settings.fleet_worker_dir, rid)
    proto = WorkerProtocol(paths, rid,
                           trace_armed=True if settings.trace else None)
    proto.startup()

    # --serve_quant is deterministic: both tiers quantize the same
    # checkpoint identically
    model, step, device = _load_model(settings, settings.step)
    max_len, max_prompt_len = _geometry(settings, model.seq_len)
    pre = PrefillClient(
        model, page_size=settings.page_size,
        max_prompt_len=max_prompt_len, max_len=max_len,
        temperature=settings.temperature, top_k=settings.top_k,
        top_p=settings.top_p, seed=settings.seed,
        decode_impl=settings.decode_impl)
    kv_link = FileStageLink(
        os.path.join(settings.disagg_links, f"kv_{rid}"),
        capacity=8, tracer=proto.tracer)
    tok_link = FileStageLink(
        os.path.join(settings.disagg_links, f"tok_{rid}"),
        capacity=64, tracer=proto.tracer)
    pre.warmup()  # capture before ready: first routed TTFT is service time

    def _ship(arrays, meta) -> bool:
        """Send one frame; False while the decode ring's link stays full
        (backpressure: the frame is kept and retried next tick — a full
        link's send timeout must not end the worker)."""
        try:
            return kv_link.send(arrays, meta, timeout_s=0.2,
                                interrupt=proto.stop_requested)
        except TimeoutError:
            return False

    tick = 0
    prefills = 0
    completed = 0
    outbound = None  # a packed frame the kv link refused (backpressure)
    in_flight = {}   # router req id -> inbox payload
    proto.write_beacon(tick)
    proto.announce_ready(step)
    print(f"[disagg-prefill {rid}] ready at step {step} on {device} "
          f"(attempt {proto.attempt})", file=sys.stderr, flush=True)

    while not proto.stop_requested():
        moved = False
        if outbound is not None:
            arrays, meta, payload = outbound
            if _ship(arrays, meta):
                in_flight[int(payload["id"])] = payload
                proto.consume(int(payload["id"]))
                outbound = None
                moved = True
        if outbound is None:
            for payload in proto.poll_inbox():
                if int(payload.get("id", -1)) in in_flight:
                    continue
                prompt = np.asarray(payload["prompt"], np.int32)
                try:
                    out = pre.prefill(prompt)
                except ValueError as e:
                    proto.write_result({"id": int(payload["id"]),
                                        "tokens": [], "ttft_s": None,
                                        "error": str(e)})
                    proto.consume(int(payload["id"]))
                    continue
                now = time.time()
                ttft = max(0.0, now - float(payload.get("submit_t", now)))
                arrays, meta = pack_kv_frame(
                    int(payload["id"]), prompt,
                    int(payload["max_new_tokens"]), out, src=rid,
                    submit_t=float(payload.get("submit_t", now)),
                    ttft_s=ttft, trace=payload.get("trace"))
                prefills += 1
                moved = True
                if _ship(arrays, meta):
                    in_flight[int(payload["id"])] = payload
                    proto.consume(int(payload["id"]))
                else:
                    outbound = (arrays, meta, payload)
                    break  # keep inbox order: ship this one first
        got = tok_link.recv(timeout_s=0.0)
        if got is not None:
            _, meta = got
            payload = in_flight.pop(int(meta["id"]), None)
            if payload is not None:
                proto.write_result({
                    "id": int(meta["id"]),
                    "tokens": [int(t) for t in meta.get("tokens", [])],
                    "ttft_s": meta.get("ttft_s"), "params_step": step,
                    "replays": int(payload.get("replays", 0))})
                completed += 1
            moved = True
        tick += 1
        proto.write_beacon(tick)
        if not moved:
            time.sleep(0.005)
    proto.tracer.close()
    summary = {"ticks": tick, "prefills": prefills, "completed": completed,
               "prompt_tokens": pre.prompt_tokens, "params_step": step,
               "link_wait_s": round(kv_link.take_wait_s(), 6),
               "compile_time_s": round(pre.engine.compile_time_s, 3),
               **_worker_counters(device, 0, 0)}
    proto.write_sidecar(summary)
    print(f"[disagg-prefill {rid}] stopping: {json.dumps(summary)}",
          file=sys.stderr, flush=True)
    return summary


def _disagg_decode_main(settings: ServeSettings) -> dict:
    """THE decode worker of a disaggregated fleet: polls every prefill
    worker's kv StageLink, admits transferred requests through
    ``DecodeServer.submit_prefilled`` (a ``None`` admission leaves the
    frame held — the link IS the backpressure), runs the decode loop, and
    answers each completed request on the owning prefill worker's tok
    link. Runs under its own supervised ring in ``<fleet_dir>/decode``
    with the same beacon/sidecar discipline as a replica — a restart
    recovers the SERVICE; requests whose transferred KV died with the
    attempt are not replayed (the router only replays on prefill-replica
    death) and fall to the fleet deadline."""
    from ..mpmd.disagg import unpack_kv_frame
    from ..mpmd.link import FileStageLink
    from ..ops import flash_decode as fd
    from ..serving.fleet import ReplicaPaths, WorkerProtocol

    rid = settings.replica_id
    paths = ReplicaPaths.at(settings.fleet_worker_dir, rid)
    proto = WorkerProtocol(paths, rid,
                           trace_armed=True if settings.trace else None)
    proto.startup()

    model, step, device = _load_model(settings, settings.step)
    if settings.kv_quant != "fp" or settings.spec_tokens > 0:
        # the prefill->decode KV wire frames are fp and the spec draft's
        # prefill mirror rides the colocated admission path — neither is
        # plumbed through the disagg transfer, so downgrade loudly
        # instead of serving a silently-mismatched pool
        print(f"[disagg-decode {settings.replica_id}] --kv_quant/"
              f"--spec_tokens are colocated-serving features; running "
              f"fp non-speculative", file=sys.stderr, flush=True)
    server = _build_server(settings, model, device, colocated=False)
    n_peers = max(1, settings.disagg_peers)
    kv_links = [FileStageLink(
        os.path.join(settings.disagg_links, f"kv_{i}"),
        capacity=8, tracer=proto.tracer) for i in range(n_peers)]
    tok_links = [FileStageLink(
        os.path.join(settings.disagg_links, f"tok_{i}"),
        capacity=64, tracer=proto.tracer) for i in range(n_peers)]

    # decode-phase capture before ready (the colocated worker's rationale)
    _warm(server)
    launches0 = fd.launch_count()
    span0 = fd.span_kernel_launch_count()

    tick = 0
    admitted = 0
    completed = 0
    tokens_out = 0
    held = None       # unpacked frame awaiting capacity
    in_flight = {}    # req key -> (server Request, frame meta)
    next_link = 0
    proto.write_beacon(tick)
    proto.announce_ready(step)
    print(f"[disagg-decode {rid}] ready at step {step} on {device} "
          f"(attempt {proto.attempt}, {n_peers} prefill peers)",
          file=sys.stderr, flush=True)

    def _reply_done() -> None:
        nonlocal completed, tokens_out
        for key, (req, meta) in list(in_flight.items()):
            if not req.finished:
                continue
            tok_links[int(meta["src"])].send({}, {
                "op": "tok", "id": int(meta["id"]),
                "tokens": [int(t) for t in req.tokens],
                "ttft_s": meta.get("ttft_s")},
                timeout_s=5.0, interrupt=proto.stop_requested)
            completed += 1
            tokens_out += len(req.tokens)
            del in_flight[key]

    try:
        while not proto.stop_requested():
            moved = False
            if held is None:
                for k in range(n_peers):
                    i = (next_link + k) % n_peers
                    got = kv_links[i].recv(timeout_s=0.0)
                    if got is not None:
                        held = unpack_kv_frame(*got)
                        next_link = (i + 1) % n_peers
                        moved = True
                        break
            if held is not None:
                try:
                    req = server.submit_prefilled(
                        held["prompt"], int(held["max_new_tokens"]),
                        first_token=int(held["first_token"]),
                        kv_pages=held["kv"])
                except ValueError as e:
                    tok_links[int(held["src"])].send({}, {
                        "op": "tok", "id": int(held["id"]), "tokens": [],
                        "ttft_s": None, "error": str(e)},
                        timeout_s=5.0, interrupt=proto.stop_requested)
                    held = None
                    moved = True
                else:
                    if req is not None:  # else: full — retry after a step
                        in_flight[(int(held["src"]), int(held["id"]))] = (
                            req, held)
                        admitted += 1
                        held = None
                        moved = True
            if server.busy:
                server.step()
                moved = True
            _reply_done()
            tick += 1
            proto.write_beacon(tick)
            if not moved:
                time.sleep(0.005)
    finally:
        server.stop_sanitizer()
        server.write_sanitize_report(paths.root)
    while server.busy:  # graceful stop: drain in-flight decodes
        server.step()
        tick += 1
        proto.write_beacon(tick)
    _reply_done()
    proto.tracer.close()
    summary = {"ticks": tick, "admitted": admitted, "completed": completed,
               "tokens": tokens_out, "params_step": step,
               "compile_time_s": round(server.compile_time_s, 3),
               **_worker_counters(device, launches0, span0)}
    proto.write_sidecar(summary)
    print(f"[disagg-decode {rid}] stopping: {json.dumps(summary)}",
          file=sys.stderr, flush=True)
    return summary


# ========================================================= fleet supervisor

def fleet_workload(settings: ServeSettings, vocab: int,
                   max_prompt_len: int):
    """THE fleet workload (torch-free), built in one place. Returns
    ``(gen, reqs)`` with ``reqs`` a list of ``(arrival_offset_s, prompt,
    max_new_tokens)`` in SUBMISSION order.

    With ``--prompt_file``, prompt i (file order) rides the i-th smallest
    arrival offset of the seeded generator — file order IS submission
    order, and for a fixed seed the whole (offset, prompt) pairing is
    identical in every process. Knobs fleet mode cannot honor fail LOUDLY:
    ``--arrival_every_steps`` is a scheduler-step cadence, and the fleet
    parent has no scheduler steps to count (``--traffic steps`` itself
    degrades to poisson arrivals, which only reshapes TIMING, never
    order)."""
    if settings.arrival_every_steps > 0:
        raise SystemExit(
            "--arrival_every_steps is a single-server scheduler-step "
            "cadence; the fleet parent has no scheduler steps to count. "
            "Use --traffic poisson/bursty/diurnal with --rate_rps "
            "instead (prompt-file order is preserved either way)")
    gen = _generator(settings, default="poisson")
    if settings.prompt_file:
        pairs = _load_requests(settings, max_prompt_len, vocab)
        offsets = gen.schedule(len(pairs))
        reqs = [(float(offsets[i]), p, n or settings.max_new_tokens)
                for i, (p, n) in enumerate(pairs)]
    else:
        plen = min(settings.synthetic_prompt_len or max_prompt_len,
                   max_prompt_len)
        reqs = [(r.t, r.prompt, r.max_new_tokens)
                for r in gen.requests(
                    settings.synthetic_requests, vocab_size=vocab,
                    prompt_len=plen,
                    max_new_tokens=settings.max_new_tokens,
                    shared_prefix_len=min(settings.shared_prefix_len,
                                          plen))]
    return gen, reqs


def _check_disagg(settings: ServeSettings) -> None:
    """The JAX package's parse-time refusals of ``--disagg``."""
    if settings.disagg != 1:
        raise SystemExit("--disagg supports exactly one decode ring "
                         f"(got {settings.disagg})")
    if settings.serve_transport != "file":
        raise SystemExit("--serve_transport socket is not supported "
                         "with --disagg (the disagg tiers speak "
                         "StageLinks between themselves)")
    if settings.autoscale:
        raise SystemExit("--autoscale cannot resize a disaggregated "
                         "fleet: the prefill peer count is pinned "
                         "into the decode ring's link topology")
    if settings.swap_after_requests > 0:
        # a hot-swap would drain the prefill tier while the decode tier
        # still holds transferred KV computed by OLD params — token
        # streams would silently mix checkpoints
        raise SystemExit("--disagg and --swap_after_requests are "
                         "mutually exclusive")


def _build_kernels_once(platform: str) -> None:
    """On a CUDA fleet, build the kernels in this (torch-free) process
    before any replica starts: N replicas would otherwise each run a cold
    build at once, and a watchdog or startup timeout could take the wait
    for a hang. A failure is printed, not raised: each replica then fails
    loudly on its own (no replica serves without its kernels or its
    card), and the summary's ``replica_rcs`` say so."""
    if platform not in ("", "cuda"):
        return
    from ..ops import _build
    t0 = time.perf_counter()
    try:
        _build.build_library()
    except (OSError, RuntimeError) as e:
        print(f"# fleet: kernel build failed in the parent ({e}); the "
              f"replicas will fail on their own", file=sys.stderr,
              flush=True)
        return
    print(f"# fleet: CUDA kernels built in "
          f"{time.perf_counter() - t0:.1f} s before the first replica",
          file=sys.stderr, flush=True)


def _sidecar_sum(fleet_dir: str, key: str) -> int:
    """``key`` summed over every clean-exit sidecar in a fleet dir."""
    from ..chaos import goodput

    return sum(int(rec.get(key) or 0)
               for rdir in goodput.list_replica_dirs(fleet_dir)
               for rec in goodput.read_serving_records(rdir).values())


def _fleet_main(settings: ServeSettings) -> dict:
    """N replicas behind the router, driven by a wall-clock traffic
    process; optional mid-run checkpoint hot-swap; serving goodput ledger
    at exit. This process stays torch-free — replicas pay for torch and
    the card."""
    import numpy as np

    from ..chaos import ChaosInjector, goodput
    from ..serving.fleet import ServingFleet
    from ..serving.router import Router

    with open(os.path.join(settings.checkpoint_path,
                           "training_args.json")) as f:
        targs = json.load(f)
    vocab = int(targs["vocab_size"])
    _max_len, max_prompt_len = _geometry(settings, int(targs["seq_len"]))

    fleet_dir = settings.fleet_dir or os.path.join(
        settings.checkpoint_path, "fleet")
    os.makedirs(fleet_dir, exist_ok=True)

    from ..obs.trace import TRACE_ENV
    trace_env = os.environ.get(TRACE_ENV)
    if settings.trace:
        # arm tracing fleet-wide: the env rides the launcher's worker
        # environment to every replica attempt and arms the supervisor
        # threads' launcher shards in the replica dirs (restored when the
        # run ends, so a later run in this process is not armed)
        os.environ[TRACE_ENV] = "1"

    # serving faults reach every replica worker of every attempt through
    # the worker argv's --chaos_plan (or the DPT_CHAOS_PLAN env they
    # inherit); the fleet-level injector only executes
    # corrupt_swap_checkpoint
    plan = _resolve_chaos_plan(settings)
    injector = (ChaosInjector(plan, rank=0, run_dir=fleet_dir)
                if plan else None)

    argv = _worker_argv(settings)

    # Disaggregation: the --replicas workers become PREFILL tiers and a
    # second 1-ring ServingFleet under <fleet_dir>/decode runs the decode
    # tier; both tiers get explicit role flags plus the shared StageLink
    # directory appended to the common worker argv.
    decode_fleet = None
    argv_prefill = argv
    if settings.disagg > 0:
        _check_disagg(settings)
        links_dir = os.path.join(fleet_dir, "links")
        os.makedirs(links_dir, exist_ok=True)
        disagg_argv = ["--disagg_links", links_dir,
                       "--disagg_peers", str(settings.replicas)]
        argv_prefill = argv + ["--disagg_role", "prefill"] + disagg_argv

    # replica device: 'auto' passes on this process's --device
    platform = settings.replica_platform
    if platform == "auto":
        platform = settings.device
    # build the workload BEFORE spawning anything: a knob fleet mode
    # cannot honor must abort with zero worker processes to clean up
    gen, reqs = fleet_workload(settings, vocab, max_prompt_len)
    _build_kernels_once(platform)
    fleet = ServingFleet(
        fleet_dir, settings.replicas, _MODULE, argv_prefill,
        devices_per_proc=1,
        hang_timeout_s=settings.hang_timeout_s,
        max_restarts=settings.fleet_max_restarts,
        restart_backoff_s=settings.fleet_backoff_s,
        replica_platform=platform,
        transport=settings.serve_transport)
    fleet.start()
    if settings.disagg > 0:
        decode_fleet = ServingFleet(
            os.path.join(fleet_dir, "decode"), 1, _MODULE,
            argv + ["--disagg_role", "decode"] + disagg_argv,
            devices_per_proc=1,
            hang_timeout_s=settings.hang_timeout_s,
            max_restarts=settings.fleet_max_restarts,
            restart_backoff_s=settings.fleet_backoff_s,
            replica_platform=platform)
        decode_fleet.start()
    router = Router(fleet.clients(), goodput.serving_journal_path(fleet_dir),
                    stale_beacon_s=settings.stale_beacon_s,
                    affinity=settings.route_affinity,
                    page_size=settings.page_size)

    scaler = None
    if settings.autoscale:
        from ..obs import trace as trace_lib
        from ..serving.autoscale import AutoScaler
        amax = settings.autoscale_max or settings.replicas
        scaler = AutoScaler(
            fleet, router,
            min_replicas=settings.autoscale_min,
            max_replicas=max(amax, settings.autoscale_min),
            slo_ttft_s=settings.autoscale_slo_ttft_s,
            up_backlog=settings.autoscale_up_backlog,
            down_frac=settings.autoscale_down_frac,
            cooldown_s=settings.autoscale_cooldown_s,
            window_s=settings.autoscale_window_s,
            drain_timeout_s=settings.drain_timeout_s,
            tracer=trace_lib.tracer_for(
                fleet_dir, "autoscaler",
                armed=True if settings.trace else None,
                proc="autoscaler"))

    print(f"# fleet: {settings.replicas} replicas, {len(reqs)} requests, "
          f"traffic {gen.describe()}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    swap_report = None
    swap_armed = False
    next_idx = 0
    deadline_hit = False
    try:
        while True:
            elapsed = time.perf_counter() - t0
            while next_idx < len(reqs) and reqs[next_idx][0] <= elapsed:
                _, prompt, mnt = reqs[next_idx]
                router.submit(prompt, mnt, submit_t=time.time())
                next_idx += 1
            router.poll()
            if fleet.swap_active:
                rep = fleet.step_swap(router)
                if rep is not None:
                    swap_report = rep
                    print(f"# fleet: swap "
                          f"{'ok' if rep['ok'] else 'ABORTED'}: "
                          f"{rep.get('error') or rep['step']}",
                          file=sys.stderr, flush=True)
            elif (not swap_armed and settings.swap_after_requests > 0
                  and router.completed >= settings.swap_after_requests):
                swap_armed = True
                try:
                    arm = fleet.begin_hot_swap(
                        settings.checkpoint_path, settings.swap_step,
                        drain_timeout_s=settings.drain_timeout_s,
                        swap_timeout_s=settings.swap_timeout_s,
                        injector=injector)
                    print(f"# fleet: hot-swap armed -> {arm['target']}",
                          file=sys.stderr, flush=True)
                except (FileNotFoundError, RuntimeError) as e:
                    swap_report = {"ok": False,
                                   "error": f"arm failed: {e}"}
            if scaler is not None:
                scaler.step()
            if (next_idx >= len(reqs) and router.all_done()
                    and not fleet.swap_active):
                break
            if elapsed > settings.fleet_deadline_s:
                deadline_hit = True
                break
            time.sleep(0.01)
    finally:
        if scaler is not None:
            scaler.close()
            scaler.tracer.close()
        for c in router.clients.values():
            try:
                c.close()
            except OSError:
                pass
        rcs = fleet.stop()
        decode_rcs = decode_fleet.stop() if decode_fleet else None
        if trace_env is None:
            os.environ.pop(TRACE_ENV, None)
        else:
            os.environ[TRACE_ENV] = trace_env
    wall_s = time.perf_counter() - t0

    records = sorted(router.records.values(), key=lambda r: r.id)
    if settings.out:
        with open(settings.out, "w") as f:
            for rec in records:
                f.write(json.dumps({
                    "id": rec.id, "prompt": rec.prompt.tolist(),
                    "tokens": rec.tokens, "replica": rec.replica,
                    "replays": rec.replays,
                    "params_step": rec.params_step,
                    "ttft_s": round(rec.ttft_s or 0.0, 4)}) + "\n")

    ttfts = router.ttfts()
    tokens = sum(len(r.tokens) for r in records if r.state == "done")
    agg = goodput.aggregate_serving(fleet_dir)
    dropped = router.submitted - router.completed

    # fleet-wide prefix-cache economics: sum the per-attempt sidecar
    # counters (each clean worker exit books its engine's totals)
    prefix_hits = _sidecar_sum(fleet_dir, "prefix_hits")
    prefix_misses = _sidecar_sum(fleet_dir, "prefix_misses")

    # fleet-wide decode roofline: average the replicas' serve_decode
    # attribution rows (each worker's --cost_ledger snapshot)
    decode_roofline = None
    if settings.cost_ledger:
        from ..obs import ledger as ledger_lib
        decs = []
        for rdir in goodput.list_replica_dirs(fleet_dir):
            led = ledger_lib.read_ledger(rdir)
            dec = (led or {}).get("programs", {}).get("serve_decode")
            if isinstance(dec, dict) and "mfu" in dec:
                decs.append(ledger_lib.attribution_columns(dec))
        if decs:
            keys = ("mfu",) + ledger_lib.GAP_TERMS
            decode_roofline = {
                k: round(sum(float(d.get(k) or 0.0) for d in decs)
                         / len(decs), 4) for k in keys}
            decode_roofline["replicas_reporting"] = len(decs)

    result = {
        "mode": "fleet",
        "replicas": settings.replicas,
        "traffic": gen.describe(),
        "requests": router.submitted,
        "completed": router.completed,
        "dropped": dropped,
        "replayed": router.replayed,
        "deadline_hit": deadline_hit,
        "decode_tokens": tokens,
        "decode_tokens_per_s": round(tokens / max(wall_s, 1e-9), 1),
        "ttft_p50_s": round(float(np.percentile(ttfts, 50)), 4)
        if ttfts else None,
        "ttft_p95_s": round(float(np.percentile(ttfts, 95)), 4)
        if ttfts else None,
        "swap": swap_report,
        "replica_rcs": rcs,
        "wall_s": round(wall_s, 2),
        "transport": settings.serve_transport,
        "affinity_placements": router.affinity_placements,
        "affinity_hits": router.affinity_hits,
        "prefix_hits": prefix_hits,
        "prefix_misses": prefix_misses,
        "prefix_hit_rate": round(
            prefix_hits / max(1, prefix_hits + prefix_misses), 4),
        "decode_roofline": decode_roofline,
        "autoscale": scaler.summary() if scaler is not None else None,
        "serving_goodput": {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in agg.items() if k != "per_replica"},
        "device": platform or "cuda",
        "decode_kernel_launches": _sidecar_sum(fleet_dir,
                                               "decode_kernel_launches"),
    }
    if decode_fleet is not None:
        decode_dir = os.path.join(fleet_dir, "decode")
        dagg = goodput.aggregate_serving(decode_dir)
        result["disagg"] = settings.disagg
        result["decode_rcs"] = decode_rcs
        result["decode_goodput"] = {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in dagg.items() if k != "per_replica"}
        result["decode_kernel_launches"] = _sidecar_sum(
            decode_dir, "decode_kernel_launches")
    print(json.dumps(result), flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> dict:
    settings = parse_settings(argv)
    # worker argv must survive whatever cwd the replica subprocess starts
    # in: normalize once so every consumer sees an absolute path
    settings.checkpoint_path = os.path.abspath(settings.checkpoint_path)
    if settings.fleet_worker_dir:
        if settings.disagg_role == "prefill":
            return _disagg_prefill_main(settings)
        if settings.disagg_role == "decode":
            return _disagg_decode_main(settings)
        return _fleet_worker_main(settings)
    if settings.replicas > 0:
        return _fleet_main(settings)
    return serve(settings)[0]


if __name__ == "__main__":
    main()
