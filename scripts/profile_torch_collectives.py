#!/usr/bin/env python3
"""Time the port's collectives between two gloo ranks sharing one card, at
GPT-2 base's sizes: the all-reduce of the flat gradient (gloo's own CUDA
path), and ``parallel/dist.py``'s ``reduce_scatter`` / ``all_gather`` of
that buffer and of one FSDP block unit (one ``all_to_all_single`` over
pinned host buffers); beside them gloo's own reduce-scatter, all-gather
and all-to-all on host tensors of the full size.

    python3 scripts/profile_torch_collectives.py [--reps 5]

Spawns its two ranks itself (``torch.distributed`` over gloo at
``tcp://localhost``); each prints its median seconds a call, one JSON line
(rank 0's is the last line). Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# GPT-2 base's flat parameter count and its largest FSDP unit (a block's
# cut leaves) at fsdp 2
N, UNIT = 124_356_864, 7_077_888


def rank_main(rank: int, port: int, reps: int) -> None:
    import torch
    sys.path.insert(0, REPO)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2")
    from distributed_pipeline_tpu_torch.parallel import dist
    dev = torch.device("cuda", 0)
    dist.setup_dist(dev)
    import torch.distributed as tdist
    full = torch.randn(N, device=dev)
    unit = torch.randn(UNIT, device=dev)
    host = full.cpu()
    half = torch.empty(N // 2)
    recv = torch.empty(N)
    cases = {
        # the gloo collectives alone, on host tensors of the full size
        "gloo_reduce_scatter_host": lambda: tdist.reduce_scatter_tensor(
            half, host),
        "gloo_all_gather_host": lambda: tdist.all_gather_into_tensor(
            recv, half),
        "gloo_all_to_all_host": lambda: tdist.all_to_all_single(recv, host),
        # the port's collectives on the card's tensors
        "all_reduce_full": lambda: dist.all_reduce(full),
        "reduce_scatter_full": lambda: dist.reduce_scatter(
            full[rank * N // 2:(rank + 1) * N // 2], full),
        "all_gather_full": lambda: dist.all_gather(
            full, full[rank * N // 2:(rank + 1) * N // 2]),
        "reduce_scatter_unit": lambda: dist.reduce_scatter(
            unit[:UNIT // 2].clone(), unit),
        "all_gather_unit": lambda: dist.all_gather(
            unit, unit[rank * UNIT // 2:(rank + 1) * UNIT // 2].clone()),
    }
    out = {}
    for name, fn in cases.items():
        times = []
        for _ in range(reps + 1):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times[1:])
    print(json.dumps({"rank": rank, "seconds_a_call": out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank >= 0:
        rank_main(args.rank, args.port, args.reps)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_collectives: CUDA is not available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from distributed_pipeline_tpu_torch.parallel.launcher import \
        find_free_port
    port = find_free_port()
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               "--port", str(port), "--reps",
                               str(args.reps)]) for r in (1, 0)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
