#!/usr/bin/env python3
"""Where the span kernel's time goes, on one GPU.

    python3 scripts/profile_torch_span.py

At the span phase's shapes of ``chip_smoke.py`` (32 slots x 5 links, H=12,
Dh=64, page 16, 64-page reservations; "main": that phase's positions,
"serve": every slot's links at depths 264-268, as in its spec runs), bf16 q
over bf16 and int8 pools, device time by ``torch.profiler`` after a clean
L2 flush:

1. plans: the kernel (and its "minblocks2" copy below) under other
   (pages_per_chunk, stages) than ``span_plan`` picks, two turns each;
2. ablations: copies of ``ops/csrc/flash_span.cu`` built beside the real
   library with the fold removed ("nofold": the pages are still copied and
   repacked, no MMA or softmax runs), the combine removed ("nocombine"), each page
   fetched by one bulk copy per token row instead of one per tile
   ("rowcopy"),
   registers capped for two CTAs an SM ("minblocks2": 72, spilling), or
   the chunks dispatched last first ("reverse");
3. timeline: a copy that stamps ``%globaltimer`` and ``%smid`` per CTA
   (start, first page arrived, fold done, ticket taken, end); prints
   per-phase medians over the live CTAs, the combine's duration, when the
   last CTA ended, and how many SMs ran one, two or more live CTAs.

The copies are built with the library's own flags into ``ops/_build/``;
nothing here is used by the port. Needs a CUDA device.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from distributed_pipeline_tpu_torch.ops import _build  # noqa: E402
from distributed_pipeline_tpu_torch.ops import flash_decode as fd  # noqa: E402

SRC = os.path.join(ROOT, "distributed_pipeline_tpu_torch", "ops", "csrc",
                   "flash_span.cu")
OUT = os.path.join(ROOT, "distributed_pipeline_tpu_torch", "ops", "_build",
                   "profile")

ABLATIONS = {
    "nofold": [("        mbar_arrive(&empty[s]);\n\n",
                "        mbar_arrive(&empty[s]);\n      continue;\n")],
    "nocombine": [("  if (!*last_flag) return;", "  return;")],
    "rowcopy": [("        if (heads == H) {  // the page is one block, as it lies",
                 "        if (false) {")],
    "minblocks2": [("__launch_bounds__(kMaxThreads, 1)",
                    "__launch_bounds__(kMaxThreads, 2)")],
    "reverse": [("  const int chunk = blockIdx.y;",
                 "  const int chunk = gridDim.y - 1 - blockIdx.y;")],
}

# %globaltimer stamps, slot by slot: 0 start, 1 first page arrived, 2 fold
# done, 3 ticket taken, 4 end (top bit set on the CTA that combined), 5 the
# combine's m and l loaded, 6 its weights computed, 7 SM
TIMELINE = [
    ("namespace {\n",
     "namespace {\n"
     "__device__ unsigned long long* g_stamps;\n"
     "__device__ __forceinline__ unsigned long long stamp() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "__device__ __forceinline__ unsigned long long smid() {\n"
     "  unsigned s;\n  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s));\n"
     "  return s;\n}\n"),
    ("  __syncthreads();\n",
     "  __syncthreads();\n"
     "  unsigned long long* st = g_stamps + ((long long)(blockIdx.z * "
     "gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 8;\n"
     "  if (threadIdx.x == 0) { st[0] = stamp(); st[7] = smid(); }\n"),
    ("    mbar_wait(&full[s], (j / stages) & 1);\n    const uint8_t* kt",
     "    mbar_wait(&full[s], (j / stages) & 1);\n"
     "    if (j == 0 && threadIdx.x == 0) st[1] = stamp();\n"
     "    const uint8_t* kt"),
    ("  // the quad's lanes hold partial sums over their own columns\n",
     "  if (threadIdx.x == 0) st[2] = stamp();\n"
     "  // the quad's lanes hold partial sums over their own columns\n"),
    ("            pack_bf16(o[nt][2] * inv_hi, o[nt][3] * inv_hi);\n"
     "    }\n    return;",
     "            pack_bf16(o[nt][2] * inv_hi, o[nt][3] * inv_hi);\n"
     "    }\n    if (threadIdx.x == 0) st[4] = stamp();\n    return;"),
    ("  if (!*last_flag) return;\n",
     "  if (threadIdx.x == 0) st[3] = stamp();\n"
     "  if (!*last_flag) {\n"
     "    if (threadIdx.x == 0) st[4] = stamp();\n    return;\n  }\n"),
    ("pack_bf16(acc[u].z * r, acc[u].w * r));\n      }\n    }\n  }\n}",
     "pack_bf16(acc[u].z * r, acc[u].w * r));\n      }\n    }\n  }\n"
     "  if (threadIdx.x == 0) st[4] = stamp() | (1ull << 63);\n}"),
    ("    lsum[i * max_splits + k] = __ldcg(ws_l + hrow);\n  }\n"
     "  __syncwarp();\n",
     "    lsum[i * max_splits + k] = __ldcg(ws_l + hrow);\n  }\n"
     "  __syncwarp();\n  if (threadIdx.x == 0) st[5] = stamp();\n"),
    ("    inv[lane] = 1.f / fmaxf(l, 1e-20f);\n  }\n  __syncwarp();\n",
     "    inv[lane] = 1.f / fmaxf(l, 1e-20f);\n  }\n  __syncwarp();\n"
     "  if (threadIdx.x == 0) st[6] = stamp();\n"),
    ("int dpt_flash_span(",
     "int dpt_set_stamps(void* p) {\n"
     "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n\n"
     "int dpt_flash_span("),
]


def build(name: str, edits) -> ctypes.CDLL:
    """A copy of the kernel's source with ``edits`` (each anchor must be
    found), compiled with the library's flags and loaded; the compiler's
    register report is printed."""
    with open(SRC) as f:
        text = f.read()
    for anchor, replacement in edits:
        if anchor not in text:
            raise RuntimeError(f"{name}: anchor not in {SRC}: {anchor!r}")
        text = text.replace(anchor, replacement)
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"span_{name}.cu")
    so = os.path.join(OUT, f"span_{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    r = subprocess.run([_build._nvcc(), *_build._FLAGS, "-I",
                        os.path.dirname(SRC), "-shared", "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    regs = [line.strip() for line in (r.stdout + r.stderr).splitlines()
            if "registers" in line or "spill" in line]
    print(f"# build {name}: {regs}", flush=True)
    lib = ctypes.CDLL(so)
    argtypes, restype = _build._SIGNATURES["dpt_flash_span"]
    lib.dpt_flash_span.argtypes = argtypes
    lib.dpt_flash_span.restype = restype
    return lib


def launch(lib, args, plan) -> torch.Tensor:
    """``flash_span``'s launch through ``lib`` under ``plan``."""
    q, pk, pv, bt, pos = args[:5]
    sk, sv = args[5:] if len(args) > 5 else (None, None)
    B, H, L, Dh = q.shape
    out = torch.empty_like(q)
    ws_acc = torch.empty((B, plan.max_splits, L, H, Dh), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((2, B, plan.max_splits, L, H), dtype=torch.float32,
                        device=q.device)
    tickets = fd._ticket_buffer(q.device, B * plan.groups * plan.link_tiles)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.dpt_flash_span(
        ptr(q), ptr(pk), ptr(pv), ptr(sk), ptr(sv), ptr(bt), ptr(pos),
        ptr(out), ptr(ws_acc), ptr(ws_ml), ptr(tickets), B, H, L, Dh,
        pk.shape[1], bt.shape[1], plan.group_heads, plan.stages,
        plan.pages_per_chunk, plan.max_splits, int(sk is not None),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def timeline(lib, args, plan, flush) -> dict:
    """One launch after a clean L2 flush, stamped per CTA."""
    B = args[0].shape[0]
    stamps = torch.zeros((B * plan.max_splits * plan.groups
                          * plan.link_tiles, 8), dtype=torch.int64,
                         device="cuda")
    if lib.dpt_set_stamps(ctypes.c_void_p(stamps.data_ptr())):
        raise RuntimeError("could not set the stamp buffer")
    for _ in range(3):
        launch(lib, args, plan)
    flush.max()
    stamps.zero_()
    torch.cuda.synchronize()
    launch(lib, args, plan)
    torch.cuda.synchronize()
    d = stamps.cpu()
    combined = d[:, 4] < 0
    end = d[:, 4] & ((1 << 63) - 1)
    live = d[:, 1] > 0
    multi = live & (d[:, 3] > 0)
    t0 = int(d[:, 0][d[:, 0] > 0].min())

    def med(a, b, rows=live):
        return statistics.median(((d[rows, b] - d[rows, a]) / 1e3).tolist()
                                 or [0.0])

    per_sm = collections.Counter(d[live, 7].tolist())
    return {
        "ctas": int(d.shape[0]), "live_ctas": int(live.sum()),
        "last_end_us": (int(end.max()) - t0) / 1e3,
        "first_start_to_last_start_us": (int(d[live, 0].max()) - t0) / 1e3,
        "start_to_first_arrival_us": med(0, 1),
        "first_arrival_to_fold_done_us": med(1, 2),
        "fold_done_to_ticket_us": med(2, 3, multi),
        "combine_us": statistics.median(
            ((end[combined] - d[combined, 3]) / 1e3).tolist() or [0.0]),
        "combine_ml_loads_us": med(3, 5, combined),
        "combine_weights_us": med(5, 6, combined),
        "combine_sums_us": statistics.median(
            ((end[combined] - d[combined, 6]) / 1e3).tolist() or [0.0]),
        "sms_by_live_ctas": dict(collections.Counter(per_sm.values())),
    }


def span_args(case, q, pos, int8: bool) -> tuple:
    if int8:
        return (q, case["k8"], case["v8"], case["table"], pos, case["sk"],
                case["sv"])
    return (q, case["pk"].to(torch.bfloat16), case["pv"].to(torch.bfloat16),
            case["table"], pos)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_span: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    B, n, L, H, Dh, ps = 32, 64, 5, 12, 64, 16
    starts = {"main": [0, 12, 1019, 1022] + [256 + 5 * i
                                             for i in range(B - 4)],
              "serve": [264] * B}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    libs = {"base": build("base", [])}
    libs.update({name: build(name, edits)
                 for name, edits in ABLATIONS.items()})
    libs["timeline"] = build("timeline", TIMELINE)
    libs["timeline"].dpt_set_stamps.argtypes = [ctypes.c_void_p]
    result = {"card": card, "plans": {}, "ablations": {}, "timeline": {}}
    for case_name, idx in starts.items():
        case = cs.decode_case(torch, B, n, idx, seed=4)
        g = torch.Generator(device=dev).manual_seed(5)
        q = torch.randn((B, H, L, Dh), generator=g, device=dev).to(
            torch.bfloat16)
        pos = torch.clamp(case["positions"][:, None] + torch.arange(
            L, dtype=torch.int32, device=dev)[None, :], max=n * ps - 1)
        for int8 in (False, True):
            kind = "int8" if int8 else "bf16"
            kb = 1 if int8 else 2
            args = span_args(case, q, pos, int8)
            plan = fd.span_plan(B, L, H, Dh, ps, n, kb,
                                *fd.device_limits(dev))
            ref = fd.flash_span(*args)
            key = f"{case_name} {kind}"
            for lib, ppc, stages in [(lib, ppc, stages)
                                     for lib in ("base", "minblocks2")
                                     for ppc, stages in ((2, 2), (4, 2),
                                                         (4, 3), (4, 4),
                                                         (8, 2), (8, 3),
                                                         (8, 4), (16, 2))]:
                smem = fd._span_smem_bytes(stages, ps, H, Dh, kb)
                tile = fd._span_tile_bytes(ps, H, Dh, kb)
                if smem > fd.device_limits(dev)[1] or H * (
                        32 * -(-n // ppc) + 16) * 4 > stages * 2 * tile:
                    continue          # no room, or none for the combine
                p = plan._replace(pages_per_chunk=ppc,
                                  max_splits=-(-n // ppc), stages=stages,
                                  smem_bytes=smem)
                out = launch(libs[lib], args, p)
                err = float((out.float() - ref.float()).abs().max())
                ms = [cs.device_ms(lambda: launch(libs[lib], args, p),
                                   torch, flush, clean_l2=True)[0]
                      for _ in range(2)]
                name = f"{key} {lib} ppc{ppc} stages{stages}"
                result["plans"][name] = {"ms": ms,
                                         "max_abs_diff_vs_plan": err}
                print(f"# plan {name}: {result['plans'][name]}", flush=True)
            for name in ("base", *ABLATIONS):
                result["ablations"][f"{key} {name}"] = [
                    cs.device_ms(lambda: launch(libs[name], args, plan),
                                 torch, flush, clean_l2=True)[0]
                    for _ in range(2)]
            result["timeline"][key] = timeline(libs["timeline"], args, plan,
                                               flush)
            bound = cs.span_bound(fd, case["table"], pos, ps, H, Dh,
                                  3.35e12, 989e12, quantized=int8)
            result["timeline"][key]["bound_ms"] = bound["bound_ms"]
            ablations = {k: v for k, v in result["ablations"].items()
                         if k.startswith(key)}
            print(f"# {key}: plan {tuple(plan)}; bound "
                  f"{bound['bound_ms']:.6f} ms; ablations {ablations}; "
                  f"timeline {result['timeline'][key]}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
