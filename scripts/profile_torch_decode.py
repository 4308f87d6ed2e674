#!/usr/bin/env python3
"""Where the flash-decode kernel's time goes, on one GPU.

    python3 scripts/profile_torch_decode.py

At the decode phase's shapes of ``chip_smoke.py`` (32 slots, H=12, Dh=64,
page 16, 64-page reservations; "main": that phase's positions, "serve":
every slot at depth 264, as in its serve run), bf16 q over bf16 and int8
pools, device time by ``torch.profiler`` after a clean L2 flush:

1. plans: the kernel under other (pages_per_chunk, stages) than
   ``decode_plan`` picks, two turns each;
2. ablations: copies of ``ops/csrc/flash_decode.cu`` built beside the real
   library with the fold removed ("nofold": the pages are still copied,
   nothing is computed) or the combine removed ("nocombine");
3. timeline: a copy that stamps ``%globaltimer`` and ``%smid`` per CTA
   (start, first copy issued, first and last page arrived, fold done,
   ticket taken, end); prints per-phase medians over the live CTAs, the
   combine's duration, when the last CTA ended, and how many SMs ran one
   or two live CTAs. Beside it, ``torch.sum`` over the same number of
   bytes, a streaming yardstick.

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
                   "flash_decode.cu")
OUT = os.path.join(ROOT, "distributed_pipeline_tpu_torch", "ops", "_build",
                   "profile")

ABLATIONS = {
    "nofold": [("for (int rb = 0; rb < valid; rb += RPP * NP) {",
                "for (int rb = 0; rb < (valid & 0); rb += RPP * NP) {")],
    "nocombine": [("  if (!*last_flag) return;", "  return;")],
}

# %globaltimer stamps, slot by slot: 0 start, 1 first copy issued, 2 first
# page arrived, 3 last page arrived, 4 fold done, 5 ticket taken, 6 end
# (top bit set on the CTA that combined), 7 SM id
TIMELINE = [
    ("namespace {\n", """namespace {
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long stamp() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""),
    ("  int my_page = 0;\n", """  unsigned long long* st = g_stamps + 8 * (blockIdx.x + (long long)gridDim.x
      * (blockIdx.y + (long long)gridDim.y * blockIdx.z));
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    st[0] = stamp();
    st[7] = sm;
  }
  int my_page = 0;
"""),
    ("  if (chunk >= n_chunks) return;",
     "  if (chunk >= n_chunks) { if (threadIdx.x == 0) st[6] = stamp(); "
     "return; }"),
    ("            bulk_load(dv, src_v, (uint32_t)tile, &full[s]);\n",
     "            bulk_load(dv, src_v, (uint32_t)tile, &full[s]);\n"
     "            if (j == 0) st[1] = stamp();\n"),
    ("    mbar_wait(&full[s], (j / stages) & 1);\n",
     "    mbar_wait(&full[s], (j / stages) & 1);\n"
     "    if (warp == 0 && lane == 0) { if (j == 0) st[2] = stamp(); "
     "if (j == count - 1) st[3] = stamp(); }\n"),
    ("  // each lane holds the sums over its own rows",
     "  if (warp == 0 && lane == 0) st[4] = stamp();\n"
     "  // each lane holds the sums over its own rows"),
    ("orow[e] = from_f32<T>(acc[e] * inv);\n    }\n    return;",
     "orow[e] = from_f32<T>(acc[e] * inv);\n    }\n"
     "    if (warp == 0 && lane == 0) { st[5] = st[4]; st[6] = stamp(); }\n"
     "    return;"),
    ("  if (!*last_flag) return;",
     "  if (threadIdx.x == 0) st[5] = stamp();\n"
     "  if (!*last_flag) { if (threadIdx.x == 0) st[6] = stamp(); return; }"),
    ("    orow[3] = from_f32<T>(o.w * inv);\n  }\n}",
     "    orow[3] = from_f32<T>(o.w * inv);\n  }\n"
     "  if (threadIdx.x == 0) st[6] = stamp() | (1ull << 63);\n}"),
    ("const char* dpt_error_string(int err) {",
     "int dpt_set_stamps(void* p) {\n"
     "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n\n"
     "const char* dpt_error_string(int err) {"),
]


def build(name: str, edits) -> ctypes.CDLL:
    """A copy of the kernel's source with ``edits`` (each anchor must be
    found), compiled with the library's flags and loaded."""
    with open(SRC) as f:
        text = f.read()
    for anchor, replacement in edits:
        if anchor not in text:
            raise RuntimeError(f"{name}: anchor not in {SRC}: {anchor!r}")
        text = text.replace(anchor, replacement)
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"decode_{name}.cu")
    so = os.path.join(OUT, f"decode_{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    r = subprocess.run([_build._nvcc(), *_build._FLAGS, "-I",
                        os.path.dirname(SRC), "-shared", "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    argtypes, restype = _build._SIGNATURES["dpt_flash_decode"]
    lib.dpt_flash_decode.argtypes = argtypes
    lib.dpt_flash_decode.restype = restype
    return lib


def launch(lib, args, plan) -> torch.Tensor:
    """``flash_decode``'s launch through ``lib`` under ``plan``."""
    q, pk, pv, bt, pos = args[:5]
    sk, sv = args[5:] if len(args) > 5 else (None, None)
    B, H, Dh = q.shape
    out = torch.empty_like(q)
    ws_acc = torch.empty((B, plan.max_splits, H, Dh), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((2, B, plan.max_splits, H), dtype=torch.float32,
                        device=q.device)
    tickets = fd._ticket_buffer(q.device, B * plan.groups)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.dpt_flash_decode(
        ptr(q), ptr(pk), ptr(pv), ptr(sk), ptr(sv), ptr(bt), ptr(pos),
        ptr(out), ptr(ws_acc), ptr(ws_ml), ptr(tickets), B, H, Dh,
        pk.shape[1], bt.shape[1], plan.group_heads, plan.stages,
        plan.pages_per_chunk, plan.max_splits, fd._DTYPE_CODES[q.dtype],
        int(sk is not None), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def with_plan(plan, n: int, ppc: int, stages: int, kv_bytes: int):
    return plan._replace(
        pages_per_chunk=ppc, max_splits=-(-n // ppc), stages=stages,
        smem_bytes=fd._smem_bytes(stages, 16, plan.group_heads, 64,
                                  kv_bytes))


def timeline(lib, args, plan, flush) -> dict:
    """One launch after a clean L2 flush, stamped per CTA."""
    B = args[0].shape[0]
    stamps = torch.zeros((B * plan.max_splits * plan.groups, 8),
                         dtype=torch.int64, device="cuda")
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
    combined = d[:, 6] < 0
    end = d[:, 6] & ((1 << 63) - 1)
    live = d[:, 1] > 0
    t0 = int(d[:, 0][d[:, 0] > 0].min())

    def med(a, b):
        return statistics.median(((d[live, b] - d[live, a]) / 1e3).tolist())

    per_sm = collections.Counter(d[live, 7].tolist())
    return {
        "ctas": int(d.shape[0]), "live_ctas": int(live.sum()),
        "last_end_us": (int(end.max()) - t0) / 1e3,
        "start_to_first_issue_us": med(0, 1),
        "first_issue_to_first_arrival_us": med(1, 2),
        "first_to_last_arrival_us": med(2, 3),
        "last_arrival_to_fold_done_us": med(3, 4),
        "fold_done_to_ticket_us": med(4, 5),
        "combine_us": statistics.median(
            ((end[combined] - d[combined, 5]) / 1e3).tolist() or [0.0]),
        "last_live_starts_us": sorted(
            (int(x) - t0) / 1e3 for x in d[live, 0].tolist())[-3:],
        "sms_by_live_ctas": dict(collections.Counter(per_sm.values())),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_decode: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    n = 64
    cases = {
        "main": cs.decode_case(torch, 32, n, [-1, 0, 15, 16, 31, 255, 256,
                                              1023]
                               + [256 + 5 * i for i in range(24)], seed=0),
        "serve": cs.decode_case(torch, 32, n, [264] * 32, seed=3),
    }
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    libs = {"base": build("base", [])}
    libs.update({name: build(name, edits)
                 for name, edits in ABLATIONS.items()})
    libs["timeline"] = build("timeline", TIMELINE)
    libs["timeline"].dpt_set_stamps.argtypes = [ctypes.c_void_p]
    result = {"card": card, "plans": {}, "ablations": {}, "timeline": {},
              "torch_sum_ms": {}}
    for case_name, case in cases.items():
        for int8 in (False, True):
            kind = "int8" if int8 else "bf16"
            kb = 1 if int8 else 2
            args = cs.decode_args(case, torch.bfloat16, int8)
            plan = fd.decode_plan(32, 12, 64, 16, n, kb,
                                  *fd.device_limits(torch.device("cuda")))
            ref = fd.flash_decode(*args)
            key = f"{case_name} {kind}"
            for ppc, stages in ((plan.pages_per_chunk, plan.stages), (2, 2),
                                (3, 3), (4, 2), (4, 4), (6, 3), (8, 2),
                                (8, 4)):
                p = with_plan(plan, n, ppc, stages, kb)
                if p.smem_bytes > fd.device_limits(torch.device("cuda"))[1]:
                    continue
                out = launch(libs["base"], args, p)
                err = float((out.float() - ref.float()).abs().max())
                ms = [cs.device_ms(lambda: launch(libs["base"], args, p),
                                   torch, flush, clean_l2=True)[0]
                      for _ in range(2)]
                result["plans"][f"{key} ppc{ppc} stages{stages}"] = {
                    "ms": ms, "max_abs_diff_vs_plan": err}
            for name in ("base", *ABLATIONS):
                result["ablations"][f"{key} {name}"] = [
                    cs.device_ms(lambda: launch(libs[name], args, plan),
                                 torch, flush, clean_l2=True)[0]
                    for _ in range(2)]
            result["timeline"][key] = timeline(libs["timeline"], args, plan,
                                               flush)
            ablations = {k: v for k, v in result["ablations"].items()
                         if k.startswith(key)}
            print(f"# {key}: plan {tuple(plan)}; ablations {ablations}; "
                  f"timeline {result['timeline'][key]}", flush=True)
    for name, nbytes in (("bf16 pages", 28854696), ("int8 pages", 14482424)):
        x = torch.ones(nbytes // 2, dtype=torch.bfloat16, device="cuda")
        result["torch_sum_ms"][name] = cs.device_ms(
            lambda: x.sum(), torch, flush, clean_l2=True)[0]
    for key, row in result["plans"].items():
        print(f"# plan {key}: {row}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
