"""The training tooling end to end through the supervised ring, on the CPU.

``python -m distributed_pipeline_tpu_torch.run.train --distributed
--nprocs N --device cpu`` as real worker processes under the launcher
(the port of ``tests/test_chaos.py``'s end-to-end ring):

* a chaos ring with ``corrupt_checkpoint`` + ``kill`` at step 4 of 6 walks
  back to step 2, resumes in the same run dir, finishes, accounts for
  every second, and ends bitwise equal to an uninterrupted ring;
* a ring wedged by ``stall_step`` is killed by the hang watchdog (its
  record ``hung``), resumed and finished, while
  ``--hang_startup_timeout_s`` leaves the healthy attempt alone;
* two gloo ranks with every tool armed: the ledger's collective term is
  the gradient all-reduce (4 bytes a parameter), each rank beacons,
  traces and writes its sanitizer report.

DiffuSeq at 1 layer, D=32, H=2, V=64, seq_len 16, f32, batch 4 in
microbatches of 2 a rank.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from distributed_pipeline_tpu_torch.chaos import aggregate_run, read_attempts
from distributed_pipeline_tpu_torch.obs import ledger as ledger_lib
from distributed_pipeline_tpu_torch.obs import trace as trace_lib
from distributed_pipeline_tpu_torch.parallel import launcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", launcher.AUTORUN_ENV_FLAG,
            launcher.RUN_TIMESTAMP_ENV, "DPT_CHAOS_PLAN", "DPT_TRACE",
            "DPT_ATTEMPT", "DPT_SPAWN_T", "DPT_RUN_DIR_FILE")
BASE = ["--device", "cpu", "--seq_len", "16", "--vocab_size", "64",
        "--hidden_size", "32", "--num_layers", "1", "--num_heads", "2",
        "--dtype", "float32", "--diffusion_steps", "50", "--batch_size", "4",
        "--microbatch", "2", "--data_loader_workers", "0",
        "--prefetch_depth", "0"]
ARGV = BASE + ["--learning_steps", "6", "--save_interval", "2",
               "--log_interval", "1000"]


def _ring(cwd, *argv, plan=None, timeout=120.0) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = REPO
    if plan is not None:
        env["DPT_CHAOS_PLAN"] = json.dumps({"faults": plan})
    os.makedirs(cwd, exist_ok=True)
    return subprocess.run(
        [sys.executable, "-m", "distributed_pipeline_tpu_torch.run.train",
         "--distributed", *argv], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout)


def _run_dir(cwd):
    runs = os.listdir(os.path.join(cwd, "model_checkpoints"))
    assert len(runs) == 1, runs
    return os.path.join(cwd, "model_checkpoints", runs[0])


def _params(run_dir, step):
    return torch.load(os.path.join(run_dir, f"model_{step:06d}.pt"),
                      weights_only=True)


def test_chaos_ring_walks_back_and_ends_bitwise(tmp_path):
    """corrupt + kill at step 4 of 6 under ``--max_restarts 3``: one run
    dir (the pinned timestamp), attempts ``(-9, end 4)`` and ``(0, end
    6)``, both markers, the walk-back to step 2, recompute booked, every
    second accounted, and the step-6 parameters (and EMA, and moments)
    bitwise an uninterrupted ring's."""
    chaos = str(tmp_path / "chaos")
    out = _ring(chaos, "--nprocs", "1", "--max_restarts", "3",
                "--restart_backoff_s", "0.1", *ARGV,
                plan=[{"kind": "corrupt_checkpoint", "step": 4, "rank": 0},
                      {"kind": "kill", "step": 4, "rank": 0}])
    assert out.returncode == 0, out.stderr[-3000:]
    run = _run_dir(chaos)
    recs = read_attempts(run)
    assert [(r["rc"], r["end_step"]) for r in recs] == \
        [(-signal.SIGKILL, 4), (0, 6)]
    assert recs[1]["start_step"] == 2 and recs[1]["steps"] == 4
    assert recs[1]["resume_overhead_s"] > 0
    assert all(os.path.exists(os.path.join(run, f".chaos_fired_0{i}"))
               for i in (0, 1))
    log = open(os.path.join(run, "log.txt")).read()
    assert "walking back" in log and "resumed from step 2" in log
    agg = aggregate_run(run)
    assert agg["attempts"] == 2 and agg["goodput"] > 0
    assert agg["recompute_s"] > 0 and agg["startup_s"] > 0
    assert agg["accounted_frac"] == pytest.approx(1.0, abs=0.05)
    assert [a["goodput_source"] for a in agg["per_attempt"]] == \
        ["beacon", "sidecar"]

    clean = str(tmp_path / "clean")
    out = _ring(clean, "--nprocs", "1", *ARGV)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = _run_dir(clean)
    assert [r["rc"] for r in read_attempts(ref)] == [0]
    for name in ("model_000006.pt", "ema_0.99_000006.pt"):
        a = torch.load(os.path.join(run, name), weights_only=True)
        b = torch.load(os.path.join(ref, name), weights_only=True)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    a, b = (torch.load(os.path.join(d, "opt_000006.pt"), weights_only=True)
            for d in (run, ref))
    assert a["count"] == b["count"] == 6
    for k in a["nu"]:
        assert torch.equal(a["mu"][k], b["mu"][k])
        assert torch.equal(a["nu"][k], b["nu"][k])


def test_hang_watchdog_kills_a_wedged_ring(tmp_path):
    """``stall_step`` wedges attempt 0 at step 3 for 600 s: its beacon
    freezes, the watchdog kills it after ``--hang_timeout_s 3``, and
    attempt 1 resumes from step 2 and finishes; the startup timeout never
    fires on the healthy attempt."""
    cwd = str(tmp_path / "hang")
    out = _ring(cwd, "--nprocs", "1", "--max_restarts", "2",
                "--restart_backoff_s", "0.1", "--hang_timeout_s", "3",
                "--hang_startup_timeout_s", "60", "--monitor_interval",
                "0.1", *ARGV,
                plan=[{"kind": "stall_step", "step": 3, "seconds": 600}])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "hang watchdog" in out.stderr
    run = _run_dir(cwd)
    recs = read_attempts(run)
    assert len(recs) == 2
    assert recs[0]["hung"] is True and recs[0]["hang_kind"] == "stall"
    assert 3.0 <= recs[0]["hang_s"] < 10.0
    assert recs[0]["end_step"] == 3 and recs[0]["goodput"]["wall_s"] > 0
    assert recs[1]["rc"] == 0 and recs[1]["end_step"] == 6
    assert "hung" not in recs[1]
    agg = aggregate_run(run)
    assert agg["hang_s"] == recs[0]["hang_s"]
    assert agg["accounted_frac"] == pytest.approx(1.0, abs=0.05)


def test_two_ranks_with_every_tool(tmp_path):
    """Two gloo ranks, ``--trace --cost_ledger --sanitize``: the ledger's
    ``collective_bytes_per_step`` is 4 bytes a parameter, its gaps sum to
    1; each rank beacons, traces its steps and writes an empty sanitizer
    report; rank 0 writes the goodput record."""
    cwd = str(tmp_path / "two")
    out = _ring(cwd, "--nprocs", "2", *BASE, "--learning_steps", "4",
                "--save_interval", "4", "--log_interval", "2",
                "--trace", "true", "--cost_ledger", "true",
                "--sanitize", "true")
    assert out.returncode == 0, out.stderr[-3000:]
    run = _run_dir(cwd)
    n = sum(t.numel() for t in _params(run, 4).values())
    row = ledger_lib.read_ledger(run)["programs"]["train_step"]
    assert row["collective_bytes_per_step"] == 4.0 * n
    assert abs(ledger_lib.gap_sum_identity(row) - 1.0) <= 1e-9
    for r in (0, 1):
        beacon = json.load(open(os.path.join(run,
                                             f".progress_rank{r}.json")))
        assert (beacon["rank"], beacon["step"]) == (r, 4)
        events = trace_lib.read_trace(trace_lib.trace_path(run, r))
        assert [e["args"]["step"] for e in events
                if e["name"] == "step"] == [1, 2, 3, 4]
        report = os.path.join(run, "" if r == 0 else f"rank{r:03d}",
                              "sanitize_report.json")
        assert json.load(open(report))["violations"] == []
    assert os.path.exists(os.path.join(run, "goodput_attempt000.json"))
    assert not os.path.exists(os.path.join(run, "goodput_attempt001.json"))
