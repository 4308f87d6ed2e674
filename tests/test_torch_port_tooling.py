"""The port's training tooling against the JAX package's, on the CPU.

* The goodput fold (``chaos/goodput.py``: ``aggregate_run``,
  ``beacon_max_step``, ``read_goodput_records``) gives the JAX functions'
  dicts on the same synthetic run dirs, and ``GoodputTracker`` /
  ``StallBreakdown`` the JAX classes' summaries for the same calls.
* The training faults (``chaos/inject.py``): a kill fires once and leaves
  its marker, rank gating, ``stall_data`` lands in ``data_wait_s``,
  ``crash_in_save`` leaves a torn step that resume skips,
  ``corrupt_newest_checkpoint`` garbles the newest finalized step's model
  file and leaves its meta.
* Resume with walk-back (``utils/checkpoint.restore_resume_state``): past
  a corrupt newest checkpoint to the older step's exact state, a
  ``RuntimeError`` when every step is corrupt, no walk-back from an
  explicit checkpoint, corrupt companions degraded.
* ``TrainLoop``'s records (the JAX key sets of the beacon and the goodput
  record, every second accounted, recompute), spans, the profiler window,
  the ``train_step`` ledger row and the sanitizer's report.

DiffuSeq at 1 layer, D=32, H=2, V=64, seq_len 16, 50 diffusion steps, f32,
batch 4 in microbatches of 2 (GPT-2 at the same widths for the JAX key
sets). The rings through the launcher are in
``tests/test_torch_port_tooling_ring.py``.
"""

import json
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from distributed_pipeline_tpu.analysis import cli as jax_cli
from distributed_pipeline_tpu.chaos import goodput as jax_goodput
from distributed_pipeline_tpu.utils import perf as jax_perf
from distributed_pipeline_tpu_torch.chaos import (ChaosInjector, ChaosPlan,
                                                  corrupt_newest_checkpoint)
from distributed_pipeline_tpu_torch.chaos import goodput as port_goodput
from distributed_pipeline_tpu_torch.data import load_data_from_args
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.obs import ledger as ledger_lib
from distributed_pipeline_tpu_torch.obs import trace as trace_lib
from distributed_pipeline_tpu_torch.run import train as train_mod
from distributed_pipeline_tpu_torch.utils import checkpoint as ckpt
from distributed_pipeline_tpu_torch.utils import perf as port_perf
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop

TINY = dict(model_family="diffuseq", vocab_size=64, seq_len=16,
            hidden_size=32, num_layers=1, num_heads=2, diffusion_steps=50,
            dtype="float32")
CATS = ("startup_s", "setup_s", "restore_s", "compile_s", "save_s",
        "data_stall_s", "recompute_s")


def tiny_loop(run_dir, **kw) -> TrainLoop:
    model = create_model_from_config(**TINY, device=torch.device("cpu"))
    data = load_data_from_args("train", batch_size=4,
                               dataset="synthetic-seq2seq", seq_len=16,
                               vocab_size=64, seed=0, data_loader_workers=0)
    kw.setdefault("learning_steps", 3)
    kw.setdefault("log_interval", 10 ** 9)
    kw.setdefault("save_interval", 10 ** 9)
    return TrainLoop(model=model, data=data, batch_size=4, microbatch=2,
                     lr=1e-3, ema_rate="0.9,0.99",
                     checkpoint_dir=str(run_dir), seed=0, **kw)


def steps(loop, n):
    for _ in range(n):
        loop.run_step(loop.next_batch())


# -------------------------------------------------------------- the fold

GP = {"wall_s": 10.0, "useful_step_s": 7.0, "goodput": 0.7,
      "startup_s": 1.0, "setup_s": 0.5, "restore_s": 0.2, "compile_s": 1.0,
      "save_s": 0.2, "data_stall_s": 0.1, "recompute_s": 0.0}


def _attempt(idx, rc, t0, dur, downtime=0.0, **extra):
    return {"attempt": idx, "rc": rc, "t_spawn": t0, "t_exit": t0 + dur,
            "duration_s": dur, "downtime_s": downtime, **extra}


def _write(path, payload):
    with open(path, "w") as f:
        f.write(payload if isinstance(payload, str) else json.dumps(payload))


def _synthetic_run(d, case):
    """One of the run dirs the fold must read as the JAX fold does."""
    os.makedirs(d)
    recs = []
    if case == "two_clean":
        recs = [_attempt(0, 0, 100.0, 12.0, steps=5, goodput=GP),
                _attempt(1, 0, 113.0, 11.0, 1.0, steps=5, goodput=None)]
        for i, wall in ((0, 11.5), (1, 10.5)):
            _write(os.path.join(d, f"goodput_attempt{i:03d}.json"),
                   {**GP, "attempt": i, "wall_s": wall,
                    "useful_step_s": wall - 3.0, "steps": [0, 5]})
        _write(os.path.join(d, ".progress_rank0.json"),
               {"step": 10, "attempt": 1, "goodput": GP})
    elif case == "killed_beacon_only":
        recs = [_attempt(0, -9, 100.0, 12.0, steps=5, goodput=GP,
                         end_step=4),
                _attempt(1, 0, 113.0, 11.0, 1.0, steps=2, goodput=None)]
        _write(os.path.join(d, "goodput_attempt001.json"),
               {**GP, "attempt": 1, "useful_step_s": 7.5, "wall_s": 10.5})
        _write(os.path.join(d, ".progress_rank0.json"),
               {"step": 6, "attempt": 1})
        _write(os.path.join(d, ".progress_rank1.json"),
               {"step": 4, "attempt": 0})
    elif case == "zero_byte_beacon":
        recs = [_attempt(0, -9, 100.0, 5.0, steps=None, goodput=None,
                         duration_s=None),
                _attempt(1, 0, 106.0, 4.0, 1.0, goodput={**GP,
                                                        "compile_s": None})]
        _write(os.path.join(d, ".progress_rank0.json"), "")
        _write(os.path.join(d, ".progress_rank1.json"), {"step": 7})
        _write(os.path.join(d, "goodput_attempt003.json"), "")
    elif case == "hung":
        recs = [_attempt(0, -9, 100.0, 30.0, steps=3, goodput=GP,
                         hung=True, hang_s=20.0, hang_kind="stall"),
                _attempt(1, 0, 131.0, 9.0, 1.0, steps=3, goodput=GP)]
        _write(os.path.join(d, ".progress_rank0.json"),
               {"step": 6, "attempt": 1, "goodput": GP})
    elif case == "serving_in_dir":
        recs = [_attempt(0, 0, 100.0, 8.0,
                         serving={"wall_s": 7.0, "serving_s": 6.0}),
                _attempt(1, 0, 109.0, 10.0, 1.0, goodput=GP)]
        _write(os.path.join(d, "serving_attempt000.json"),
               {"attempt": 0, "wall_s": 7.5, "serving_s": 6.5})
    elif case == "sidecars_only":
        for i in (0, 2):
            _write(os.path.join(d, f"goodput_attempt{i:03d}.json"),
                   {**GP, "attempt": i})
    # "empty": nothing at all
    if recs:
        _write(os.path.join(d, "attempts.jsonl"),
               "".join(json.dumps(r) + "\n" for r in recs))


FOLD_CASES = ("two_clean", "killed_beacon_only", "zero_byte_beacon", "hung",
              "serving_in_dir", "sidecars_only", "empty")


@pytest.mark.parametrize("case", FOLD_CASES)
def test_fold_equals_jax(tmp_path, case):
    """``aggregate_run``, ``beacon_max_step`` and ``read_goodput_records``
    equal the JAX functions' on the same run dir (the JAX module is
    jax-free, so the comparison is exact)."""
    d = str(tmp_path / case)
    _synthetic_run(d, case)
    ours = port_goodput.aggregate_run(d)
    theirs = jax_goodput.aggregate_run(d)
    assert ours == theirs
    assert port_goodput.beacon_max_step(d) == jax_goodput.beacon_max_step(d)
    assert (port_goodput.read_goodput_records(d)
            == jax_goodput.read_goodput_records(d))
    assert (port_goodput.goodput_record_path(d, 3)
            == jax_goodput.goodput_record_path(d, 3))
    if case == "hung":
        assert ours["hang_s"] == 20.0
    if case in ("two_clean", "hung", "killed_beacon_only"):
        assert ours["accounted_frac"] == pytest.approx(1.0, abs=0.05)


def test_trackers_equal_jax(monkeypatch):
    """``GoodputTracker`` and ``StallBreakdown`` give the JAX classes'
    summaries for the same calls with a fixed ``t0`` and clock."""
    monkeypatch.setattr(time, "perf_counter", lambda: 1000.25)
    ours, theirs = (m.GoodputTracker(t0=990.0) for m in (port_perf,
                                                         jax_perf))
    os_, ts = port_perf.StallBreakdown(), jax_perf.StallBreakdown()
    assert ours.CATEGORIES == theirs.CATEGORIES
    assert os_.GAUGES == ts.GAUGES
    calls = [("startup_s", 0.5), ("restore_s", 0.01), ("compile_s", 0.02),
             ("save_s", -1.0), ("recompute_s", 0.3), ("setup_s", 0.125)]
    for t in (ours, theirs):
        t.base_s = 0.5
        for c, v in calls:
            t.add(c, v)
    for s in (os_, ts):
        for g, v in (("data_wait_s", 0.1), ("h2d_wait_s", 0.02),
                     ("dispatch_s", 0.3), ("data_wait_s", 0.05)):
            s.add(g, v)
    a = ours.summary(extra={"data_stall_s": 0.005})
    b = theirs.summary(extra={"data_stall_s": 0.005})
    assert set(a) == set(b)
    for k in a:
        assert a[k] == pytest.approx(b[k], abs=1e-12), k
    for fn in ("totals", "sums", "lap", "lap"):
        x, y = getattr(os_, fn)(), getattr(ts, fn)()
        assert x.keys() == y.keys()
        for k in x:
            assert x[k] == pytest.approx(y[k], abs=1e-12), (fn, k)


# ----------------------------------------------------------- the faults

def test_corrupt_newest_checkpoint_hits_newest_finalized(tmp_path):
    loop = tiny_loop(tmp_path)
    steps(loop, 1)
    loop.save()
    steps(loop, 1)
    loop.save()
    # a torn step 3: its model file, no meta (commit marker)
    torch.save({}, tmp_path / "model_000003.pt")
    victim = corrupt_newest_checkpoint(str(tmp_path))
    assert victim == os.path.join(str(tmp_path), "model_000002.pt")
    assert (tmp_path / "meta_000002.json").exists()
    with pytest.raises(Exception):
        torch.load(victim, weights_only=True)
    torch.load(tmp_path / "model_000001.pt", weights_only=True)
    assert corrupt_newest_checkpoint(str(tmp_path / "nothing")) is None


def test_kill_fires_once_with_marker(tmp_path, monkeypatch):
    plan = ChaosPlan.parse('{"faults": [{"kind": "kill", "step": 1}]}')
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    loop = tiny_loop(tmp_path, chaos=ChaosInjector(plan, 0, str(tmp_path)))
    steps(loop, 3)      # the fault fires at the top of step 2 (step == 1)
    assert kills == [signal.SIGKILL]
    assert (tmp_path / ".chaos_fired_00").exists()
    # a fresh injector in the same run dir (the respawned attempt) sees
    # the marker and sails past the fault step
    again = tiny_loop(tmp_path, chaos=ChaosInjector(plan, 0, str(tmp_path)))
    steps(again, 2)
    assert kills == [signal.SIGKILL]


def test_kill_is_rank_gated(tmp_path, monkeypatch):
    plan = ChaosPlan.parse('{"faults": [{"kind": "kill", "step": 0, '
                           '"rank": 1}]}')
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    loop = tiny_loop(tmp_path, chaos=ChaosInjector(plan, 0, str(tmp_path)))
    steps(loop, 1)
    assert kills == [] and not (tmp_path / ".chaos_fired_00").exists()


def test_stall_data_lands_in_data_wait(tmp_path):
    plan = ChaosPlan.parse('{"faults": [{"kind": "stall_data", "step": 1, '
                           '"seconds": 0.3}]}')
    loop = tiny_loop(tmp_path, chaos=ChaosInjector(plan, 0, str(tmp_path)))
    steps(loop, 1)
    before = loop.stalls.sums()["data_wait_s"]
    steps(loop, 1)      # the stall fires pulling step 2's batch
    assert loop.stalls.sums()["data_wait_s"] - before >= 0.3
    assert loop.goodput_summary()["data_stall_s"] >= 0.3


def test_crash_in_save_leaves_a_torn_step_resume_skips(tmp_path,
                                                       monkeypatch):
    """``crash_in_save`` at step 2 (its SIGKILL intercepted): step 2's
    payload stays without its meta, and a fresh loop resumes at step 1."""
    plan = ChaosPlan.parse('{"faults": [{"kind": "crash_in_save", '
                           '"step": 2}]}')
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    loop = tiny_loop(tmp_path, chaos=ChaosInjector(plan, 0, str(tmp_path)))
    steps(loop, 1)
    loop.save()
    steps(loop, 1)
    loop.save()
    assert kills == [signal.SIGKILL]
    assert (tmp_path / "model_000002.pt").exists()
    assert not (tmp_path / "meta_000002.json").exists()
    assert ckpt.finalized_steps(str(tmp_path)) == [1]
    assert ckpt.prune_checkpoints(str(tmp_path), 1) == []
    assert tiny_loop(tmp_path).step == 1


# ------------------------------------------------------------ walk-back

def _saved_two(tmp_path):
    """A run dir with steps 2 and 4 (different states)."""
    loop = tiny_loop(tmp_path)
    steps(loop, 2)
    loop.save()
    steps(loop, 2)
    loop.save()
    return loop


def test_resume_walks_back_past_a_corrupt_newest(tmp_path):
    _saved_two(tmp_path)
    corrupt_newest_checkpoint(str(tmp_path))
    loop = tiny_loop(tmp_path)
    assert loop.step == 2 and loop.start_step == 2
    want = torch.load(tmp_path / "model_000002.pt", weights_only=True)
    for name, t in loop.state_dict_of(loop.params).items():
        assert torch.equal(t, want[name]), name
    ema = torch.load(tmp_path / "ema_0.99_000002.pt", weights_only=True)
    for name, t in loop.ema_state_dicts()["0.99"].items():
        assert torch.equal(t, ema[name]), name
    opt = torch.load(tmp_path / "opt_000002.pt", weights_only=True)
    assert int(loop.count) == opt["count"] == 2
    for name, t in loop.state_dict_of(loop.nu).items():
        assert torch.equal(t, opt["nu"][name]), name
    assert "walking back" in (tmp_path / "log.txt").read_text()
    assert loop.goodput.get("restore_s") > 0


def test_resume_raises_when_every_step_is_corrupt(tmp_path):
    _saved_two(tmp_path)
    for step in (2, 4):
        with open(tmp_path / f"model_{step:06d}.pt", "r+b") as f:
            f.write(b"garbage" * 8)
    with pytest.raises(RuntimeError, match="failed to restore"):
        tiny_loop(tmp_path)


def test_explicit_resume_never_walks_back(tmp_path):
    _saved_two(tmp_path)
    corrupt_newest_checkpoint(str(tmp_path))
    with pytest.raises(Exception) as e:
        tiny_loop(tmp_path / "other",
                  resume_checkpoint=str(tmp_path / "model_000004.pt"))
    assert "failed to restore" not in str(e.value)
    loop = tiny_loop(tmp_path / "other",
                     resume_checkpoint=str(tmp_path / "model_000002.pt"))
    assert loop.step == 2


def test_corrupt_companions_degrade(tmp_path):
    """A corrupt EMA companion is seeded from the parameters; a corrupt
    optimizer companion gives fresh moments."""
    _saved_two(tmp_path)
    for name in ("ema_0.9_000004.pt", "opt_000004.pt"):
        with open(tmp_path / name, "r+b") as f:
            f.write(b"garbage" * 8)
    loop = tiny_loop(tmp_path)
    assert loop.step == 4
    assert torch.equal(loop.ema[0], loop.params)
    assert not torch.equal(loop.ema[1], loop.params)
    assert int(loop.count) == 0 and not loop.mu.any() and not loop.nu.any()
    log = (tmp_path / "log.txt").read_text()
    assert "seeding from params" in log and "reinitializing" in log


# ------------------------------------------------------------- records

@pytest.fixture(scope="module")
def jax_record_keys(tmp_path_factory):
    """The key sets of the JAX ``TrainLoop``'s beacon, its ``goodput``
    snapshot and its goodput record."""
    from distributed_pipeline_tpu.data import \
        load_data_from_args as jax_data
    from distributed_pipeline_tpu.models import \
        create_model_from_config as jax_model
    from distributed_pipeline_tpu.parallel import make_mesh
    from distributed_pipeline_tpu.utils import logger
    from distributed_pipeline_tpu.utils.trainer import TrainLoop as JaxLoop
    d = tmp_path_factory.mktemp("jax_run")
    wl = jax_model(model_family="gpt2", vocab_size=64, seq_len=16,
                   hidden_size=32, num_layers=1, num_heads=2,
                   dtype="float32")
    data = jax_data("train", batch_size=8, dataset="synthetic-lm",
                    seq_len=16, vocab_size=64, seed=0)
    old = os.environ.get("DPT_ATTEMPT")
    os.environ["DPT_ATTEMPT"] = "2"
    try:
        loop = JaxLoop(model=wl, data=data, batch_size=8, lr=1e-3,
                       learning_steps=2, log_interval=10 ** 9,
                       save_interval=10 ** 9, mesh=make_mesh(dp=8),
                       checkpoint_dir=str(d), seed=0)
        with logger.scoped_configure(format_strs=[]):
            loop.run_loop()
    finally:
        if old is None:
            os.environ.pop("DPT_ATTEMPT")
        else:
            os.environ["DPT_ATTEMPT"] = old
    beacon = json.loads((d / ".progress_rank0.json").read_text())
    rec = json.loads((d / "goodput_attempt002.json").read_text())
    return set(beacon), set(beacon["goodput"]), set(rec)


def test_trainloop_writes_the_jax_records(tmp_path, monkeypatch,
                                          jax_record_keys):
    beacon_keys, goodput_keys, record_keys = jax_record_keys
    monkeypatch.setenv("DPT_ATTEMPT", "2")
    loop = tiny_loop(tmp_path)
    loop.run_loop()
    beacon = json.loads((tmp_path / ".progress_rank0.json").read_text())
    assert set(beacon) == beacon_keys
    assert set(beacon["goodput"]) == goodput_keys
    assert (beacon["step"], beacon["attempt"], beacon["start_step"]) == \
        (3, 2, 0)
    assert (beacon["recompile_count"],
            beacon["steady_recompile_count"]) == (0, 0)
    rec = json.loads((tmp_path / "goodput_attempt002.json").read_text())
    assert set(rec) == record_keys
    assert rec["steps"] == [0, 3]
    assert rec["wall_s"] >= rec["useful_step_s"] > 0
    assert rec["setup_s"] > 0 and rec["save_s"] > 0
    assert rec["compile_s"] == 0.0      # no kernel library on the CPU
    # every second accounted: useful + categories == wall
    assert rec["useful_step_s"] + sum(rec[c] for c in CATS) == \
        pytest.approx(rec["wall_s"], rel=1e-3)
    agg = port_goodput.aggregate_run(str(tmp_path))
    assert agg["attempts"] == 1
    assert agg["accounted_frac"] == pytest.approx(1.0, rel=1e-3)


def test_replayed_steps_book_recompute(tmp_path):
    loop = tiny_loop(tmp_path, learning_steps=4, recompute_until_step=2)
    steps(loop, 4)
    s = loop.goodput_summary()
    assert 0 < s["recompute_s"] < s["wall_s"]
    # no replay: nothing booked
    fresh = tiny_loop(tmp_path / "b", learning_steps=4)
    steps(fresh, 4)
    assert fresh.goodput_summary()["recompute_s"] == 0.0


def test_spans_match_the_goodput_boundaries(tmp_path, monkeypatch):
    """``DPT_TRACE`` arms the loop: step, save and restore spans in the
    rank's shard, the restore (and compile: none on the CPU) spans
    re-booking the goodput seconds, the step spans summing to the step
    slices (useful + recompute + data stall)."""
    monkeypatch.setenv(trace_lib.TRACE_ENV, "1")
    loop = tiny_loop(tmp_path, learning_steps=4, save_interval=2)
    assert loop.tracer.enabled
    loop.run_loop()
    by = {}
    for e in trace_lib.read_trace(trace_lib.trace_path(str(tmp_path), 0)):
        by.setdefault(e["name"], []).append(e)
    assert [e["args"]["step"] for e in by["step"]] == [1, 2, 3, 4]
    # each save's two parts: the copy and scheduling, then the wait for
    # its writer (before the next save, at exit)
    assert [(e["args"]["step"], e["args"].get("wait", False))
            for e in by["save"]] == [(2, False), (2, True), (4, False),
                                     (4, True)]
    assert sum(e["dur"] for e in by.get("compile", [])) == \
        loop.goodput.get("compile_s") == 0.0
    assert sum(e["dur"] for e in by["restore"]) == pytest.approx(
        loop.goodput.get("restore_s"))
    assert sum(e["dur"] for e in by["save"]) == pytest.approx(
        loop.goodput.get("save_s"))
    s = json.loads((tmp_path / "goodput_attempt000.json").read_text())
    spans = sum(e["dur"] for e in by["step"])
    assert spans == pytest.approx(
        s["useful_step_s"] + s["recompute_s"] + s["data_stall_s"], rel=0.05)
    # off by default: no shard
    monkeypatch.delenv(trace_lib.TRACE_ENV)
    quiet = tiny_loop(tmp_path / "q")
    assert quiet.tracer is trace_lib.NULL


# ------------------------------------------------------------ profiler

def test_profile_steps_window_parsing(tmp_path):
    assert tiny_loop(tmp_path / "a")._profile_window == (3, 8)
    assert tiny_loop(tmp_path / "b",
                     profile_steps="5:12")._profile_window == (5, 12)
    for bad in ("12:5", "nope"):
        with pytest.raises(ValueError, match="profile_steps"):
            tiny_loop(tmp_path / "c", profile_steps=bad)


def _trace_files(d):
    return [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]


@pytest.mark.parametrize("learning_steps", [6, 5])
def test_profile_dir_writes_a_trace(tmp_path, learning_steps):
    """A ``profile_dir`` run writes a Chrome trace over its window
    ``[2, 4)``; a run that ends inside the window (5 steps against
    ``[3, 8)``) still flushes it."""
    window = "2:4" if learning_steps == 6 else ""
    loop = tiny_loop(tmp_path, learning_steps=learning_steps,
                     profile_dir=str(tmp_path / "prof"),
                     profile_steps=window)
    loop.run_loop()
    assert loop.step == learning_steps and loop._profiler is None
    files = _trace_files(tmp_path / "prof")
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]


# -------------------------------------------------------------- ledger

def test_train_row_against_jax_flops_and_the_gap_identity(tmp_path):
    """The ``train_step`` row: ``flops_per_token`` equal to the JAX
    ``transformer_train_flops_per_token`` for the JAX model of the same
    config, the gap terms summing to 1 within 1e-9, no collective bytes
    for one process; the run dir's ``perf_ledger.json`` holds it."""
    from distributed_pipeline_tpu.models import \
        create_model_from_config as jax_model
    wl = jax_model(**TINY)
    shapes = jax.eval_shape(wl.init_params, jax.random.PRNGKey(0))
    n = sum(int(np.prod(x.shape))
            for x in jax.tree_util.tree_leaves(shapes))
    loop = tiny_loop(tmp_path, learning_steps=4, log_interval=2,
                     cost_ledger=True)
    assert loop.n_params == n
    loop.run_loop()
    row = ledger_lib.read_ledger(str(tmp_path))["programs"]["train_step"]
    assert row["flops_per_token"] == jax_perf.transformer_train_flops_per_token(
        n, TINY["num_layers"], TINY["hidden_size"], TINY["seq_len"])
    assert row["analytic_flops_per_step"] == \
        row["flops_per_execution"] == row["flops_per_token"] * 4 * 16
    assert abs(ledger_lib.gap_sum_identity(row) - 1.0) <= 1e-9
    assert row["collective_bytes_per_step"] == 0.0
    assert row["steps_per_s"] > 0 and 0 < row["padding_waste_frac"] < 1
    # the floor: the update's bytes and 2 weight passes a microbatch
    assert row["bytes_accessed"] == (
        (4 + 2 + 3 + 2) * 4 * n + 12 + 2 * 2 * 4 * n)


# ----------------------------------------------------------- sanitizer

def test_sanitize_on_the_cpu_writes_an_empty_report(tmp_path):
    """``run.train --sanitize true --device cpu``: nothing is guarded off
    CUDA, and the empty report reads through the JAX analysis CLI's
    loader."""
    run = tmp_path / "run"
    train_mod.main(["--device", "cpu", "--checkpoint_path", str(run),
                    "--seq_len", "16", "--vocab_size", "64",
                    "--hidden_size", "32", "--num_layers", "1",
                    "--num_heads", "2", "--dtype", "float32",
                    "--diffusion_steps", "50", "--batch_size", "4",
                    "--microbatch", "2", "--learning_steps", "2",
                    "--log_interval", "1", "--data_loader_workers", "0",
                    "--sanitize", "true"])
    reports = jax_cli._load_sanitize_reports(str(run))
    assert [(p, r) for p, r in reports] == [
        (str(run / "sanitize_report.json"), {"version": 1,
                                             "violations": []})]
