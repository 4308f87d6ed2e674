"""The port's run readers against the JAX package's, on the CPU.

``obs/export.py`` (the Perfetto timeline and the Prometheus snapshot),
``run/status.py`` (the status table), ``obs/regress.py`` (the history
sentinel) and ``run/perf_report.py`` (the ledger report) are jax-free in
both packages, so the JAX and port functions run on the same files and
their outputs must be equal exactly:

* a synthetic training run dir: two trace shards, ``attempts.jsonl`` with
  a watchdog kill, two rank beacons, a goodput record, a tuner journal
  and a ``perf_ledger.json`` with a ``train_step`` row;
* a synthetic fleet dir: two replica dirs (``ready.json``, beacons with
  the serving snapshot and the spec and prefix gauges, attempts, serving
  records, a ``serve_decode`` ledger row) and the router's journal with a
  replay;
* the run dir a real 3-step port ``TrainLoop`` writes with its tooling
  armed (trace, ledger, beacon);
* history rows for ``compare_runs``;
* each module's ``main`` as the CLI runs it.

No module of the port, nor ``chip_smoke.py``, imports ``jax`` or the JAX
package (a scan of their sources).
"""

import ast
import json
import os
import time

import pytest
import torch

from distributed_pipeline_tpu.obs import export as jax_export
from distributed_pipeline_tpu.obs import regress as jax_regress
from distributed_pipeline_tpu.run import perf_report as jax_report
from distributed_pipeline_tpu.run import status as jax_status
from distributed_pipeline_tpu_torch.chaos import goodput
from distributed_pipeline_tpu_torch.data import load_data_from_args
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.obs import export as port_export
from distributed_pipeline_tpu_torch.obs import ledger as ledger_lib
from distributed_pipeline_tpu_torch.obs import regress as port_regress
from distributed_pipeline_tpu_torch.obs import trace as trace_lib
from distributed_pipeline_tpu_torch.run import perf_report as port_report
from distributed_pipeline_tpu_torch.run import status as port_status
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_760_000_000.0
NOW = T0 + 40.0
GP = {"wall_s": 10.0, "useful_step_s": 7.0, "goodput": 0.7,
      "startup_s": 1.0, "setup_s": 0.5, "restore_s": 0.2, "compile_s": 1.0,
      "save_s": 0.2, "data_stall_s": 0.1, "recompute_s": 0.0}


def _write(path, payload):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(payload if isinstance(payload, str) else json.dumps(payload))


def _lines(path, rows):
    _write(path, "".join(json.dumps(r) + "\n" for r in rows))


def _row(program, tokens_per_s):
    row = {"program": program, "flops_per_execution": 1.5e12,
           "bytes_accessed": 2.5e9, "collective_bytes_per_step": 4e6,
           "tokens_per_s": tokens_per_s, "steps_per_s": 2.0,
           "peak_live_bytes": 123456}
    row.update(ledger_lib.roofline_attribution(
        tokens_per_s=tokens_per_s, flops_per_token=1e9,
        peak_flops=989e12, n_devices=1, steps_per_s=2.0,
        collective_bytes_per_step=4e6, bytes_accessed=2.5e9,
        host_stall_s_per_step=0.05, device_kind="NVIDIA H100 80GB HBM3",
        padding_waste_frac=0.125))
    assert row["mfu"] > 0
    return row


def synthetic_run(d):
    """A training run dir with every file the readers read."""
    os.makedirs(d)
    for rank in (0, 1):
        _lines(trace_lib.trace_path(d, rank), [
            {"ph": "X", "name": "restore", "cat": "ckpt", "t": T0 + 1,
             "dur": 0.25, "pid": 100 + rank, "tid": 1, "rank": rank,
             "args": {"step": 0}},
            {"ph": "X", "name": "step", "cat": "train", "t": T0 + 2,
             "dur": 0.5, "pid": 100 + rank, "tid": 1, "rank": rank,
             "args": {"step": 1}},
            {"ph": "X", "name": "save", "cat": "ckpt", "t": T0 + 3,
             "dur": 0.125, "pid": 100 + rank, "tid": 1, "rank": rank,
             "args": {"step": 1, "async": True}}])
    _lines(goodput.attempts_path(d), [
        {"attempt": 0, "rc": -9, "t_spawn": T0, "t_exit": T0 + 12,
         "duration_s": 12.0, "downtime_s": 0.0, "steps": 3, "end_step": 3,
         "hung": True, "hang_s": 5.0, "hang_kind": "stall", "goodput": GP},
        {"attempt": 1, "rc": 0, "t_spawn": T0 + 13, "t_exit": T0 + 25,
         "duration_s": 12.0, "downtime_s": 1.0, "steps": 4, "start_step": 2,
         "end_step": 6}])
    for rank, step in ((0, 6), (1, 5)):
        _write(goodput.beacon_path(d, rank),
               {"step": step, "start_step": 2, "t": T0 + 35 - rank * 30,
                "attempt": 1, "rank": rank, "steady_recompile_count": 0,
                "goodput": GP})
    _write(goodput.goodput_record_path(d, 1),
           {**GP, "attempt": 1, "steps": [2, 6]})
    _lines(os.path.join(d, "tune_trials.jsonl"), [
        {"kind": "trial", "cid": "dp1", "rung": 0, "status": "ok",
         "t": T0 + 30, "dur_s": 2.0, "result": {"steps_per_s": 3.5}},
        {"kind": "trial", "cid": "dp2", "status": "rejected",
         "reason": "memory", "t": T0 + 31},
        {"kind": "final", "cid": "dp1", "t": T0 + 32, "dur_s": 0.5}])
    ledger_lib.write_ledger(d, {"train_step": _row("train_step", 5e4)},
                            t=T0 + 24, extra={"step": 6, "n_devices": 1})
    return d


def synthetic_fleet(d):
    """A fleet dir: two replicas and the router's journal."""
    for rid in (0, 1):
        rd = goodput.replica_dir(d, rid)
        _write(os.path.join(rd, "ctrl", "ready.json"),
               {"attempt": rid, "params_step": 4, "t": T0 + 2})
        _write(goodput.beacon_path(rd, 0), {
            "step": 40 + rid, "t": T0 + 30 - rid * 25, "attempt": rid,
            "serving": {"wall_s": 20.0, "serving_s": 15.0, "drain_s": 1.0,
                        "swap_s": 0.5},
            "accept_rate": 0.5 + rid / 10, "accepted_tokens_per_s": 100.0,
            "prefix_hits": 3, "prefix_misses": 1 + rid})
        _lines(goodput.attempts_path(rd), [
            {"attempt": 0, "rc": -9 if rid else 0, "t_spawn": T0,
             "t_exit": T0 + 20, "duration_s": 20.0, "downtime_s": 0.0,
             "serving": {"wall_s": 19.0, "serving_s": 15.0}}])
        _write(goodput.serving_record_path(rd, 0),
               {"attempt": 0, "wall_s": 19.5, "serving_s": 15.5,
                "drain_s": 1.0, "swap_s": 0.5})
        if rid == 0:
            ledger_lib.write_ledger(
                rd, {"serve_decode": _row("serve_decode", 2e3)},
                t=T0 + 20)
    ev = []
    for i in range(4):
        t = T0 + 3 + i
        ev += [{"ev": "submit", "id": i, "t": t, "max_new_tokens": 8,
                "trace": trace_lib.request_trace_id(i)},
               {"ev": "assign", "id": i, "t": t + 0.5, "replica": i % 2,
                "affinity": 1 if i == 3 else 0}]
    ev += [{"ev": "replica_down", "replica": 1, "t": T0 + 8},
           {"ev": "replay", "id": 1, "t": T0 + 8, "from": 1,
            "reason": "down", "wasted_s": 0.25},
           {"ev": "assign", "id": 1, "t": T0 + 8.5, "replica": 0},
           {"ev": "scale", "dir": "up", "replica": 2, "t": T0 + 9,
            "reason": "queue", "n_active": 3},
           {"ev": "paid_idle", "idle_s": 0.75, "t": T0 + 9.5}]
    for i, ttft in ((0, 0.125), (1, 0.5), (2, 0.25)):
        ev.append({"ev": "complete", "id": i, "t": T0 + 10 + i,
                   "replica": 0, "n_tokens": 8, "ttft_s": ttft})
    _lines(goodput.serving_journal_path(d), ev)
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("readers")
    return {"run": synthetic_run(str(base / "run")),
            "fleet": synthetic_fleet(str(base / "fleet")),
            "empty": str(base)}


@pytest.mark.parametrize("kind", ["run", "fleet"])
def test_chrome_trace_equals_jax(dirs, kind):
    d = dirs[kind]
    ours, theirs = port_export.chrome_trace(d), jax_export.chrome_trace(d)
    assert ours == theirs
    names = {e["name"] for e in ours["traceEvents"]}
    if kind == "run":
        assert {"step", "save", "attempt 0", "watchdog_kill",
                "trial dp1", "roofline train_step"} <= names, names
    else:
        assert {"queue", "service", "replayed_work", "scale_up",
                "roofline serve_decode"} <= names, names
    json.dumps(ours)


@pytest.mark.parametrize("kind", ["run", "fleet"])
def test_prometheus_lines_equal_jax(dirs, kind):
    d = dirs[kind]
    ours = port_export.prometheus_lines(d, now=NOW)
    assert ours == jax_export.prometheus_lines(d, now=NOW)
    for line in ours:
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
    text = "\n".join(ours)
    if kind == "fleet":
        assert 'dpt_requests_total{state="completed"} 3' in text
        assert 'dpt_requests_total{state="replayed"} 1' in text
    else:
        assert 'dpt_beacon_step{rank="0"} 6' in text


@pytest.mark.parametrize("kind", ["run", "fleet", "empty"])
def test_status_and_render_equal_jax(dirs, kind):
    d = dirs[kind]
    ours = port_status.status(d, now=NOW)
    assert ours == jax_status.status(d, now=NOW)
    assert port_status.render(ours) == jax_status.render(ours)
    if kind == "run":
        assert ours["goodput"] == round(
            goodput.aggregate_run(d)["goodput"], 4)
        assert [r["state"] for r in ours["ranks"]] == ["advancing", "stale"]
    if kind == "fleet":
        counts = port_export.journal_counts(
            trace_lib.read_trace(goodput.serving_journal_path(d)))
        assert (counts["completed"], counts["replayed"]) == (3, 1)


def _history(runs):
    rows = []
    for rid, tps, mfu, rec in runs:
        for leg, scale in (("train_step", 1.0), ("serve_decode", 0.1)):
            rows.append({"name": leg, "run_id": rid,
                         "tokens_per_sec_per_chip": tps * scale, "mfu": mfu,
                         "peak_live_bytes": 1000, "recompile_count": rec})
    rows.append({"name": "broken", "run_id": runs[-1][0], "error": "oom"})
    return rows


@pytest.mark.parametrize("newest", [(1.0, 0.5, 0), (0.9, 0.5, 0),
                                    (1.1, 0.6, 1)],
                         ids=["flat", "regressed", "mixed"])
def test_compare_runs_and_table_equal_jax(newest, tmp_path):
    rows = _history([("a", 1.0, 0.5, 0), ("b", 1.02, 0.5, 0),
                     ("c", 0.98, 0.5, 0), ("new",) + newest])
    for band, base in ((3.0, 3), (5.0, 1)):
        ours = port_regress.compare_runs(port_regress.group_runs(rows),
                                         band_pct=band, baseline_runs=base)
        theirs = jax_regress.compare_runs(jax_regress.group_runs(rows),
                                          band_pct=band, baseline_runs=base)
        assert ours == theirs
        assert port_regress.render_table(ours) == \
            jax_regress.render_table(theirs)
    hist = str(tmp_path / "h.jsonl")
    _lines(hist, rows)
    (s1, rc1), (s2, rc2) = (m.main(["--history", hist, "--json"])
                            for m in (port_regress, jax_regress))
    assert (s1, rc1) == (s2, rc2)


def test_perf_report_equals_jax(dirs, capsys):
    for d in (dirs["run"], goodput.replica_dir(dirs["fleet"], 0)):
        payload = ledger_lib.read_ledger(d)
        assert port_report.render(payload) == jax_report.render(payload)
        ours, rc = port_report.main([d])
        theirs, rc2 = jax_report.main([d])
        assert (ours, rc) == (theirs, rc2) and rc == 0
    assert "train_step" in port_report.render(
        ledger_lib.read_ledger(dirs["run"]))
    assert port_report.main([dirs["empty"]]) == (None, 2)
    capsys.readouterr()


def test_clis_write_what_the_jax_clis_write(dirs, tmp_path, capsys):
    for kind in ("run", "fleet"):
        d = dirs[kind]
        outs = []
        for mod, tag in ((port_export, "port"), (jax_export, "jax")):
            out = str(tmp_path / f"{kind}_{tag}.json")
            summary = mod.main([d, "--out", out])
            with open(out) as f:
                outs.append((summary["events"], json.load(f)))
        assert outs[0] == outs[1]
        # the CLIs read the clock: the per-rank and per-replica rows carry
        # beacon ages, the rest is the files'
        snaps = [{k: v for k, v in m.main([d, "--json"]).items()
                  if k not in ("ranks", "replicas")}
                 for m in (port_status, jax_status)]
        assert snaps[0] == snaps[1] and snaps[0]["kind"] == kind
    capsys.readouterr()


def test_readers_on_a_real_port_run(tmp_path, monkeypatch):
    """A 3-step DiffuSeq ``TrainLoop`` with the trace, the ledger and the
    beacon armed, and a save: the JAX and port readers agree on its dir,
    the timeline holds its step and save spans, and its status gives the
    goodput fold's."""
    d = str(tmp_path / "real")
    model = create_model_from_config(
        model_family="diffuseq", vocab_size=64, seq_len=16, hidden_size=32,
        num_layers=1, num_heads=2, diffusion_steps=50, dtype="float32",
        device=torch.device("cpu"))
    data = load_data_from_args("train", batch_size=4,
                               dataset="synthetic-seq2seq", seq_len=16,
                               vocab_size=64, seed=0, data_loader_workers=0)
    loop = TrainLoop(model=model, data=data, batch_size=4, microbatch=2,
                     lr=1e-3, ema_rate="0.9", checkpoint_dir=d, seed=0,
                     learning_steps=3, log_interval=1, save_interval=2,
                     trace=True, cost_ledger=True,
                     progress_file=goodput.beacon_path(d, 0))
    loop.run_loop()
    now = time.time()
    ct = port_export.chrome_trace(d)
    assert ct == jax_export.chrome_trace(d)
    spans = [e for e in ct["traceEvents"] if e.get("ph") == "X"]
    assert [e["args"]["step"] for e in spans if e["name"] == "step"] == \
        [1, 2, 3]
    assert len([e for e in spans if e["name"] == "save"]) == 4
    assert port_export.prometheus_lines(d, now=now) == \
        jax_export.prometheus_lines(d, now=now)
    snap = port_status.status(d, now=now)
    assert snap == jax_status.status(d, now=now)
    assert snap["step"] == 3 and snap["mfu"] is not None
    assert port_report.render(ledger_lib.read_ledger(d)) == \
        jax_report.render(ledger_lib.read_ledger(d))


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_module_nor_chip_smoke_imports_jax():
    """A scan of every ``.py`` of the port and of ``chip_smoke.py``: no
    import of ``jax``, ``flax``, ``optax``, ``orbax`` or
    ``distributed_pipeline_tpu``."""
    pkg = os.path.join(REPO, "distributed_pipeline_tpu_torch")
    files = [os.path.join(r, f) for r, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 60
    banned = ("jax", "jaxlib", "flax", "optax", "orbax",
              "distributed_pipeline_tpu")
    bad = [(os.path.relpath(f, REPO), name) for f in files
           for name in _imports(f) if name.split(".")[0] in banned]
    assert not bad, bad
    for mod in ("obs/export.py", "obs/regress.py", "run/status.py",
                "run/perf_report.py"):
        assert os.path.exists(os.path.join(pkg, mod)), mod
