"""The MPMD pipeline runtime of the port (``distributed_pipeline_tpu_torch/
mpmd/``, ``run.train --mpmd``) against the JAX package's.

Tiny models (vocab 64, seq 16, hidden 32, 2-4 layers, 2 heads, f32):

* ``schedule_for`` equals the JAX generator's; a bf16 tensor crosses a
  ``FileStageLink`` bit for bit;
* ``StageMath``: each stage's init is bitwise the slice of the full
  ``convert.init_params`` (both families, the floor-balanced split), the
  per-slice AdamW within rtol 1e-6 of ``optax.adamw`` over 3 updates,
  ``export_flat``/``load_flat`` bitwise; ``run_pipeline_inprocess``
  against the JAX ``run_pipeline_inprocess`` on the same converted
  weights (GPT-2 at S = 2 and at S = 3 over 4 layers, DiffuSeq with the
  JAX draws handed in) at the JAX bar, rtol 2e-5; the 1F1B and GPipe op
  orders bitwise equal;
* the driver over stand-in workers (``tests/_torch_port_mpmd_child.py``:
  the real ``StageWorker``, its math the JAX fixture's scalar chain, no
  torch) against the JAX fixture's pure-python reference: the ring, an
  untied ring, gpipe, a ``DPT_MPMD_KILL`` rewind ending bitwise on the
  fault-free losses with only the killed stage restarted, the result
  artifact; a fresh process that parses ``--mpmd`` through ``run.train``
  and drives the stand-ins imports no torch;
* ``run.train --mpmd true`` on two real stage workers on the CPU
  against ``run_pipeline_inprocess`` of the config it wrote (rtol 1e-6);
* the pipeline goodput fold equals the JAX fold; the refusals.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_pipeline_tpu_torch.chaos import goodput as goodput_port
from distributed_pipeline_tpu_torch.config.train import (DEFERRED,
                                                         MPMD_DROPS,
                                                         MPMD_SUBMESH,
                                                         parse_settings)
from distributed_pipeline_tpu_torch.convert import init_params
from distributed_pipeline_tpu_torch.mpmd.link import (FileStageLink,
                                                      MemStageLink)
from distributed_pipeline_tpu_torch.mpmd.protocol import (load_snapshot,
                                                          save_snapshot,
                                                          schedule_for)
from distributed_pipeline_tpu_torch.mpmd.stage_math import (
    StageMath, pack_frame, run_pipeline_inprocess, stage_param_bounds,
    stage_param_slice, unpack_frame)
from distributed_pipeline_tpu_torch.run import train as train_mod

from tests.test_mpmd import _scalar_chain_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = "tests._torch_port_mpmd_child"


def _model(family: str, layers: int = 4) -> dict:
    m = dict(model_family=family, vocab_size=64, seq_len=16, hidden_size=32,
             num_layers=layers, num_heads=2, dtype="float32",
             scan_layers=True)
    if family == "diffuseq":
        m["diffusion_steps"] = 50
    return m


def _config(family: str = "gpt2", stages: int = 2, layers: int = 4,
            **kw) -> dict:
    data = dict(dataset=("synthetic-lm" if family == "gpt2"
                         else "synthetic-seq2seq"), seq_len=16,
                vocab_size=64, seed=0)
    cfg = {"n_stages": stages, "n_microbatches": 2, "schedule": "1f1b",
           "model": _model(family, layers), "data": data, "batch_size": 8,
           "seed": 0, "lr": 1e-3, "device": "cpu"}
    cfg.update(kw)
    return cfg


# a JAX stage slice's leaf -> the port's state-dict name
_JAX_LEAF = {"word_emb": "word_emb.embedding", "pos_emb": "pos_emb",
             "ln_f_scale": "backbone.ln_f.scale",
             "ln_f_bias": "backbone.ln_f.bias",
             "in_w": "in_proj.kernel", "in_b": "in_proj.bias",
             "t0_w": "time_mlp.layers_0.kernel",
             "t0_b": "time_mlp.layers_0.bias",
             "t1_w": "time_mlp.layers_2.kernel",
             "t1_b": "time_mlp.layers_2.bias",
             "out_w": "out_proj.kernel", "out_b": "out_proj.bias"}


def _jax_reference(family: str, stages: int) -> dict:
    """The JAX ``run_pipeline_inprocess`` over 2 steps of ``_config``,
    with what the port needs to run the same: the full initial state the
    JAX stages hold (read before they train: the block rows concatenated
    in stage order, each other leaf from the stage that holds it, as a
    port state dict) and, for DiffuSeq, the JAX stage 0's draws of each
    (step, microbatch)."""
    import jax
    import jax.numpy as jnp
    from distributed_pipeline_tpu.mpmd import StageMath as JaxStageMath
    from distributed_pipeline_tpu.mpmd import \
        run_pipeline_inprocess as jax_run
    cfg = {k: v for k, v in _config(family, stages).items()
           if k != "device"}
    maths = [JaxStageMath(cfg, s) for s in range(stages)]
    state, rows = {}, {}
    for m in maths:
        for name, v in m.params.items():
            if name == "blocks":
                for leaf, w in v.items():
                    rows.setdefault(leaf, []).append(np.asarray(w))
            else:
                state[_JAX_LEAF[name]] = torch.from_numpy(np.array(v))
    for leaf, parts in rows.items():
        state["backbone.blocks." + leaf] = torch.from_numpy(
            np.concatenate(parts))
    draws = {}
    if family == "diffuseq":
        first = maths[0]
        n = cfg["batch_size"] // cfg["n_microbatches"]
        for step in (1, 2):
            step_rng = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(cfg["seed"]), step), 7)
            for mb in range(cfg["n_microbatches"]):
                rng_t, rng_noise = jax.random.split(
                    jax.random.fold_in(step_rng, mb))
                draws[step, mb] = {
                    "t": np.asarray(first.wl.schedule.sample_t(rng_t, n)),
                    "noise": np.asarray(jax.random.normal(
                        rng_noise, (n, first.seq_len,
                                    first.params["word_emb"].shape[1]),
                        jnp.float32))}
    ref = jax_run(cfg, 2, maths=maths)
    return {"losses": ref["losses"], "metrics": ref["metrics"],
            "state": state, "draws": draws}


# ------------------------------------------------------- schedule and wire

@pytest.mark.parametrize("kind", ["1f1b", "gpipe"])
@pytest.mark.parametrize("n_stages,n_mb", [(2, 2), (2, 4), (4, 4), (4, 8)])
def test_schedule_for_matches_jax(kind, n_stages, n_mb):
    from distributed_pipeline_tpu.mpmd.protocol import \
        schedule_for as jax_schedule_for
    for stage in range(n_stages):
        assert schedule_for(stage, n_stages, n_mb, kind) == \
            jax_schedule_for(stage, n_stages, n_mb, kind)


def test_link_bf16_round_trip_is_bitwise(tmp_path):
    """A bf16 tensor crosses the numpy-only link as its uint16 view, bit
    for bit (signed zeros, infinities, NaN and subnormals included)."""
    g = torch.Generator().manual_seed(0)
    h = (torch.randn((2, 16, 32), generator=g) * 30).to(torch.bfloat16)
    flat = h.view(-1)
    flat[:5] = torch.tensor([0.0, -0.0, float("inf"), float("nan"), 1e-40],
                            dtype=torch.bfloat16)
    frame = pack_frame({"h": h, "sc": np.float32(0.25),
                        "x": torch.ones(3), "ids": np.arange(4)})
    assert frame["h@bf16"].dtype == np.uint16 and "h" not in frame
    tx = FileStageLink(str(tmp_path / "l"))
    rx = FileStageLink(str(tmp_path / "l"))
    assert tx.send(frame, {"step": 1, "mb": 0, "tag": "act"})
    arrays, _meta = rx.recv(timeout_s=5.0)
    mem = MemStageLink()
    mem.send(frame, {})
    for got in (arrays, mem.recv()[0]):
        back = unpack_frame(got, "cpu")
        assert back["h"].dtype == torch.bfloat16
        assert torch.equal(back["h"].view(torch.int16), h.view(torch.int16))
        assert back["sc"].dtype == torch.float32 and float(back["sc"]) == .25
        assert torch.equal(back["ids"], torch.arange(4))


# ----------------------------------------------------------------- the math

@pytest.mark.parametrize("family", ["gpt2", "diffuseq"])
def test_sliced_init_is_the_slice_of_the_full_init(family):
    """Every stage's parameters are bitwise its slice of the full
    ``init_params`` at the run's seed, at S = 2 and at S = 3 over 4 layers
    (the floor-balanced split 1 + 1 + 2), and the stages' block rows tile
    the stack."""
    cfg = _config(family, seed=3)
    full = init_params({**_model(family), "scan_layers": True}, 3)
    for S in (2, 3):
        rows = []
        for s in range(S):
            sm = StageMath(dict(cfg, n_stages=S), s)
            lo, hi = stage_param_bounds(4, s, S)
            want = stage_param_slice(full, family, lo, hi, s == 0,
                                     s == S - 1)
            assert sorted(sm.params) == sorted(want)
            for k, v in want.items():
                assert sm.params[k].dtype == torch.float32
                assert torch.equal(sm.params[k].detach(), v), (S, s, k)
            rows += list(range(lo, hi))
        assert rows == [0, 1, 2, 3]
        assert stage_param_bounds(4, 1, 3) == (1, 2)
    assert ("word_emb.embedding" in sm.params) == (family == "gpt2")
    assert sm.shared_keys == (["word_emb.embedding"] if family == "gpt2"
                              else [])


def test_adamw_matches_optax():
    """The per-slice AdamW (with weight decay) within rtol 1e-6 of
    ``optax.adamw`` over 3 updates of the same gradients."""
    import jax
    import jax.numpy as jnp
    import optax
    sm = StageMath(_config(lr=3e-3, weight_decay=0.1), 0)
    p0 = {k: v.detach().numpy().copy() for k, v in sm.params.items()}
    opt = optax.adamw(3e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
    ref = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(ref)
    update = jax.jit(opt.update)   # one compile, not one an op a leaf
    rng = np.random.default_rng(0)
    for step in range(1, 4):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in p0.items()}
        sm.start_step(step, 2)
        for k, p in sm.params.items():
            p.grad = torch.from_numpy(grads[k].copy())
        sm.apply()
        upd, state = update({k: jnp.asarray(g) for k, g in grads.items()},
                            state, ref)
        ref = optax.apply_updates(ref, upd)
    for k, p in sm.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert int(sm.count) == 3


def _run_schedule(cfg: dict, steps: int) -> tuple:
    """The stages' ``schedule_for`` op orders, interleaved in one process
    as far as each op's frame has arrived (what the stage processes do),
    over ``MemStageLink``s; returns the losses and the stages."""
    S, M = cfg["n_stages"], cfg["n_microbatches"]
    maths = [StageMath(cfg, s) for s in range(S)]
    acts = [MemStageLink(capacity=M + 2) for _ in range(S - 1)]
    grads = [MemStageLink(capacity=M + 2) for _ in range(S - 1)]
    losses = []
    for step in range(1, steps + 1):
        for m in maths:
            m.start_step(step, M)
        ops = [schedule_for(s, S, M, cfg["schedule"]) for s in range(S)]
        while any(ops):
            for s in range(S):
                if not ops[s]:
                    continue
                op, mb = ops[s][0]
                src = (acts[s - 1] if s > 0 else None) if op == "F" else \
                    (grads[s] if s < S - 1 else None)
                if src is not None and not src.pending():
                    continue
                inb = src.recv()[0] if src is not None else None
                if op == "F":
                    out = maths[s].forward_mb(mb, inb)
                    if s < S - 1:
                        acts[s].send(out, {})
                else:
                    out = maths[s].backward_mb(mb, inb)
                    if s > 0:
                        grads[s - 1].send(out, {})
                ops[s].pop(0)
        part = [m.shared_grads() for m in maths if m.shared_keys]
        summed = {k: part[0][k] + part[1][k] for k in part[0]}
        losses.append(sum(m.apply(summed if m.shared_keys else None)
                          ["loss_partial"] for m in maths))
    return losses, maths


def test_gpipe_equals_1f1b():
    """The op order changes memory, never the math: 1F1B and GPipe over
    three stages end bitwise on the same losses and parameters, and on
    the in-process runner's."""
    runs = {kind: _run_schedule(_config(stages=3, schedule=kind), 2)
            for kind in ("1f1b", "gpipe")}
    ref = run_pipeline_inprocess(_config(stages=3), 2)
    assert runs["1f1b"][0] == runs["gpipe"][0] == ref["losses"]
    for a, b, c in zip(runs["1f1b"][1], runs["gpipe"][1], ref["maths"]):
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k])
            assert torch.equal(a.params[k], c.params[k])


@pytest.mark.parametrize("family", ["gpt2", "diffuseq"])
def test_export_load_flat_is_bitwise(family, tmp_path):
    """A stage's parameters, moments and count survive ``export_flat`` ->
    a snapshot file -> ``load_flat`` into a fresh stage bit for bit, and
    the reloaded stage takes the same next step."""
    cfg = _config(family)
    run = run_pipeline_inprocess(cfg, 1)
    src = run["maths"][0]
    save_snapshot(str(tmp_path), 1, src.export_flat())
    flat = load_snapshot(str(tmp_path), 1)
    fresh = [StageMath(cfg, s) for s in range(2)]
    fresh[0].load_flat(flat)
    fresh[1].load_flat(run["maths"][1].export_flat())
    again = fresh[0].export_flat()
    assert sorted(again) == sorted(src.export_flat())
    for k, v in src.export_flat().items():
        assert v.dtype == again[k].dtype and np.array_equal(v, again[k]), k
    for m in fresh:
        m._done_steps = 1
    nxt = run_pipeline_inprocess(cfg, 1, maths=fresh)["losses"]
    assert nxt == run_pipeline_inprocess(cfg, 1, maths=run["maths"])[
        "losses"]


# ----------------------------------------- the driver over stand-in stages

def _standin_config(**kw) -> dict:
    cfg = {"n_stages": 2, "n_microbatches": 2, "schedule": "1f1b",
           "tied_embedding": True, "lr": 0.01, "link_capacity": 4}
    cfg.update(kw)
    return cfg


def _run_driver(run_dir, config, steps, **kw):
    from distributed_pipeline_tpu_torch.mpmd import PipelineDriver
    driver = PipelineDriver(str(run_dir), config, worker_modname=CHILD, **kw)
    try:
        return driver.run(steps)
    finally:
        driver.stop()


def test_driver_ring_end_to_end(tmp_path):
    """Two stand-in stage processes under their own rings, through the
    two-phase step protocol and the tied-gradient round, reproduce the
    JAX fixture's chain exactly; the fold has link_wait_s; run.status
    reads the run dir; each stage's sidecar carries the worker's
    stats."""
    res = _run_driver(tmp_path / "run", _standin_config(), 3,
                      max_restarts=1)
    assert res["steps"] == 3 and res["rewinds"] == 0
    assert res["attempts_per_stage"] == [1, 1]
    np.testing.assert_allclose(res["losses"],
                               _scalar_chain_reference(2, 2, 3), rtol=1e-9)
    gp = res["goodput"]
    assert gp["stages"] == 2 and gp["attempts"] >= 2
    assert gp["link_wait_s"] >= 0.0
    assert 0.5 < gp["accounted_frac"] <= 1.05
    from distributed_pipeline_tpu_torch.run.status import status
    st = status(str(tmp_path / "run"))
    assert st["kind"] == "pipeline"
    rows = {r["stage"]: r for r in st["stages"]}
    assert set(rows) == {0, 1}
    for r in rows.values():
        assert r["params_step"] == 3 and r["attempts"] == 1
    for s in range(2):
        side = goodput_port.read_goodput_records(
            goodput_port.stage_dir(str(tmp_path / "run"), s))[0]
        assert side["stage"] == s and side["steps"] == [0, 3]
        assert len(side["step_s"]) == 3 and side["snapshot_bytes"] > 0
        assert (side["act_frame_bytes"] > 0) == (s == 0)
        assert "launches" in side and "link_wait_s" in side


def test_driver_untied_ring_skips_shared_round(tmp_path):
    res = _run_driver(tmp_path / "run",
                      _standin_config(tied_embedding=False,
                                      n_microbatches=4), 2, max_restarts=1)
    np.testing.assert_allclose(
        res["losses"], _scalar_chain_reference(2, 4, 2, tied=False),
        rtol=1e-9)


def test_driver_gpipe_schedule_matches_reference(tmp_path):
    res = _run_driver(tmp_path / "run", _standin_config(schedule="gpipe"),
                      2, max_restarts=1)
    np.testing.assert_allclose(res["losses"],
                               _scalar_chain_reference(2, 2, 2), rtol=1e-9)


@pytest.mark.chaos
def test_driver_kill_stage_rewinds_bitwise(tmp_path, monkeypatch):
    """``DPT_MPMD_KILL=1:2`` SIGKILLs stage 1 mid-schedule at step 2: its
    own ring respawns it, the driver rewinds every stage to the common
    snapshot on a new epoch, and the run ends bitwise on the fault-free
    losses, stage 0 never restarted."""
    clean = _run_driver(tmp_path / "clean", _standin_config(), 3,
                        max_restarts=1)
    monkeypatch.setenv("DPT_MPMD_KILL", "1:2")
    res = _run_driver(tmp_path / "run", _standin_config(), 3,
                      max_restarts=2)
    assert res["rewinds"] >= 1
    assert res["attempts_per_stage"] == [1, 2]
    assert res["losses"] == clean["losses"]
    np.testing.assert_allclose(res["losses"],
                               _scalar_chain_reference(2, 2, 3), rtol=1e-9)
    gp = res["goodput"]
    assert gp["serving_attempts"] == 0
    assert 0.5 < gp["accounted_frac"] <= 1.05


def test_driver_result_artifact_roundtrips(tmp_path):
    from distributed_pipeline_tpu_torch.mpmd import PipelineDriver
    driver = PipelineDriver(str(tmp_path / "run"), _standin_config(),
                            worker_modname=CHILD, max_restarts=1)
    try:
        res = driver.run(1)
        driver.write_result(res)
    finally:
        driver.stop()
    with open(driver.result_path()) as f:
        persisted = json.load(f)
    np.testing.assert_allclose(persisted["losses"], res["losses"])
    assert persisted["attempts_per_stage"] == [1, 1]


def test_mpmd_parent_imports_no_torch(tmp_path):
    """A fresh process imports ``run.train``, parses ``--mpmd`` settings
    and drives the stand-in stages through a ``PipelineDriver``: no torch
    in ``sys.modules`` at its end."""
    script = (
        "import json, sys\n"
        "from distributed_pipeline_tpu_torch.run import train\n"
        "from distributed_pipeline_tpu_torch.mpmd import PipelineDriver\n"
        "s = train._parse_settings(['--mpmd', 'true', '--scan_layers',\n"
        "    'true', '--learning_steps', '2', '--device', 'cpu'])\n"
        "cfg = {'n_stages': s.mpmd_stages, 'n_microbatches': 2,\n"
        "       'schedule': s.pp_schedule, 'tied_embedding': True,\n"
        "       'lr': 0.01, 'link_capacity': s.mpmd_link_capacity}\n"
        f"d = PipelineDriver({str(tmp_path / 'run')!r}, cfg,\n"
        f"    worker_modname={CHILD!r}, max_restarts=0)\n"
        "try:\n"
        "    res = d.run(s.learning_steps)\n"
        "finally:\n"
        "    d.stop()\n"
        "print(json.dumps({'losses': res['losses'],\n"
        "                  'torch': 'torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["torch"] is False
    np.testing.assert_allclose(got["losses"],
                               _scalar_chain_reference(2, 2, 2), rtol=1e-9)


# ------------------------------------------------ run.train on real stages

def test_run_train_mpmd_real_stages_match_inprocess(tmp_path, capsys):
    """``run.train --mpmd true`` on two real stage workers on the CPU (a
    ring each, the frames through the run dir's links) against
    ``run_pipeline_inprocess`` of the config it wrote: the losses within
    rtol 1e-6, the summary line, each stage's sidecar."""
    run = str(tmp_path / "run")
    res = train_mod.main([
        "--mpmd", "true", "--mpmd_stages", "2", "--scan_layers", "true",
        "--pp_schedule", "1f1b", "--pp_chunks", "2", "--device", "cpu",
        "--model_family", "gpt2", "--dataset", "synthetic-lm",
        "--seq_len", "16", "--vocab_size", "64", "--hidden_size", "32",
        "--num_layers", "2", "--num_heads", "2", "--dtype", "float32",
        "--batch_size", "8", "--learning_steps", "2", "--lr", "1e-3",
        "--seed", "0", "--data_loader_workers", "0",
        "--checkpoint_path", run])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["mode"] == "mpmd" and summary["steps"] == 2
    assert summary["rewinds"] == 0 and summary["attempts_per_stage"] == [1,
                                                                        1]
    assert summary["final_loss"] == res["losses"][-1]
    with open(os.path.join(run, "mpmd_config.json")) as f:
        cfg = json.load(f)
    assert cfg["device"] == "cpu" and cfg["n_microbatches"] == 2
    ref = run_pipeline_inprocess(cfg, 2)
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-6)
    with open(os.path.join(run, "mpmd_result.json")) as f:
        assert json.load(f)["losses"] == res["losses"]
    for s in range(2):
        side = goodput_port.read_goodput_records(
            goodput_port.stage_dir(run, s))[0]
        assert side["device"] == "cpu" and side["layers"] == [s, s + 1]
        assert side["launches"] == {"flash_forward": 0, "flash_backward": 0,
                                    "fused_adamw_ema": 0}


# ---------------------------------------------- the fold and the refusals

def _synthetic_pipeline_dir(root: str) -> None:
    """Two stage dirs: stage 0 a killed attempt (its beacon goodput in the
    record) and a clean one with a sidecar, stage 1 one clean attempt."""
    gp = {"wall_s": 4.0, "startup_s": 1.0, "restore_s": 0.5,
          "save_s": 0.25, "link_wait_s": 0.75, "data_stall_s": 0.1,
          "recompute_s": 0.0, "useful_step_s": 1.4}
    for s, attempts in ((0, 2), (1, 1)):
        sd = goodput_port.stage_dir(root, s)
        os.makedirs(sd)
        for a in range(attempts):
            killed = s == 0 and a == 0
            goodput_port.append_attempt(sd, {
                "attempt": a, "rc": -9 if killed else 0,
                "t_spawn": 100.0 + 10 * a, "t_exit": 105.0 + 10 * a,
                "duration_s": 5.0, "downtime_s": 5.0 if a else 0.0,
                "stage": s, "goodput": gp if killed else None})
            if not killed:
                with open(goodput_port.goodput_record_path(sd, a), "w") as f:
                    json.dump({**gp, "attempt": a, "stage": s,
                               "recompute_s": 0.3 * s}, f)
    with open(os.path.join(root, "mpmd_config.json"), "w") as f:
        json.dump({"n_stages": 2, "schedule": "1f1b"}, f)


def test_aggregate_pipeline_matches_jax(tmp_path):
    from distributed_pipeline_tpu.chaos import goodput as goodput_jax
    root = str(tmp_path / "run")
    _synthetic_pipeline_dir(root)
    got = goodput_port.aggregate_run(root)
    want = goodput_jax.aggregate_run(root)
    assert got["stages"] == 2 and got["attempts"] == 3
    assert got["link_wait_s"] == pytest.approx(2.25)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


OK_MPMD = ["--mpmd", "true", "--scan_layers", "true", "--learning_steps",
           "3"]


@pytest.mark.parametrize("extra,expect", [
    (["--scan_layers", "false"], "--mpmd requires --scan_layers true"),
    (["--pp_schedule", "interleaved"], "host-driven 1f1b or gpipe"),
    (["--learning_steps", "0"], "--learning_steps > 0"),
    (["--pipe", "2"], "set --mpmd_stages instead"),
    (["--mpmd_stages", "1"], "needs >= 2"),
    (["--dp", "2"], MPMD_SUBMESH),
    (["--fsdp", "2"], MPMD_SUBMESH),
    (["--sequence", "2"], MPMD_SUBMESH),
    (["--shard_optimizer", "true"], MPMD_SUBMESH),
    *[([f"--{name}", value], f"--mpmd ignores --{name} ({MPMD_DROPS[name]})")
      for name, value in (("ema_rate", "0.999"), ("warmup_steps", "2"),
                          ("gradient_clipping", "1.0"),
                          ("fused_update", "false"), ("microbatch", "8"),
                          ("save_interval", "1"),
                          ("resume_checkpoint", "model_000001.pt"))]])
def test_mpmd_refusals_name_their_reason(extra, expect, capsys):
    with pytest.raises(SystemExit) as e:
        parse_settings(OK_MPMD + extra)
    assert e.value.code == 2
    assert expect in capsys.readouterr().err


def test_mpmd_settings_parse_and_distributed_is_refused(tmp_path):
    """The ``mpmd*`` options left ``DEFERRED`` and parse; ``--mpmd`` under
    ``--distributed`` is refused before any rank starts."""
    assert not any(k.startswith("mpmd") for k in DEFERRED)
    s = parse_settings(OK_MPMD + ["--mpmd_stages", "3",
                                  "--mpmd_link_capacity", "4",
                                  "--mpmd_hang_timeout_s", "5",
                                  "--mpmd_max_restarts", "1",
                                  "--pp_schedule", "gpipe"])
    assert (s.mpmd, s.mpmd_stages, s.mpmd_link_capacity,
            s.mpmd_hang_timeout_s, s.mpmd_max_restarts) == (True, 3, 4, 5.0,
                                                            1)
    with pytest.raises(SystemExit) as e:
        train_mod.main(["--distributed", "--nprocs", "2", *OK_MPMD,
                        "--checkpoint_path", str(tmp_path / "run")])
    assert MPMD_SUBMESH in str(e.value.code)
    assert not os.path.exists(tmp_path / "run")


@pytest.mark.parametrize("family,stages", [("gpt2", 2), ("gpt2", 3),
                                           ("diffuseq", 2)])
def test_inprocess_runner_matches_jax(family, stages):
    """The port's in-process MPMD runner against the JAX one on the JAX
    init, 2 steps (step 2 covers the backward, the per-slice update and
    GPT-2's tied-gradient sum) at the JAX bar, rtol 2e-5; S = 3 over 4
    layers splits them 1 + 1 + 2 and runs a middle stage; DiffuSeq takes
    the JAX draws."""
    ref = _jax_reference(family, stages)
    draws = None
    if family == "diffuseq":
        draws = lambda step, mb, rows: ref["draws"][step, mb]  # noqa: E731
    got = run_pipeline_inprocess(_config(family, stages), 2,
                                 init_state=ref["state"], draws=draws)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-5)
    if family == "gpt2":
        np.testing.assert_allclose(
            [m["acc"] for m in got["metrics"]],
            [m["acc"] for m in ref["metrics"]], rtol=2e-5)
        # the tied copies stay equal
        first, last = got["maths"][0], got["maths"][-1]
        assert torch.equal(first.params["word_emb.embedding"],
                           last.params["word_emb.embedding"])
