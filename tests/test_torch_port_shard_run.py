"""The sharded training state through the entry point, on the CPU:
``python -m distributed_pipeline_tpu_torch.run.train --distributed`` as
real gloo rank processes under the launcher (tiny GPT-2, f32, batch 4 in
microbatches of 2 a rank).

* ``--nprocs 2 --shard_optimizer true``: each rank's sidecar holds one
  reduce-scatter and one all-gather a step (no all-reduce), the update
  over half the flat buffer, both ranks' final parameters equal, and
  ``progress.csv`` the new collective columns; its step-4 save resumes
  at one process without ZeRO-1, skipping by global samples;
* ``--partition_rules`` naming a tuner artifact whose mesh is ``{data 1,
  fsdp 2}`` folds into the settings at ``--nprocs 2``: the ranks train
  under ``--fsdp 2`` (units gathered, their gradients reduce-scattered,
  fewer parameter bytes a rank);
* the entry point's launcher parent imports no torch;
* elastic resume under ZeRO-1: the launcher's capacity schedule
  ``DPT_FORCE_NPROCS=2,1`` and a ``corrupt_checkpoint`` + ``kill`` at
  step 4 move a two-rank ZeRO-1 ring to one rank, which walks back past
  the garbled step 4, resumes the layout-free step-2 save by global
  samples and finishes (the JAX
  ``test_elastic_shrink_grow_resume_e2e(2,1)`` case, with ZeRO-1).
"""

import json
import os
import subprocess
import sys

from distributed_pipeline_tpu_torch.chaos import read_attempts
from distributed_pipeline_tpu_torch.parallel import launcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", launcher.AUTORUN_ENV_FLAG,
            launcher.RUN_TIMESTAMP_ENV, launcher.FORCE_NPROCS_ENV,
            "DPT_CHAOS_PLAN", "DPT_TRACE", "DPT_ATTEMPT", "DPT_SPAWN_T",
            "DPT_RUN_DIR_FILE")
TINY = ["--device", "cpu", "--model_family", "gpt2", "--dataset",
        "synthetic-lm", "--seq_len", "32", "--vocab_size", "64",
        "--hidden_size", "32", "--num_layers", "2", "--num_heads", "2",
        "--dtype", "float32", "--batch_size", "4", "--microbatch", "2",
        "--prefetch_depth", "0", "--data_loader_workers", "0",
        "--ema_rate", "0.9"]


def _train(cwd, *argv, env_extra=None, timeout=150.0):
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    os.makedirs(cwd, exist_ok=True)
    return subprocess.run(
        [sys.executable, "-m", "distributed_pipeline_tpu_torch.run.train",
         *argv], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)


def _sidecars(run):
    return [json.loads((run / name).read_text()) for name in
            ("train_summary.json", "train_summary-rank001.json")]


def _csv(path):
    rows = path.read_text().splitlines()
    head = rows[0].split(",")
    return [dict(zip(head, r.split(","))) for r in rows[1:]]


def test_train_launcher_parent_imports_no_torch():
    """``python -m ...run.train --distributed --nprocs N``'s parent only
    spawns and supervises the ranks: importing the entry point (and the
    launcher it runs) leaves torch out of ``sys.modules``, so a launch does
    not wait for a torch import before its ranks start theirs."""
    code = ("import sys\n"
            "import distributed_pipeline_tpu_torch.run.train\n"
            "import distributed_pipeline_tpu_torch.parallel.launcher\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax')))\n")
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_train_zero1_then_resume_at_one(tmp_path):
    run = tmp_path / "run"
    out = _train(tmp_path, "--distributed", "--nprocs", "2",
                 "--shard_optimizer", "true", *TINY, "--checkpoint_path",
                 str(run), "--learning_steps", "4", "--log_interval", "1",
                 "--save_interval", "4")
    assert out.returncode == 0, out.stderr[-3000:]
    sides = _sidecars(run)
    n = None
    for r, side in enumerate(sides):
        assert (side["rank"], side["backend"], side["shard_optimizer"]) == (
            r, "gloo", True)
        assert side["mesh"]["data"] == 2 and side["mesh"]["fsdp"] == 1
        assert (side["allreduce_calls"], side["reduce_scatter_calls"],
                side["all_gather_calls"]) == (0, 4, 4)
        assert side["plain_calls"]["fused_adamw_ema"] == 4
        n = side["layout"]["n"]
        assert side["layout"]["owned"] == -(-n // 2)
        fp = side["footprint"]
        assert fp["opt_state_bytes_per_replica"] == 2 * 4 * -(-n // 2) + 4
        assert fp["opt_state_bytes"] == 2 * 4 * n + 4
    assert sides[0]["params_sha256"] == sides[1]["params_sha256"]
    rows = _csv(run / "progress.csv")
    assert {"reduce_scatter_s_per_step", "all_gather_s_per_step"} <= set(
        rows[-1])
    assert "allreduce_s_per_step" not in rows[-1]
    assert json.loads((run / "meta_000004.json").read_text())[
        "global_batch"] == 8

    out = _train(tmp_path, *TINY, "--checkpoint_path", str(run),
                 "--learning_steps", "6", "--log_interval", "1",
                 "--save_interval", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    log = (run / "log.txt").read_text()
    assert ("resume at step 4: 32 global samples consumed; each rank skips "
            "8 batches of 4") in log
    rows = _csv(run / "progress.csv")
    assert [float(r["samples"]) for r in rows[-2:]] == [36, 40]


def test_partition_rules_artifact_folds_its_fsdp_mesh(tmp_path):
    art = tmp_path / "tune_artifact.json"
    art.write_text(json.dumps({
        "partition_rules": [["attn/qkv$", ["fsdp", None, "tensor", None]],
                            ["mlp/w[io]$", ["fsdp"]], [".*", []]],
        "mesh": {"data": 1, "fsdp": 2}, "shard_optimizer": False}))
    run = tmp_path / "run"
    out = _train(tmp_path, "--distributed", "--nprocs", "2", *TINY,
                 "--partition_rules", f"@{art}", "--checkpoint_path",
                 str(run), "--learning_steps", "3", "--log_interval", "1",
                 "--save_interval", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "applying tuned mesh recommendation" in (
        run / "log.txt").read_text()
    args = json.loads((run / "training_args.json").read_text())
    assert (args["dp"], args["fsdp"]) == (1, 2)
    sides = _sidecars(run)
    for side in sides:
        assert side["mesh"]["fsdp"] == 2 and side["mesh"]["data"] == 1
        # qkv, mlp/wi and mlp/wo of two blocks; attn/out replicated here
        assert side["layout"]["cut_leaves"] == 6
        assert side["layout"]["units"] == 2
        assert side["fsdp_largest_unit_bytes"] > 0
        # 3 steps x 2 microbatches x 2 units
        assert side["reduce_scatter_calls"] == 12
        fp = side["footprint"]
        assert fp["params_bytes_per_replica"] < fp["params_bytes"]
    assert sides[0]["params_sha256"] == sides[1]["params_sha256"]
    assert os.path.exists(run / "model_000003.pt")


def test_elastic_shrink_resumes_under_zero1(tmp_path):
    run = tmp_path / "run"
    # the newest save garbled, then the kill: the next attempt walks back
    # (corrupt_checkpoint waits for the save in flight, so the step it
    # hits does not depend on the writer's timing)
    plan = {"faults": [{"kind": "corrupt_checkpoint", "step": 4, "rank": 0},
                       {"kind": "kill", "step": 4, "rank": 0}]}
    out = _train(tmp_path, "--distributed", "--nprocs", "2",
                 "--max_restarts", "2", "--restart_backoff_s", "0.1",
                 "--shard_optimizer", "true", *TINY, "--checkpoint_path",
                 str(run), "--learning_steps", "6", "--log_interval", "1",
                 "--save_interval", "2",
                 env_extra={launcher.FORCE_NPROCS_ENV: "2,1",
                            "DPT_CHAOS_PLAN": json.dumps(plan)},
                 timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = read_attempts(str(run))
    assert [r["nprocs"] for r in recs] == [2, 1]
    assert recs[0]["rc"] != 0 and recs[1]["rc"] == 0
    assert recs[1]["end_step"] == 6
    log = (run / "log.txt").read_text()
    assert "walking back" in log and "resumed from step 2" in log
    assert ("resume at step 2: 16 global samples consumed; each rank skips "
            "4 batches of 4") in log
    side = json.loads((run / "train_summary.json").read_text())
    assert side["world_size"] == 1 and side["steps"] == 6
    assert json.loads((run / "meta_000006.json").read_text())[
        "samples"] == 32
