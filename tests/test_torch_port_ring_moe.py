"""MoE and the decode callback under sequence parallelism, on the CPU.

Two gloo rank processes (dp1 x sp2, each holding an L/2 slice) against
the JAX package:

* ``moe_mlp_fwd`` split into two slices inside ``sequence_parallel``: the
  slices' ``[B, L/2, E, C]`` plans, concatenated, are the JAX function's
  ``[B, L, E, C]`` plan on the whole sequence exactly (capacity from the
  global L, claims counted from the slices before); ``y`` within rtol
  1e-5 (f32, another summation order); the ranks' raw statistics summed
  give the JAX aux (rtol 1e-6). Row 0's expert 0 takes claims at
  positions 2, 3 (slice 0) and 4 (slice 1) only, at capacity 2 (capacity
  factor 0.25): position 4
  overflows only across the slice boundary. A second call whose slice 1
  is all padding still issues its all-gather (no hang), and claims
  nothing there;
* 2 ``TrainLoop`` steps of a GPT-2 MoE model (4 experts, top-2, every
  block, capacity 1.0, 2 layers, D=32, V=64, L=16, f32, batch 8 in
  microbatches of 4, pad tails) against the JAX ``TrainLoop`` on a
  ``dp=1, sequence=2`` mesh with the converted weights: ``loss``,
  ``nll``, ``moe_aux`` and ``grad_norm`` at rtol 1e-4 (the bars of
  ``tests/test_torch_port_ring.py``); the ranks' parameters bitwise
  equal;
* the decode callback (``make_decode_callback``, GPT-2 greedy) under
  ``--sequence 2``: only the first sequence rank decodes, outside any
  sequence context, and the row every rank dumps carries its
  ``decode_acc``, the JAX callback's on a ``sequence=2`` mesh (1.0: the
  held batch's continuation is the one-process greedy decode's);
* ``run.train --distributed --nprocs 2 --sequence 2 --moe_experts 4
  --eval_decode true --device cpu`` end to end, and the settings parse.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu import data as jax_data  # noqa: E402
from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.models import \
    sampling as jax_sampling  # noqa: E402
from distributed_pipeline_tpu.models.moe import \
    moe_mlp_fwd as jax_moe_fwd  # noqa: E402
from distributed_pipeline_tpu.parallel import make_mesh  # noqa: E402
from distributed_pipeline_tpu.utils import logger as jax_logger  # noqa
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch.config.train import \
    parse_settings  # noqa: E402
from distributed_pipeline_tpu_torch.convert import \
    params_from_flax  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.models.sampling import \
    gpt2_decode  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import launcher  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, L, D, H, LAYERS, E = 64, 16, 32, 2, 2, 4
GB, GMB, STEPS, PROMPT = 8, 4, 2, 8
MOE = dict(moe_experts=E, moe_top_k=2, moe_every=1,
           moe_capacity_factor=1.0)
DENSE = dict(model_family="gpt2", vocab_size=V, seq_len=L, hidden_size=D,
             num_layers=LAYERS, num_heads=H, dtype="float32",
             attention_impl="auto")
LOOP = dict(lr=1e-3, ema_rate="0.9", learning_steps=1000,
            gradient_clipping=1.0, log_interval=10 ** 9,
            save_interval=10 ** 9)

RANKS = """
import sys
import torch
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.models import moe as moe_mod
from distributed_pipeline_tpu_torch.models import sampling
from distributed_pipeline_tpu_torch.parallel import dist, ring
from distributed_pipeline_tpu_torch.utils.logger import (
    Logger, distributed_mean_comm)
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
r = dist.get_rank()
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)
seq = dist.sequence_groups(2)
out = {"direct": []}

# moe_mlp_fwd on this rank's slice
for case in spec["direct"]:
    n = case["x"].shape[1] // 2
    sl = slice(r * n, (r + 1) * n)
    with ring.sequence_parallel(seq):
        y, stats, plan = moe_mod.moe_mlp_fwd(
            case["mp"], case["x"][:, sl], case["pad"][:, sl], top_k=2,
            capacity_factor=case["cf"], dtype=torch.float32,
            return_stats=True)
    out["direct"].append({"y": y, "stats": stats, "plan": plan})

# training steps of the MoE model
loop = TrainLoop(
    model=create_model_from_config(**spec["moe_cfg"], device="cpu"),
    data=None, init_params=spec["moe_params"], fused_update="false",
    checkpoint_dir="", batch_size=spec["gb"], microbatch=spec["gmb"],
    sequence=2, **spec["loop"])
out["metrics"] = [{k: float(v) for k, v in loop.run_step(b).items()}
                  for b in spec["batches"]]
loop.flush_metrics()
out["params"] = loop.params.clone()

# the decode callback under --sequence 2
calls = []
real = sampling.gpt2_decode_accuracy


def counted(*a, **k):
    calls.append(ring.current_sequence())
    return real(*a, **k)


sampling.gpt2_decode_accuracy = counted
log = Logger("", comm=distributed_mean_comm(), rank=r)
dense = TrainLoop(
    model=create_model_from_config(**spec["dense_cfg"], device="cpu"),
    data=None, init_params=spec["dense_params"], fused_update="false",
    checkpoint_dir="", batch_size=spec["gb"], microbatch=spec["gmb"],
    sequence=2, logger=log, **spec["loop"])
cb = sampling.make_decode_callback(iter([spec["held"]]),
                                   prompt_len=spec["prompt"])
cb(dense)
out["decode_row"] = log.dumpkvs()
out["decode_calls"] = calls
torch.save(out, f"{tmp}/rank{r}.pt")
"""


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _direct_cases():
    """Inputs whose routing the test controls: the router is the first E
    input dims, so a token at 4 * e_j routes first to expert j (second:
    the next largest input)."""
    rng = np.random.default_rng(0)
    cases = []
    rows, cols = np.arange(2)[:, None], np.arange(L)[None, :]
    for cf, dead_tail in ((0.25, False), (1.25, True)):
        x = rng.standard_normal((2, L, D)).astype(np.float32) * 0.1
        first = rng.integers(0, E, size=(2, L))
        first[0, 2:5] = 0          # row 0: 2, 3 | 4 all pick expert 0
        first[0, :2] = 1
        first[0, 5:] = (np.arange(5, L) % (E - 1)) + 1
        x[rows, cols, first] += 4.0
        # row 0's second choices avoid expert 0
        x[0, np.arange(L), np.where(first[0] == 3, 2, 3)] += 2.0
        mp = {"router": np.eye(D, E, dtype=np.float32),
              "wi": rng.standard_normal((E, D, 4 * D)).astype(np.float32)
              * np.float32(D ** -0.5),
              "wo": rng.standard_normal((E, 4 * D, D)).astype(np.float32)
              * np.float32((4 * D) ** -0.5)}
        pad = np.ones((2, L), np.int32)
        if dead_tail:
            pad[:, L // 2:] = 0    # slice 1 holds no live token
        else:
            pad[1, 13:] = 0
        cases.append({"x": x, "mp": mp, "pad": pad, "cf": cf})
    return cases


def _lens_mask(lens):
    return (np.arange(L)[None, :] < np.asarray(lens)[:, None]).astype(
        np.int32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and the JAX references (the ranks run while
    JAX compiles)."""
    tmp = tmp_path_factory.mktemp("ring_moe")
    mesh = make_mesh(dp=1, sequence=2, devices=jax.devices()[:2])
    jmoe = JaxTrainLoop(
        model=jax_create(**DENSE, **MOE), data=None, mesh=mesh, seed=5,
        checkpoint_dir=str(tmp / "jax_moe"), fused_update=False,
        batch_size=GB, microbatch=GMB, **LOOP)
    jdense = JaxTrainLoop(
        model=jax_create(**DENSE), data=None, mesh=mesh, seed=7,
        checkpoint_dir=str(tmp / "jax_dense"), fused_update=False,
        batch_size=GB, microbatch=GMB, **LOOP)
    batches = [next(jax_data.load_data_from_args(
        "train", batch_size=GB, dataset="synthetic-lm", seq_len=L,
        vocab_size=V, seed=s, skip_batches=s)) for s in range(STEPS)]
    for b in batches:   # pad tails: the slices' live counts differ
        b["pad_mask"] = _lens_mask([L, 13, 9, L, 5, L, 11, 7])
    held = next(jax_data.load_data_from_args(
        "valid", batch_size=4, dataset="synthetic-lm", seq_len=L,
        vocab_size=V, seed=11, deterministic=True))
    # the continuation the full-sequence greedy decode gives, so that only
    # a decode of the whole sequence scores 1.0 (a random model scores 0
    # on the data's own continuation, whatever it decodes)
    dense_params = params_from_flax(_np(jdense.state.params))
    model = create_model_from_config(**DENSE, device="cpu")
    model.load_state_dict(dense_params)
    with torch.no_grad():
        held["input_ids"] = gpt2_decode(
            model, torch.from_numpy(held["input_ids"]), PROMPT).numpy(
        ).astype(held["input_ids"].dtype)
    direct = _direct_cases()
    to_t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    torch.save({
        "direct": [{"x": to_t(c["x"]), "pad": to_t(c["pad"]),
                    "mp": {k: to_t(v) for k, v in c["mp"].items()},
                    "cf": c["cf"]} for c in direct],
        "moe_cfg": {**DENSE, **MOE},
        "moe_params": params_from_flax(_np(jmoe.state.params)),
        "dense_cfg": DENSE,
        "dense_params": dense_params,
        "batches": batches, "held": held, "prompt": PROMPT, "gb": GB,
        "gmb": GMB, "loop": LOOP}, tmp / "spec.pt")
    script = tmp / "ranks.py"
    script.write_text(textwrap.dedent(RANKS))
    port = launcher.find_free_port()
    procs = []
    for r in range(2):
        env = launcher._worker_env(r, 2, port)
        env["PYTHONPATH"] = REPO
        env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        # the JAX references meanwhile
        jdirect = []
        for c in direct:
            y, aux, plan = jax_moe_fwd(
                {k: jnp.asarray(v) for k, v in c["mp"].items()},
                jnp.asarray(c["x"]), jnp.asarray(c["pad"]), top_k=2,
                capacity_factor=c["cf"], dtype=jnp.float32)
            jdirect.append({"y": np.asarray(y), "aux": float(aux),
                            "plan": np.asarray(plan)})
        jmetrics = [{k: float(v) for k, v in jmoe.run_step(b).items()}
                    for b in batches]
        logged = {}
        orig = jax_logger.logkv
        jax_logger.logkv = lambda k, v: logged.__setitem__(k, v)
        try:
            jax_sampling.make_decode_callback(iter([held]),
                                              prompt_len=PROMPT)(jdense)
        finally:
            jax_logger.logkv = orig
        outs = [p.communicate(timeout=150)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return {"ranks": ranks, "direct": direct, "jax_direct": jdirect,
            "jax_metrics": jmetrics, "jax_decode": logged["decode_acc"]}


@pytest.mark.parametrize("case", [0, 1], ids=["boundary-overflow",
                                              "dead-slice"])
def test_moe_slices_route_as_the_global_sequence(run, case):
    ranks, want = run["ranks"], run["jax_direct"][case]
    plan = torch.cat([r["direct"][case]["plan"] for r in ranks], dim=1)
    np.testing.assert_array_equal(plan.numpy(), want["plan"])
    y = torch.cat([r["direct"][case]["y"] for r in ranks], dim=1)
    np.testing.assert_allclose(y.numpy(), want["y"], rtol=1e-5, atol=1e-6)
    F_, P_, n = (sum(r["direct"][case]["stats"][i] for r in ranks)
                 for i in range(3))
    n = torch.clamp(n, min=1.0)
    aux = float(E * torch.sum(F_ / n * (P_ / n)))
    np.testing.assert_allclose(aux, want["aux"], rtol=1e-6)
    C = want["plan"].shape[-1]
    assert C == max(1, int(np.ceil(L / E * run["direct"][case]["cf"] * 2)))
    if case == 0:
        # row 0, expert 0: positions 2 and 3 hold its 2 slots; position
        # 4 (slice 1's first) overflows only because of slice 0's claims
        got = want["plan"][0, :, 0].sum(-1)
        assert got[2] == got[3] == 1 and got[4] == 0
        local = ranks[1]["direct"][case]["plan"].numpy()
        assert local[0, 0, 0].sum() == 0
    else:
        assert want["plan"][:, L // 2:].sum() == 0
        assert ranks[1]["direct"][case]["plan"].sum() == 0


def test_moe_steps_match_the_jax_sequence_mesh(run):
    for r, rank in enumerate(run["ranks"]):
        assert torch.equal(rank["params"], run["ranks"][0]["params"])
        for s in range(STEPS):
            got, want = rank["metrics"][s], run["jax_metrics"][s]
            for k in ("loss", "nll", "moe_aux", "grad_norm"):
                np.testing.assert_allclose(
                    got[k], want[k], rtol=1e-4, atol=1e-7,
                    err_msg=f"rank {r} step {s} {k}")
    assert run["jax_metrics"][0]["moe_aux"] > 0


def test_decode_callback_under_sequence_two(run):
    """Rank 0 (the group's first sequence rank) decodes once, outside any
    sequence context; rank 1 not at all; both dump the JAX callback's
    ``decode_acc``: 1.0, the held batch's continuation being the full
    sequence's greedy decode."""
    r0, r1 = run["ranks"]
    assert r0["decode_calls"] == [None] and r1["decode_calls"] == []
    want = run["jax_decode"]
    assert want == 1.0
    for rank in (r0, r1):
        assert rank["decode_row"]["decode_acc"] == want


def test_run_train_moe_and_eval_decode_under_sequence_two(tmp_path):
    """``run.train --distributed --nprocs 2 --sequence 2 --moe_experts 4
    --eval_decode true --device cpu``: both ranks finish with equal
    parameters, and the rows carry ``moe_aux`` and ``decode_acc`` (the
    step-2 eval's lands in step 3's row)."""
    d = tmp_path / "run"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        launcher.AUTORUN_ENV_FLAG)}
    env["PYTHONPATH"] = REPO
    argv = ["--distributed", "--nprocs", "2", "--sequence", "2", "--device",
            "cpu", "--checkpoint_path", str(d), "--model_family", "gpt2",
            "--dataset", "synthetic-lm", "--seq_len", "16", "--vocab_size",
            "64", "--hidden_size", "32", "--num_layers", "2", "--num_heads",
            "2", "--dtype", "float32", "--batch_size", "4", "--microbatch",
            "2", "--learning_steps", "3", "--log_interval", "1",
            "--eval_interval", "2", "--eval_decode", "true",
            "--moe_experts", "4", "--moe_every", "1", "--prefetch_depth",
            "0", "--data_loader_workers", "0"]
    out = subprocess.run(
        [sys.executable, "-m", "distributed_pipeline_tpu_torch.run.train",
         *argv], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=150)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = (d / "progress.csv").read_text().splitlines()
    head = lines[0].split(",")
    rows = [dict(zip(head, line.split(","))) for line in lines[1:]]
    assert "moe_aux" in head and "decode_acc" in head
    assert any(r.get("decode_acc") for r in rows)
    sides = [json.loads((d / n).read_text()) for n in os.listdir(d)
             if n.startswith("train_summary")]
    assert len(sides) == 2
    assert sides[0]["params_sha256"] == sides[1]["params_sha256"]
    assert {s["sequence_index"] for s in sides} == {0, 1}


def test_moe_and_eval_decode_parse_with_sequence(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    s = parse_settings(["--sequence", "2", "--moe_experts", "4",
                        "--eval_decode", "true"])
    assert (s.sequence, s.moe_experts, s.eval_decode) == (2, 4, True)
