"""The port's data-parallel training across processes, on the CPU.

* the comm shim (``parallel/dist.py``): one process with nothing in the
  environment, every primitive the identity; a group that cannot form
  raises (the JAX shim degrades there: ROADMAP C.11);
* the rank-sharded loader streams bitwise the JAX loader's for P = 2, and
  ``skip_batches_for_samples`` / ``resume_sample_position`` equal to the
  JAX functions over a grid of (global batch, world size);
* ``distributed_mean_comm`` over two gloo ranks: count-weighted, and
  local values kept when the key sets differ;
* the trainer: two gloo ranks, 3 DiffuSeq steps of 2 microbatches each,
  fed the JAX draws through the ``draws`` hook (the global microbatch's,
  sliced per rank), against one port process over the same global batch
  and the JAX ``TrainLoop`` on a dp=2 mesh of two host devices; the
  ranks' target counts differ, so a mean of per-rank means would miss;
* ``run.train --distributed --nprocs 2 --device cpu`` end to end (one run
  dir, the rank files, ``global_batch`` in the meta, a resume at one
  process skipping by global samples), and a ring whose rank 1 is killed
  (it ends; ``--max_restarts 1`` respawns it and resumes).

Ranks are real processes (``launcher._worker_env`` gives them torch's
``env://`` keys) running the port alone. The two ``cuda`` tests (a
one-rank NCCL step bitwise the step without a group, and two gloo ranks
sharing ``cuda:0``) run on the card through
``scripts/run_torch_cuda_tests.py -k dist``.

Tolerances are those of ``tests/test_torch_port_diffuseq.py``'s trainer
test (losses rtol 2e-5, ``grad_norm`` 1e-4, parameters and EMAs rtol 1e-4
with atol 1e-5, mu 1e-7, nu 1e-10): the ranks sum their shares where one
process sums the whole microbatch, a different f32 order. Inside the port
a one-rank group and no group are compared bitwise.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu import data as jax_data  # noqa: E402
from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.parallel import make_mesh  # noqa: E402
from distributed_pipeline_tpu.run.train import \
    resume_sample_position as jax_resume_position  # noqa: E402
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch import data as port_data  # noqa: E402
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    opt_state_from_optax, params_from_flax)
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import dist  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import launcher  # noqa: E402
from distributed_pipeline_tpu_torch.run.train import \
    resume_sample_position  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import \
    TrainLoop  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, L, D, H, LAYERS, E = 64, 16, 32, 2, 2, 128
CFG = dict(model_family="diffuseq", vocab_size=V, seq_len=L, hidden_size=D,
           num_layers=LAYERS, num_heads=H, diffusion_steps=2000,
           dtype="float32", attention_impl="xla")
# the global batch: 8 rows in 2 microbatches of 4; each of 2 ranks holds 4
# rows in 2 microbatches of 2
GB, GMB, P = 8, 4, 2
LOOP = dict(lr=1e-3, ema_rate="0.9,0.99", learning_steps=1000,
            gradient_clipping=1.0, log_interval=10 ** 9,
            save_interval=10 ** 9)
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", launcher.AUTORUN_ENV_FLAG)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _spawn_ranks(tmp_path, body: str, world: int, timeout: float = 120.0
                 ) -> list:
    """Run ``body`` (Python source; ``sys.argv[1]`` is ``tmp_path``) as
    ``world`` rank processes with torch's ``env://`` keys; returns their
    outputs, each process having exited 0."""
    script = tmp_path / "rank_main.py"
    script.write_text(textwrap.dedent(body))
    port = launcher.find_free_port()
    procs = []
    for r in range(world):
        env = launcher._worker_env(r, world, port)
        env["PYTHONPATH"] = REPO
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    return outs


# ------------------------------------------------------------ the comm shim

@pytest.fixture
def no_group(monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    dist.setup_dist.cache_clear()
    yield
    dist.setup_dist.cache_clear()


def test_comm_shim_degrades_to_one_process(no_group):
    """With nothing in the environment: no group forms, rank 0 of 1, and
    every primitive is the identity."""
    dist.setup_dist(torch.device("cpu"))
    assert not dist.is_available() and not dist.is_initialized()
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    assert dist.device_count() == 1 and dist.backend() == "none"
    t = torch.arange(5.0)
    assert dist.all_reduce(t) is t and torch.equal(t, torch.arange(5.0))
    assert dist.broadcast(t) is t and dist.sync_params(t) is t
    assert torch.equal(t, torch.arange(5.0))
    assert dist.all_gather_object({"a": 1}) == [{"a": 1}]
    dist.barrier("x")
    assert dist.choose_backend(torch.device("cpu")) == "gloo"


def test_group_that_cannot_form_raises(no_group, monkeypatch):
    """WORLD_SIZE=2 with no rank 0 listening: the rank raises instead of
    training alone (ROADMAP C.11)."""
    port = launcher.find_free_port()
    for key, val in launcher._worker_env(1, 2, port).items():
        if key in ENV_KEYS:
            monkeypatch.setenv(key, val)
    assert dist.is_available()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not form"):
        dist.setup_dist(torch.device("cpu"), timeout_s=2.0)
    assert time.monotonic() - t0 < 60
    assert not dist.is_initialized()


# --------------------------------------------------------------- the data

@pytest.mark.parametrize("skip", [0, 3, 7])
@pytest.mark.parametrize("split,workers", [("train", 0), ("valid", 2)])
def test_rank_sharded_streams_are_bitwise_jax(skip, split, workers,
                                              monkeypatch):
    """Rank r of 2 streams the JAX loader's rank-r batches (process_index
    r of process_count 2), at several skips; ``host_sharded=False`` gives
    every rank the unsharded stream."""
    kw = dict(batch_size=4, dataset="synthetic-seq2seq", seq_len=L,
              vocab_size=V, seed=1, skip_batches=skip,
              deterministic=split == "valid")
    for r in range(P):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: P)
        monkeypatch.setattr(dist, "get_rank", lambda r=r: r)
        monkeypatch.setattr(dist, "get_world_size", lambda: P)
        want = jax_data.load_data_from_args(split, **kw)
        got = port_data.load_data_from_args(
            split, data_loader_workers=workers, **kw)
        whole = port_data.load_data_from_args(split, host_sharded=False,
                                              **kw)
        for _ in range(3):
            a, b = next(got), next(want)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        monkeypatch.setattr(jax, "process_count", lambda: 1)
        monkeypatch.setattr(jax, "process_index", lambda: 0)
        ref = jax_data.load_data_from_args(split, **kw)
        a, b = next(whole), next(ref)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n_items", [10, 11])
def test_small_dataset_shards_wrap_epochs_like_jax(n_items):
    """Epoch wrap with a count that does not divide by the ranks: each rank
    is trimmed to n // P items an epoch, as the JAX stream."""
    ds = [{"x": np.asarray([i], np.int32)} for i in range(n_items)]
    for r in range(P):
        for skip in (0, 2, 5):
            got = port_data.batch_iterator(ds, 2, seed=4, process_index=r,
                                           process_count=P,
                                           skip_batches=skip)
            want = jax_data.batch_iterator(ds, 2, seed=4, process_index=r,
                                           process_count=P,
                                           skip_batches=skip)
            for _ in range(7):
                np.testing.assert_array_equal(next(got)["x"],
                                              next(want)["x"])


def test_skip_and_resume_positions_match_jax():
    """``skip_batches_for_samples`` and ``resume_sample_position`` over a
    grid of saved and current (batch, world size) pairs, the meta with and
    without ``global_batch``."""
    for consumed in (0, 7, 48, 1000):
        for b in (1, 4, 6):
            for p in (1, 2, 3):
                assert port_data.skip_batches_for_samples(consumed, b, p) == \
                    jax_data.skip_batches_for_samples(consumed, b, p)
    for step in (0, 5, 12):
        for saved_gb in (4, 8, 12):
            for b, p in ((4, 1), (2, 2), (4, 2), (3, 4), (8, 1)):
                for meta_ in ({"samples": step * saved_gb,
                               "global_batch": saved_gb},
                              {"samples": step * saved_gb}, {}, None):
                    assert resume_sample_position(step, meta_, b, p) == \
                        jax_resume_position(step, meta_, b, p), \
                        (step, meta_, b, p)
    # same global batch: the skip is the step itself
    assert resume_sample_position(9, {"samples": 72, "global_batch": 8},
                                  4, 2) == (9, 72)


# ------------------------------------------------------------- the logger

MEAN_COMM = """
import json, sys, warnings
import torch
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.logger import (
    Logger, distributed_mean_comm)
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
r = dist.get_rank()
log = Logger(tmp + "/logs", stdout=r == 0, comm=distributed_mean_comm(),
             rank=r)
for v in ([1.0, 2.0, 3.0] if r == 0 else [10.0]):
    log.logkv_mean("a", v)
log.logkv("b", float(r))
first = log.dumpkvs()
log.logkv("b", float(r))
if r == 1:
    log.logkv("only1", 5.0)
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    second = log.dumpkvs()
log.close()
json.dump({"first": first, "second": second,
           "warned": [str(w.message) for w in caught]},
          open(f"{tmp}/comm{r}.json", "w"))
"""


def test_distributed_mean_comm_over_two_ranks(tmp_path):
    """Two gloo ranks: ``a`` logged 3 times on rank 0 (mean 2) and once on
    rank 1 (10) gives the count-weighted 4, not 6; ``b`` averages to 0.5.
    When rank 1 logs a key rank 0 does not, each keeps its own values,
    with a warning. Rank 1 writes ``-rank001`` files."""
    _spawn_ranks(tmp_path, MEAN_COMM, P)
    got = [json.loads((tmp_path / f"comm{r}.json").read_text())
           for r in range(P)]
    for g in got:
        assert g["first"]["a"] == pytest.approx(4.0, abs=1e-12)
        assert g["first"]["b"] == pytest.approx(0.5, abs=1e-12)
        assert any("key sets differ" in w for w in g["warned"])
    assert got[0]["second"] == {"b": 0.0}
    assert got[1]["second"] == {"b": 1.0, "only1": 5.0}
    names = sorted(os.listdir(tmp_path / "logs"))
    assert names == ["log-rank001.txt", "log.txt", "progress-rank001.csv",
                     "progress.csv"]
    rows = (tmp_path / "logs" / "progress.csv").read_text().splitlines()
    assert rows[0].split(",") == ["a", "b"] and len(rows) == 3


# ------------------------------------------------------------ the trainer

RANK_TRAIN = """
import sys
import torch
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
r = dist.get_rank()
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)
init = spec["params"]
if r > 0:  # a rank seeded apart: sync_params gives it rank 0's weights
    init = {k: v + 0.5 for k, v in init.items()}
loop = TrainLoop(model=create_model_from_config(**spec["cfg"],
                                                device="cpu"),
                 data=None, init_params=init, fused_update="false",
                 checkpoint_dir="", batch_size=spec["batch_size"],
                 microbatch=spec["microbatch"], seed=7,
                 draws=((lambda s, i: spec["draws"][s][i]) if spec["draws"]
                        else None), **spec["loop"])
metrics = [{k: float(v) for k, v in loop.run_step(b).items()}
           for b in spec["batches"][r]]
loop.flush_metrics()
torch.save({"metrics": metrics, "params": loop.params,
            "ema": loop.ema_state_dicts(), "mu": loop.mu, "nu": loop.nu,
            "count": int(loop.count), "samples": loop._samples,
            "world": loop.world, "allreduce_calls": loop.allreduce_time.calls,
            "state": loop.state_dict_of(loop.params)},
           f"{tmp}/rank{r}.pt")
"""


def _rank_rows(batch, r):
    """Rank r's rows of a global batch: its share of each global
    microbatch (rank 0's microbatch i, then rank 1's, form the global
    microbatch i)."""
    mb = GMB // P
    idx = np.concatenate([np.arange(i * GMB + r * mb, i * GMB + (r + 1) * mb)
                          for i in range(GB // GMB)])
    return {k: v[idx] for k, v in batch.items()}


def test_two_ranks_match_one_process_and_jax_dp2_mesh(tmp_path):
    """3 DiffuSeq steps of 2 microbatches on two gloo ranks against one
    port process over the same global batch and the JAX TrainLoop on a
    dp=2 mesh: losses, grad norms, parameters, EMAs and moments; the two
    ranks' parameters bitwise equal."""
    seed = 5
    jloop = JaxTrainLoop(
        model=jax_create(**CFG), data=None,
        mesh=make_mesh(dp=2, devices=jax.devices()[:2]), seed=seed,
        checkpoint_dir=str(tmp_path / "jax"), fused_update=False,
        batch_size=GB, microbatch=GMB, **LOOP)
    params = params_from_flax(_np(jloop.state.params))
    base = jax.random.PRNGKey(seed)
    sched = jloop.workload.schedule
    draws = {}
    for s in range(3):
        for i in range(GB // GMB):
            key = jax.random.fold_in(jax.random.fold_in(base, s), i)
            rng_t, rng_noise = jax.random.split(key)
            draws.setdefault(s, {})[i] = {
                "t": torch.from_numpy(np.array(sched.sample_t(rng_t, GMB))),
                "noise": torch.from_numpy(np.array(jax.random.normal(
                    rng_noise, (GMB, L, E), jnp.float32)))}
    batches = [next(jax_data.load_data_from_args(
        "train", batch_size=GB, dataset="synthetic-seq2seq", seq_len=L,
        vocab_size=V, seed=s, skip_batches=s)) for s in range(3)]
    # the ranks' target counts differ, microbatch by microbatch
    counts = [[int(_rank_rows(b, r)["input_mask"][i * 2:(i + 1) * 2].sum())
               for r in range(P)] for b in batches for i in range(2)]
    assert all(c[0] != c[1] for c in counts), counts
    torch.save({"cfg": CFG, "params": params, "draws": draws,
                "batch_size": GB // P, "microbatch": GMB // P, "loop": LOOP,
                "batches": [[_rank_rows(b, r) for b in batches]
                            for r in range(P)]}, tmp_path / "spec.pt")
    _spawn_ranks(tmp_path, RANK_TRAIN, P)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(P)]
    assert [x["world"] for x in ranks] == [P, P]
    assert [x["allreduce_calls"] for x in ranks] == [3, 3]
    assert ranks[0]["samples"] == 3 * GB
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])
    assert ranks[0]["metrics"] == ranks[1]["metrics"]

    one = TrainLoop(model=create_model_from_config(**CFG, device="cpu"),
                    data=None, init_params=params, fused_update="false",
                    checkpoint_dir="", draws=lambda s, i: draws[s][i],
                    batch_size=GB, microbatch=GMB, **LOOP)
    keys = ("loss", "mse", "tT", "decoder_nll")
    for s, batch in enumerate(batches):
        jm, om = jloop.run_step(batch), one.run_step(batch)
        pm = ranks[0]["metrics"][s]
        for ref in (om, jm):
            for k in keys:
                np.testing.assert_allclose(pm[k], float(ref[k]), rtol=2e-5,
                                           err_msg=k)
            np.testing.assert_allclose(pm["grad_norm"],
                                       float(ref["grad_norm"]), rtol=1e-4)
    opt = opt_state_from_optax(jloop.state.opt_state)
    assert ranks[0]["count"] == opt["count"] == 3
    want_ema = {rate: params_from_flax(_np(jloop.state.ema[rate]))
                for rate in ranks[0]["ema"]}
    refs = [(params_from_flax(_np(jloop.state.params)), opt["mu"],
             opt["nu"], want_ema),
            (one.state_dict_of(one.params), one.state_dict_of(one.mu),
             one.state_dict_of(one.nu), one.ema_state_dicts())]
    mine = TrainLoop(model=create_model_from_config(**CFG, device="cpu"),
                     data=None, init_params=params, fused_update="false",
                     checkpoint_dir="", batch_size=GB, microbatch=GMB,
                     **LOOP)
    mine.params.copy_(ranks[0]["params"])
    mine.mu.copy_(ranks[0]["mu"])
    mine.nu.copy_(ranks[0]["nu"])
    for p_ref, mu_ref, nu_ref, ema_ref in refs:
        checks = [(mine.state_dict_of(mine.params), p_ref, 1e-5),
                  (mine.state_dict_of(mine.mu), mu_ref, 1e-7),
                  (mine.state_dict_of(mine.nu), nu_ref, 1e-10)]
        for rate, ema in ranks[0]["ema"].items():
            checks.append((ema, ema_ref[rate], 1e-5))
        for ours, ref, atol in checks:
            for key in ref:
                np.testing.assert_allclose(
                    ours[key].numpy(), ref[key].detach().numpy(), rtol=1e-4,
                    atol=atol, err_msg=key)


def test_two_ranks_seeded_draws_match_one_process(tmp_path):
    """Without a draws hook each rank draws the global microbatch's ``t``
    and noise from the seeded generator and keeps its rows: 2 gloo ranks
    give one process's losses and parameters over the same global batch
    (each rank drawing only its own rows would not)."""
    params = params_from_flax(_np(jax_create(**CFG).init_params(
        jax.random.PRNGKey(2))))
    batches = [next(jax_data.load_data_from_args(
        "train", batch_size=GB, dataset="synthetic-seq2seq", seq_len=L,
        vocab_size=V, seed=s, skip_batches=s)) for s in range(2)]
    torch.save({"cfg": CFG, "params": params, "draws": None,
                "batch_size": GB // P, "microbatch": GMB // P, "loop": LOOP,
                "batches": [[_rank_rows(b, r) for b in batches]
                            for r in range(P)]}, tmp_path / "spec.pt")
    _spawn_ranks(tmp_path, RANK_TRAIN, P)
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    one = TrainLoop(model=create_model_from_config(**CFG, device="cpu"),
                    data=None, init_params=params, fused_update="false",
                    checkpoint_dir="", batch_size=GB, microbatch=GMB,
                    seed=7, **LOOP)
    for s, batch in enumerate(batches):
        om = one.run_step(batch)
        for k in ("loss", "mse", "tT", "decoder_nll"):
            np.testing.assert_allclose(got["metrics"][s][k], float(om[k]),
                                       rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(got["params"].numpy(), one.params.numpy(),
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------ MoE aux, global stats

MOE_CFG = dict(model_family="gpt2", vocab_size=V, seq_len=L, hidden_size=D,
               num_layers=LAYERS, num_heads=H, dtype="float32",
               attention_impl="xla", moe_experts=4, moe_top_k=2,
               moe_every=1)
MOE_LOOP = dict(LOOP, gradient_clipping=-1.0)

RANK_MOE = """
import sys
import torch
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
r = dist.get_rank()
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)
loop = TrainLoop(model=create_model_from_config(**spec["cfg"],
                                                device="cpu"),
                 data=None, init_params=spec["params"], fused_update="false",
                 checkpoint_dir="", batch_size=spec["batch_size"],
                 microbatch=spec["microbatch"], **spec["loop"])
if spec["per_rank_aux"]:
    # each rank forms the aux from its own rows' counts
    denoms = loop._global_denoms
    loop._global_denoms = lambda mbs: [(d, None) for d, _ in denoms(mbs)]
metrics, grads = [], []
for b in spec["batches"][r]:
    metrics.append({k: float(v) for k, v in loop.run_step(b).items()})
    grads.append(loop.grads.clone())
torch.save({"metrics": metrics, "grads": grads, "params": loop.params},
           f"{tmp}/rank{r}.pt")
"""


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """The JAX side of the MoE case: 2 steps of the JAX TrainLoop on a
    dp=2 mesh over 2 global batches whose ranks' rows differ in pad
    count, with each step's mean gradient over its global microbatches."""
    tmp = tmp_path_factory.mktemp("moe_jax")
    jloop = JaxTrainLoop(
        model=jax_create(**MOE_CFG), data=None,
        mesh=make_mesh(dp=2, devices=jax.devices()[:2]), seed=4,
        checkpoint_dir=str(tmp), fused_update=False, batch_size=GB,
        microbatch=GMB, **MOE_LOOP)
    params = params_from_flax(_np(jloop.state.params))
    batches = []
    for s in range(2):
        b = next(jax_data.load_data_from_args(
            "train", batch_size=GB, dataset="synthetic-lm", seq_len=L,
            vocab_size=V, seed=s, skip_batches=s))
        pad = np.ones_like(b["pad_mask"])
        for row in range(GB):
            # rank 0's rows (0-1 and 4-5) end in long pad runs, rank 1's in
            # short ones
            pad[row, L - (6 + row + s if row % 4 < 2 else row % 3):] = 0
        batches.append({**b, "pad_mask": pad})
    wl = jloop.workload

    def micro_loss(p, mb):
        return wl.compute_losses(p, mb, jax.random.PRNGKey(0))["loss"]

    grad_fn = jax.jit(jax.grad(micro_loss))
    grads, metrics = [], []
    for batch in batches:
        gs = [grad_fn(jloop.state.params,
                      {k: jnp.asarray(v[i * GMB:(i + 1) * GMB])
                       for k, v in batch.items()}) for i in range(GB // GMB)]
        mean = jax.tree_util.tree_map(lambda a, b: (a + b) * 0.5, *gs)
        grads.append(params_from_flax(_np(mean)))
        metrics.append({k: float(v) for k, v in jloop.run_step(batch).items()})
    return {"params": params, "batches": batches, "grads": grads,
            "metrics": metrics,
            "final": params_from_flax(_np(jloop.state.params))}


@pytest.mark.parametrize("per_rank_aux", [False, True],
                         ids=["global-stats", "per-rank-aux"])
def test_two_ranks_moe_aux_matches_jax_dp2_mesh(tmp_path, moe_reference,
                                               per_rank_aux):
    """2 MoE GPT-2 steps on two gloo ranks against the JAX TrainLoop on a
    dp=2 mesh: loss, ``moe_aux``, each step's gradients and the final
    parameters. The ranks' pad counts and expert counts differ, so the
    aux formed from each rank's own counts (``per-rank-aux``) misses: that
    case asserts the mismatch."""
    ref = moe_reference
    rank_rows = [[_rank_rows(b, r) for b in ref["batches"]] for r in range(P)]
    # the ranks' live-token and first-choice expert counts differ
    model = create_model_from_config(**MOE_CFG, device="cpu")
    model.load_state_dict(ref["params"])
    for i in range(GB // GMB):
        counts = []
        for r in range(P):
            mb = {k: torch.from_numpy(v[i * 2:(i + 1) * 2])
                  for k, v in rank_rows[r][0].items()}
            stats = []
            with torch.no_grad():
                model(mb["input_ids"], mb["pad_mask"], moe_stats=stats)
            counts.append((float(stats[0][2]), stats[0][0].tolist()))
        assert counts[0][0] != counts[1][0]
        assert counts[0][1] != counts[1][1]
    torch.save({"cfg": MOE_CFG, "params": ref["params"],
                "batch_size": GB // P, "microbatch": GMB // P,
                "loop": MOE_LOOP, "per_rank_aux": per_rank_aux,
                "batches": rank_rows}, tmp_path / "spec.pt")
    _spawn_ranks(tmp_path, RANK_MOE, P)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(P)]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])
    layout = TrainLoop(model=model, data=None, init_params=ref["params"],
                       fused_update="false", checkpoint_dir="",
                       batch_size=GB, microbatch=GMB, **MOE_LOOP)

    def matches() -> bool:
        try:
            for s in range(2):
                got, want = ranks[0]["metrics"][s], ref["metrics"][s]
                for k in ("loss", "nll", "moe_aux"):
                    np.testing.assert_allclose(got[k], want[k], rtol=2e-5,
                                               err_msg=k)
                np.testing.assert_allclose(got["grad_norm"],
                                           want["grad_norm"], rtol=1e-4)
                mine = layout.state_dict_of(ranks[0]["grads"][s])
                for key, g in ref["grads"][s].items():
                    np.testing.assert_allclose(
                        mine[key].numpy(), g.numpy(), rtol=5e-4, atol=1e-6,
                        err_msg=key)
            final = layout.state_dict_of(ranks[0]["params"])
            for key, p in ref["final"].items():
                np.testing.assert_allclose(final[key].numpy(), p.numpy(),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=key)
        except AssertionError as e:
            print(f"differs from the JAX dp=2 mesh: {e}")
            return False
        return True

    assert matches() != per_rank_aux


# ----------------------------------------------------- the entry point

TINY = ["--device", "cpu", "--model_family", "gpt2", "--dataset",
        "synthetic-lm", "--seq_len", "32", "--vocab_size", "64",
        "--hidden_size", "32", "--num_layers", "2", "--num_heads", "2",
        "--dtype", "float32", "--microbatch", "2", "--prefetch_depth", "0",
        "--data_loader_workers", "0", "--ema_rate", "0.9"]


def _train(cwd, *argv, timeout=120.0) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "distributed_pipeline_tpu_torch.run.train",
         *argv], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)


def _csv(path) -> list:
    rows = path.read_text().splitlines()
    head = rows[0].split(",")
    return [dict(zip(head, r.split(","))) for r in rows[1:]]


def test_run_train_two_ranks_then_resume_at_one(tmp_path):
    """``run.train --distributed --nprocs 2 --device cpu`` with no
    checkpoint path: one auto-named run dir (the launcher's pinned
    timestamp), rank 0's ``progress.csv`` and ``log.txt`` beside rank 1's
    ``-rank001`` files, the sidecars, the launcher's attempt record, and a
    checkpoint whose meta holds ``global_batch``. Resumed at one process
    with half the global batch, the stream skips by global samples."""
    out = _train(tmp_path, "--distributed", "--nprocs", "2", *TINY,
                 "--batch_size", "4", "--learning_steps", "4",
                 "--log_interval", "1", "--save_interval", "4")
    assert out.returncode == 0, out.stderr
    runs = os.listdir(tmp_path / "model_checkpoints")
    assert len(runs) == 1, runs
    run = tmp_path / "model_checkpoints" / runs[0]
    names = set(os.listdir(run))
    assert {"progress.csv", "log.txt", "progress-rank001.csv",
            "log-rank001.txt", "train_summary.json",
            "train_summary-rank001.json", "attempts.jsonl",
            "meta_000004.json", "model_000004.pt"} <= names
    meta_ = json.loads((run / "meta_000004.json").read_text())
    assert (meta_["global_batch"], meta_["batch_size"],
            meta_["samples"]) == (8, 4, 32)
    rows = _csv(run / "progress.csv")
    assert [float(r["samples"]) for r in rows] == [8, 16, 24, 32]
    assert _csv(run / "progress-rank001.csv")[-1]["loss"] == rows[-1]["loss"]
    shas = []
    for r in range(P):
        side = json.loads((run / ("train_summary.json" if r == 0 else
                                  "train_summary-rank001.json")).read_text())
        assert (side["rank"], side["world_size"], side["backend"],
                side["allreduce_calls"]) == (r, P, "gloo", 4)
        assert side["plain_calls"]["fused_adamw_ema"] == 4
        shas.append(side["params_sha256"])
    assert shas[0] == shas[1]
    attempts = [json.loads(x) for x in
                (run / "attempts.jsonl").read_text().splitlines()]
    assert [(a["rc"], a["nprocs"]) for a in attempts] == [(0, 2)]

    out = _train(tmp_path, *TINY, "--checkpoint_path", str(run),
                 "--batch_size", "4", "--learning_steps", "6",
                 "--log_interval", "1", "--save_interval", "0")
    assert out.returncode == 0, out.stderr
    log = (run / "log.txt").read_text()
    assert ("resume at step 4: 32 global samples consumed; each rank skips "
            "8 batches of 4") in log
    rows = _csv(run / "progress.csv")
    assert [float(r["samples"]) for r in rows[-2:]] == [36, 40]
    assert json.loads((run / "meta_000006.json").read_text())[
        "global_batch"] == 4


def _children(pid: int) -> list:
    kids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            kids.append(int(name))
    return kids


def _rank_pid(launcher_pid: int, rank: int) -> int:
    for pid in _children(launcher_pid):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if f"RANK={rank}".encode() in env:
            return pid
    raise LookupError(f"no rank {rank} under {launcher_pid}")


@pytest.mark.parametrize("restarts", [0, 1])
def test_killing_rank1_ends_the_ring(tmp_path, restarts):
    """Rank 1 SIGKILLed mid-run (after the step-4 checkpoint): rank 0, which
    would wait in the next collective forever, is terminated and the ring
    ends with a failure; with ``--max_restarts 1`` the whole ring is
    respawned, resumes from the newest checkpoint and finishes."""
    run = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_pipeline_tpu_torch.run.train",
         "--distributed", "--nprocs", "2", "--max_restarts", str(restarts),
         "--restart_backoff_s", "0", *TINY, "--batch_size", "4",
         "--learning_steps", "40", "--log_interval", "1",
         "--save_interval", "4", "--checkpoint_path", str(run)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 90
        while not (run / "meta_000004.json").exists():
            assert proc.poll() is None and time.time() < deadline, \
                proc.stderr.read() if proc.poll() is not None else "slow"
            time.sleep(0.01)
        os.kill(_rank_pid(proc.pid, 1), signal.SIGKILL)
        t_kill = time.time()
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    attempts = [json.loads(x) for x in
                (run / "attempts.jsonl").read_text().splitlines()]
    assert attempts[0]["rc"] != 0
    assert "exited with" in err
    if restarts == 0:
        assert proc.returncode != 0 and len(attempts) == 1
        assert time.time() - t_kill < 60
        assert not (run / "meta_000040.json").exists()
    else:
        assert proc.returncode == 0, err
        assert [a["rc"] for a in attempts] == [attempts[0]["rc"], 0]
        assert (run / "meta_000040.json").exists()
        assert "resume at step" in (run / "log.txt").read_text()


def test_launcher_refuses_bad_capacity(monkeypatch):
    """A malformed ``DPT_FORCE_NPROCS`` schedule fails the launch."""
    assert launcher.parse_capacity_schedule("2,1") == [2, 1]
    assert launcher.parse_capacity_schedule("") is None
    monkeypatch.setenv(launcher.FORCE_NPROCS_ENV, "2,0")
    with pytest.raises(ValueError, match="positive"):
        launcher.run_argv_as_distributed("x", [], nprocs=2)


def test_run_dir_timestamp_is_pinned(monkeypatch):
    """``resolve_run_dir`` names the run after ``DPT_RUN_TIMESTAMP``."""
    from distributed_pipeline_tpu_torch.config.train import TrainSettings
    from distributed_pipeline_tpu_torch.run.train import resolve_run_dir
    monkeypatch.setenv(launcher.RUN_TIMESTAMP_ENV, "20260101-000000")
    args = TrainSettings(dataset="d", lr=0.5, seed=3)
    assert resolve_run_dir(args) == os.path.join(
        "model_checkpoints", "Run_d_lr0.5_seed3_20260101-000000")


@pytest.mark.parametrize("world,dp,ok", [(1, -1, True), (1, 1, True),
                                         (1, 2, False), (2, 2, True),
                                         (2, 1, False), (2, -1, True)])
def test_dp_is_the_world_size(monkeypatch, world, dp, ok):
    from distributed_pipeline_tpu_torch.config.train import TrainSettings
    monkeypatch.setenv("WORLD_SIZE", str(world))
    if ok:
        assert TrainSettings(dp=dp).dp == dp
    else:
        with pytest.raises(ValueError,
                           match="must multiply to the world size"):
            TrainSettings(dp=dp)


# ------------------------------------------------------------ on the card

CUDA_RANK = """
import json, os, sys
import numpy as np
import torch
from distributed_pipeline_tpu_torch.convert import init_params
from distributed_pipeline_tpu_torch.data import load_data_from_args
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.ops import flash_attention, fused_update
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.device import resolve_device
from distributed_pipeline_tpu_torch.utils.logger import Logger
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
cfg = dict(model_family="gpt2", vocab_size=256, seq_len=128, hidden_size=128,
           num_layers=2, num_heads=2, dtype="bfloat16",
           attention_impl="cuda")
device = resolve_device("")
grouped = "RANK" in os.environ
dist.setup_dist(device)
world = dist.get_world_size()
batch = next(load_data_from_args("train", batch_size=8, dataset="synthetic-lm",
                                 seq_len=128, vocab_size=256, seed=0))
r = dist.get_rank()
rows = {k: v.reshape(2, world, 4 // world, -1)[:, r].reshape(8 // world, -1)
        for k, v in batch.items()}
loop = TrainLoop(model=create_model_from_config(**cfg, device=device),
                 data=None, batch_size=8 // world, microbatch=4 // world,
                 init_params=init_params(cfg, 0), fused_update="true",
                 logger=Logger(""))
m = [{k: float(v) for k, v in loop.run_step(rows).items()}
     for _ in range(2)]
torch.cuda.synchronize()
out = {"metrics": m, "backend": dist.backend(), "device": str(device),
       "launches": [flash_attention.forward_launch_count(),
                    flash_attention.backward_launch_count(),
                    fused_update.launch_count()],
       "params_sum": float(loop.params.double().sum())}
torch.save(loop.params.cpu(), f"{tmp}/params_{world}_{int(grouped)}_{r}.pt")
json.dump(out, open(f"{tmp}/out_{world}_{int(grouped)}_{r}.json", "w"))
"""


def _cuda_runs(tmp_path, world: int) -> None:
    """``CUDA_RANK`` as ``world`` ranks of a group, then as one process
    without a group."""
    _spawn_ranks(tmp_path, CUDA_RANK, world, timeout=300)
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, str(tmp_path / "rank_main.py"),
                    str(tmp_path)], env=env, cwd=REPO, check=True,
                   timeout=300)


@pytest.mark.cuda
def test_cuda_one_rank_nccl_step_is_bitwise_the_plain_step(tmp_path):
    """A process group of one rank over NCCL gives the losses, grad norms
    and parameters of no group at all, bit for bit, through the flash
    kernels and the fused update."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    _cuda_runs(tmp_path, 1)
    a = json.loads((tmp_path / "out_1_1_0.json").read_text())
    b = json.loads((tmp_path / "out_1_0_0.json").read_text())
    assert a["backend"] == "nccl" and b["backend"] == "none"
    assert a["metrics"] == b["metrics"]
    assert a["launches"] == b["launches"] and min(a["launches"]) > 0
    assert torch.equal(torch.load(tmp_path / "params_1_1_0.pt"),
                       torch.load(tmp_path / "params_1_0_0.pt"))


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_share_the_card(tmp_path):
    """Two ranks on one card take gloo on ``cuda:0``; their parameters are
    bitwise equal after two steps, every rank launched the kernels, and
    the losses are one process's over the same global batch within bf16
    rounding (1e-2 relative: other microbatch shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.device_count() > 1:
        pytest.skip("the ranks would each take a card of their own")
    _cuda_runs(tmp_path, 2)
    ranks = [json.loads((tmp_path / f"out_2_1_{r}.json").read_text())
             for r in range(2)]
    one = json.loads((tmp_path / "out_1_0_0.json").read_text())
    assert [x["backend"] for x in ranks] == ["gloo", "gloo"]
    assert [x["device"] for x in ranks] == ["cuda:0", "cuda:0"]
    assert all(min(x["launches"]) > 0 for x in ranks)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert torch.equal(torch.load(tmp_path / "params_2_1_0.pt"),
                       torch.load(tmp_path / "params_2_1_1.pt"))
    for got, ref in zip(ranks[0]["metrics"], one["metrics"]):
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-2)
