"""The port's sharded training state on two gloo ranks, on the CPU.

Each family (tiny GPT-2 and DiffuSeq, f32, 3 steps of 2 microbatches,
batch 4 a rank) trains in one pair of real rank processes three times
from the same weights and batches: unsharded, under ZeRO-1
(``shard_optimizer=True``) and under ``fsdp=2``, then resumes the saves
under other layouts. Held here:

* ZeRO-1 is bitwise the unsharded pair (losses, params, ``mu``, ``nu``,
  EMA; ``grad_norm`` within 1e-5 relative: its sum order), with one
  reduce-scatter and one all-gather a step and no all-reduce of the
  gradient; ``--fsdp 2`` holds the unsharded pair within f32 rounding
  (its gradients are reduced a microbatch at a time), and both pairs'
  ranks are bitwise equal;
* both against the JAX ``TrainLoop`` on ``make_mesh(dp=2)`` with
  ``shard_optimizer=True`` and on ``make_mesh(dp=1, fsdp=2)``, at
  ``tests/test_torch_port_dist.py``'s tolerances (the JAX DiffuSeq draws
  injected through the ``draws`` hook);
* ``footprint()``: logical bytes the unsharded run's, per-replica bytes
  at most the JAX ``footprint()``'s, and below the whole;
* the saves are layout-free: ZeRO-1's step-2 files are bitwise the
  unsharded run's; a resume flipping ``shard_optimizer`` either way, and
  ``fsdp`` 2 -> 1, restores the saved state bitwise and continues it
  (the flips between ZeRO-1 and unsharded bitwise the uninterrupted
  run); a ZeRO-1 resume walks back past a corrupt newest step;
* ``partition_rules`` reaches the ``TrainLoop``: an everything-replicated
  table cuts nothing on the fsdp mesh the default table cuts;
* four ranks as dp 2 x fsdp 2 with ZeRO-1 (the data and fsdp process
  groups, the units' pieces cut again over the data axis) hold four
  unsharded ranks within f32 rounding, and save full tensors;
* the refusals: ``--tensor 2`` names ROADMAP A.8g, a ``--fsdp`` that does
  not divide the ranks raises, and sharding with ``--sequence 2`` names
  A.8g.

Gradient clipping is off so that ZeRO-1's differently summed
``grad_norm`` cannot move the parameters. The ``cuda`` test (two gloo
ranks on ``cuda:0`` under ZeRO-1, the kernel on the shard, bitwise the
unsharded pair) runs on the card through
``scripts/run_torch_cuda_tests.py -k shard``.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_pipeline_tpu import data as jax_data  # noqa: E402
from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.parallel import make_mesh  # noqa: E402
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    opt_state_from_optax, params_from_flax)
from tests.test_torch_port_dist import (_np, _rank_rows,  # noqa: E402
                                        _spawn_ranks)

V, L, D, H, LAYERS, E = 64, 16, 32, 2, 2, 128
GB, GMB, P, STEPS = 8, 4, 2, 3
LOOP = dict(lr=1e-3, ema_rate="0.9,0.99", learning_steps=1000,
            gradient_clipping=-1.0, log_interval=10 ** 9,
            save_interval=10 ** 9)
CFGS = {"gpt2": dict(model_family="gpt2", vocab_size=V, seq_len=L,
                     hidden_size=D, num_layers=LAYERS, num_heads=H,
                     dtype="float32", attention_impl="xla"),
        "diffuseq": dict(model_family="diffuseq", vocab_size=V, seq_len=L,
                         hidden_size=D, num_layers=LAYERS, num_heads=H,
                         diffusion_steps=2000, dtype="float32",
                         attention_impl="xla")}
LAYOUTS = {"plain": {}, "zero1": dict(shard_optimizer=True),
           "fsdp": dict(fsdp=2)}
FLIPS = [("plain", "zero1"), ("zero1", "plain"), ("fsdp", "plain")]

RANK_SHARD = """
import os, sys
import torch
torch.set_num_threads(1)
from distributed_pipeline_tpu_torch.chaos import corrupt_newest_checkpoint
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
r = dist.get_rank()
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)
batches = spec["batches"][r]

def make(mode, run="", resume="", **kw):
    return TrainLoop(
        model=create_model_from_config(**spec["cfg"], device="cpu"),
        data=None, init_params=spec["params"], fused_update="false",
        checkpoint_dir=run, resume_checkpoint=resume,
        batch_size=spec["batch_size"], microbatch=spec["microbatch"], seed=7,
        draws=((lambda s, i: spec["draws"][s][i]) if spec["draws"]
               else None), **spec["loop"], **spec["layouts"][mode], **kw)

def state(loop):
    # copies: unsharded, full_flat is a view of the live buffer
    full = lambda *a: loop.full_flat(*a).clone()
    return {"params": full("params"), "mu": full("mu"), "nu": full("nu"),
            "count": int(loop.count),
            "ema": {k: full("ema", k) for k in loop.ema_rates}}

out = {"runs": {}, "flips": {}}
for mode in spec["layouts"]:
    loop = make(mode, f"{tmp}/{mode}")
    metrics = []
    for s, b in enumerate(batches):
        metrics.append({k: float(v) for k, v in loop.run_step(b).items()})
        if s == 1:
            loop.save()
            at2 = state(loop)
    loop.flush_metrics()
    loop.save()
    out["runs"][mode] = {
        "metrics": metrics, "at2": at2, "final": state(loop),
        "footprint": loop.footprint(), "layout": loop.shard.describe(),
        "calls": [loop.allreduce_time.calls, loop.reduce_scatter_time.calls,
                  loop.all_gather_time.calls],
        "unit_gathers": loop.fsdp.gathers if loop.fsdp else 0}
for src, dst in spec["flips"]:
    loop = make(dst, resume=f"{tmp}/{src}/model_000002.pt")
    restored = state(loop)
    loop.run_step(batches[2])
    out["flips"][f"{src}->{dst}"] = {"step": 2, "restored": restored,
                                     "final": state(loop)}
# the newest ZeRO-1 step garbled: the resume walks back to step 2
dist.barrier()
if r == 0:
    corrupt_newest_checkpoint(f"{tmp}/zero1")
dist.barrier()
loop = make("zero1", f"{tmp}/zero1")
out["walkback"] = {"step": loop.step, "restored": state(loop)}
loop = make("fsdp", partition_rules=((".*", ()),))
out["override_cut"] = (list(loop.shard.cut), loop.fsdp is None)
torch.save(out, f"{tmp}/rank{r}.pt")
"""


def _jax_draws(jloop, seed):
    sched = jloop.workload.schedule
    base = jax.random.PRNGKey(seed)
    draws = {}
    for s in range(STEPS):
        for i in range(GB // GMB):
            key = jax.random.fold_in(jax.random.fold_in(base, s), i)
            rng_t, rng_noise = jax.random.split(key)
            draws.setdefault(s, {})[i] = {
                "t": torch.from_numpy(np.array(sched.sample_t(rng_t, GMB))),
                "noise": torch.from_numpy(np.array(jax.random.normal(
                    rng_noise, (GMB, L, E), jnp.float32)))}
    return draws


def _jax_loop(fam, tmp_path, **mesh):
    kw = dict(shard_optimizer=True) if mesh.get("fsdp", 1) == 1 else {}
    return JaxTrainLoop(
        model=jax_create(**CFGS[fam]), data=None,
        mesh=make_mesh(**mesh, devices=jax.devices()[:2]), seed=5,
        checkpoint_dir=str(tmp_path / f"jax_{fam}_{len(mesh)}"),
        fused_update=False, batch_size=GB, microbatch=GMB, **kw, **LOOP)


@pytest.fixture(scope="module", params=sorted(CFGS))
def family(request, tmp_path_factory):
    """One family's three layouts on two gloo ranks, the JAX loops on the
    matching meshes, and the JAX runs' metrics and final states."""
    fam = request.param
    tmp = tmp_path_factory.mktemp(f"shard_{fam}")
    jax_runs = {"zero1": _jax_loop(fam, tmp, dp=2),
                "fsdp": _jax_loop(fam, tmp, dp=1, fsdp=2)}
    params = params_from_flax(_np(jax_runs["zero1"].state.params))
    draws = _jax_draws(jax_runs["zero1"], 5) if fam == "diffuseq" else None
    name = "synthetic-lm" if fam == "gpt2" else "synthetic-seq2seq"
    batches = [next(jax_data.load_data_from_args(
        "train", batch_size=GB, dataset=name, seq_len=L, vocab_size=V,
        seed=s, skip_batches=s)) for s in range(STEPS)]
    torch.save({"cfg": CFGS[fam], "params": params, "draws": draws,
                "batch_size": GB // P, "microbatch": GMB // P, "loop": LOOP,
                "layouts": LAYOUTS, "flips": FLIPS,
                "batches": [[_rank_rows(b, r) for b in batches]
                            for r in range(P)]}, tmp / "spec.pt")
    _spawn_ranks(tmp, RANK_SHARD, P, timeout=240)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(P)]
    jax_metrics = {k: [{m: float(v) for m, v in j.run_step(b).items()}
                       for b in batches] for k, j in jax_runs.items()}
    return {"fam": fam, "tmp": tmp, "ranks": ranks, "jax": jax_runs,
            "jax_metrics": jax_metrics}


def _assert_state_equal(a, b, what):
    for key in ("params", "mu", "nu"):
        assert torch.equal(a[key], b[key]), (what, key)
    for rate in a["ema"]:
        assert torch.equal(a["ema"][rate], b["ema"][rate]), (what, rate)
    assert a["count"] == b["count"], what


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_pair_holds_the_unsharded_pair(family, mode):
    """ZeRO-1: bitwise the unsharded pair but for ``grad_norm`` (1e-5
    relative), one reduce-scatter and one all-gather a step and no
    gradient all-reduce. ``fsdp=2``: within f32 rounding of it (losses
    2e-5, parameters 1e-5 relative), the units gathered twice a
    microbatch (one for the rest, whose gather covers both passes). The
    ranks are bitwise equal either way."""
    r0, r1 = family["ranks"]
    plain, run = r0["runs"]["plain"], r0["runs"][mode]
    _assert_state_equal(run["final"], r1["runs"][mode]["final"], "ranks")
    assert run["metrics"] == r1["runs"][mode]["metrics"]
    assert plain["calls"] == [STEPS, 0, 0]
    for got, ref in zip(run["metrics"], plain["metrics"]):
        for k in ref:
            if k == "grad_norm":
                assert got[k] == pytest.approx(ref[k], rel=1e-5)
            elif mode == "zero1":
                assert got[k] == ref[k], k
            else:
                assert got[k] == pytest.approx(ref[k], rel=2e-5), k
    if mode == "zero1":
        assert run["calls"] == [0, STEPS, STEPS]
        _assert_state_equal(run["final"], plain["final"], "zero1")
        return
    layout = run["layout"]
    assert layout["units"] == LAYERS + 1 and layout["cut_leaves"] > 0
    # a block's gathers: forward and backward, 2 microbatches, 3 steps;
    # the rest unit's once a microbatch
    assert run["unit_gathers"] == STEPS * 2 * (2 * LAYERS + 1)
    assert run["calls"][1] == STEPS * 2 * (LAYERS + 1)
    for key in ("params", "mu", "nu"):
        np.testing.assert_allclose(run["final"][key].numpy(),
                                   plain["final"][key].numpy(), rtol=1e-5,
                                   atol={"params": 1e-6, "mu": 1e-8,
                                         "nu": 1e-11}[key], err_msg=key)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_pair_holds_the_jax_trainloop(family, mode):
    """The sharded pair against the JAX ``TrainLoop`` on the matching
    mesh (dp=2 with ``shard_optimizer``; dp=1, fsdp=2): metrics, then the
    final parameters, moments and EMAs."""
    run = family["ranks"][0]["runs"][mode]
    jloop = family["jax"][mode]
    for got, ref in zip(run["metrics"], family["jax_metrics"][mode]):
        for k in ref:
            if k in ("lr", "grad_norm"):
                continue
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4)
    opt = opt_state_from_optax(jloop.state.opt_state)
    assert run["final"]["count"] == opt["count"] == STEPS
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
    view = TrainLoop(model=create_model_from_config(
        **CFGS[family["fam"]], device="cpu"), data=None,
        fused_update="false", checkpoint_dir="", batch_size=GB,
        microbatch=GMB, **LOOP)
    checks = [(run["final"]["params"], params_from_flax(
        _np(jloop.state.params)), 1e-5), (run["final"]["mu"], opt["mu"], 1e-7),
        (run["final"]["nu"], opt["nu"], 1e-10)]
    for rate, ema in run["final"]["ema"].items():
        checks.append((ema, params_from_flax(_np(jloop.state.ema[rate])),
                       1e-5))
    for flat, ref, atol in checks:
        ours = view.state_dict_of(flat)
        for key in ref:
            np.testing.assert_allclose(
                ours[key].numpy(), np.asarray(ref[key]), rtol=1e-4,
                atol=atol, err_msg=key)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_footprint_per_replica_within_jax(family, mode):
    """Logical bytes are the unsharded run's (and the JAX loop's params
    bytes); per-replica bytes are at most the JAX ``footprint()``'s and
    below the whole where the layout shards."""
    r0 = family["ranks"][0]["runs"]
    ours, plain = r0[mode]["footprint"], r0["plain"]["footprint"]
    jfp = family["jax"][mode].footprint()
    for key in ("params_bytes", "opt_state_bytes"):
        assert ours[key] == plain[key]
    assert ours["params_bytes"] == jfp["params_bytes"]
    for key in ("params_bytes_per_replica", "opt_state_bytes_per_replica",
                "ema_bytes_per_replica"):
        assert ours[key] <= jfp[key], (key, ours[key], jfp[key])
    assert ours["opt_state_bytes_per_replica"] < \
        plain["opt_state_bytes_per_replica"]
    if mode == "fsdp":
        assert ours["params_bytes_per_replica"] < ours["params_bytes"]


def test_zero1_save_is_bitwise_the_unsharded_save(family):
    """ZeRO-1's step-2 files (gathered to rank 0) are bitwise the unsharded
    run's: model, every EMA rate, the moments and the meta."""
    tmp = family["tmp"]
    for name in ("model_000002.pt", "ema_0.9_000002.pt",
                 "ema_0.99_000002.pt", "opt_000002.pt"):
        a = torch.load(tmp / "plain" / name, weights_only=True)
        b = torch.load(tmp / "zero1" / name, weights_only=True)
        if name.startswith("opt"):
            assert a["count"] == b["count"] == 2
            a = {f"{k}/{n}": t for k in ("mu", "nu") for n, t in a[k].items()}
            b = {f"{k}/{n}": t for k in ("mu", "nu") for n, t in b[k].items()}
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    assert json.loads((tmp / "plain" / "meta_000002.json").read_text()) == \
        json.loads((tmp / "zero1" / "meta_000002.json").read_text())


@pytest.mark.parametrize("flip", [f"{a}->{b}" for a, b in FLIPS])
def test_resume_flips_the_layout(family, flip):
    """A step-2 save resumed under another layout restores the saved
    state bitwise; the ZeRO-1 <-> unsharded flips continue bitwise into
    the uninterrupted unsharded run's step 3, and fsdp 2 -> 1 within
    fsdp's rounding of its own step 3."""
    src, dst = flip.split("->")
    for rank in family["ranks"]:
        got = rank["flips"][flip]
        _assert_state_equal(got["restored"], rank["runs"][src]["at2"],
                            flip)
        if src == "fsdp":
            np.testing.assert_allclose(
                got["final"]["params"].numpy(),
                rank["runs"]["fsdp"]["final"]["params"].numpy(), rtol=1e-5,
                atol=1e-6)
        else:
            _assert_state_equal(got["final"], rank["runs"]["plain"]["final"],
                                flip)


def test_zero1_walks_back_past_a_corrupt_newest(family):
    """With its newest step (3) garbled, a ZeRO-1 resume walks back to
    step 2 and restores its state bitwise on both ranks."""
    for rank in family["ranks"]:
        assert rank["walkback"]["step"] == 2
        _assert_state_equal(rank["walkback"]["restored"],
                            rank["runs"]["zero1"]["at2"], "walkback")


def test_partition_rules_override_reaches_trainloop(family):
    """An everything-replicated ``partition_rules`` leaves nothing cut on
    the fsdp mesh (and no units to gather), where the family's table
    cuts."""
    cut, no_units = family["ranks"][0]["override_cut"]
    assert cut == [] and no_units
    assert family["ranks"][0]["runs"]["fsdp"]["layout"]["cut_leaves"] > 0


RANK_MESH4 = """
import sys
import torch
torch.set_num_threads(1)
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
r = dist.get_rank()
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)
out = {}
for mode, kw in (("plain", {}), ("dp2_fsdp2_zero1",
                                 dict(fsdp=2, shard_optimizer=True))):
    loop = TrainLoop(
        model=create_model_from_config(**spec["cfg"], device="cpu"),
        data=None, init_params=spec["params"], fused_update="false",
        checkpoint_dir=f"{tmp}/{mode}", batch_size=2, microbatch=1, seed=7,
        **spec["loop"], **kw)
    metrics = [{k: float(v) for k, v in loop.run_step(b).items()}
               for b in spec["batches"][r]]
    loop.save()
    out[mode] = {"metrics": metrics, "mesh": loop.mesh.shape,
                 "coords": loop.mesh.coords, "rows": loop.mesh.rows(),
                 "params": loop.full_flat("params").clone(),
                 "mu": loop.full_flat("mu").clone()}
torch.save(out, f"{tmp}/rank{r}.pt")
"""


def test_four_ranks_dp2_fsdp2_zero1_hold_the_unsharded_four(tmp_path):
    """Four gloo ranks as a dp 2 x fsdp 2 mesh with ZeRO-1 (the data and
    fsdp process groups of two ranks each, the units' pieces cut again
    over the data axis) against four unsharded ranks over the same global
    batch: rank r at (data r // 2, fsdp r % 2) reads row group r; losses
    within 2e-5 and parameters and moments within f32 rounding; the ranks
    bitwise equal; the step-2 save holds the full tensors."""
    from distributed_pipeline_tpu_torch.convert import init_params
    cfg = CFGS["gpt2"]
    batches = [next(jax_data.load_data_from_args(
        "train", batch_size=8, dataset="synthetic-lm", seq_len=L,
        vocab_size=V, seed=s, skip_batches=s)) for s in range(2)]
    # global microbatch i is rank 0's microbatch i, then rank 1's, ...
    per_rank = [[{k: v.reshape(2, 4, 1, *v.shape[1:])[:, r].reshape(
        2, *v.shape[1:]) for k, v in b.items()} for b in batches]
        for r in range(4)]
    torch.save({"cfg": cfg, "params": init_params(cfg, 3),
                "loop": dict(LOOP, gradient_clipping=1.0),
                "batches": per_rank}, tmp_path / "spec.pt")
    _spawn_ranks(tmp_path, RANK_MESH4, 4, timeout=240)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    for r, out in enumerate(ranks):
        got = out["dp2_fsdp2_zero1"]
        assert (got["mesh"]["data"], got["mesh"]["fsdp"]) == (2, 2)
        assert (got["coords"]["data"], got["coords"]["fsdp"]) == (
            r // 2, r % 2)
        assert got["rows"] == (r, 4) == out["plain"]["rows"]
        assert torch.equal(got["params"], ranks[0]["dp2_fsdp2_zero1"][
            "params"])
    plain, got = ranks[0]["plain"], ranks[0]["dp2_fsdp2_zero1"]
    for a, b in zip(got["metrics"], plain["metrics"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=1e-5)
    for key, atol in (("params", 1e-6), ("mu", 1e-8)):
        np.testing.assert_allclose(got[key].numpy(), plain[key].numpy(),
                                   rtol=1e-5, atol=atol, err_msg=key)
    saved = torch.load(tmp_path / "dp2_fsdp2_zero1" / "model_000002.pt",
                       weights_only=True)
    ref = torch.load(tmp_path / "plain" / "model_000002.pt",
                     weights_only=True)
    assert {k: v.shape for k, v in saved.items()} == {
        k: v.shape for k, v in ref.items()}


@pytest.mark.parametrize("argv,world,match", [
    (["--tensor", "2"], 1, "ROADMAP A.8g"),
    (["--expert", "2"], 1, "ROADMAP A.8g"),
    (["--fsdp", "3"], 2, "must multiply to the world size"),
    (["--fsdp", "2", "--dp", "2"], 2, "must multiply to the world size"),
    (["--fsdp", "2", "--sequence", "2"], 4, "ROADMAP A.8g"),
    (["--shard_optimizer", "true", "--sequence", "2"], 2, "ROADMAP A.8g"),
    (["--fsdp", "2"], 2, None), (["--fsdp", "2", "--dp", "2"], 4, None)])
def test_sharding_flags_parse_or_name_their_refusal(monkeypatch, capsys,
                                                    argv, world, match):
    from distributed_pipeline_tpu_torch.config.train import parse_settings
    monkeypatch.setenv("WORLD_SIZE", str(world))
    if match is None:
        s = parse_settings(argv)
        assert s.fsdp == 2
        return
    with pytest.raises(SystemExit) as e:
        parse_settings(argv)
    assert e.value.code == 2
    assert match in capsys.readouterr().err


# ------------------------------------------------------------ on the card

CUDA_SHARD = """
import json, sys
import torch
from distributed_pipeline_tpu_torch.convert import init_params
from distributed_pipeline_tpu_torch.data import load_data_from_args
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.ops import fused_update
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.device import resolve_device
from distributed_pipeline_tpu_torch.utils.logger import Logger
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
cfg = dict(model_family="gpt2", vocab_size=256, seq_len=128, hidden_size=128,
           num_layers=2, num_heads=2, dtype="bfloat16",
           attention_impl="cuda")
device = resolve_device("")
dist.setup_dist(device)
r = dist.get_rank()
batch = next(load_data_from_args("train", batch_size=8, dataset="synthetic-lm",
                                 seq_len=128, vocab_size=256, seed=0))
rows = {k: v.reshape(2, 2, 2, -1)[:, r].reshape(4, -1)
        for k, v in batch.items()}
out = {}
for mode in ("plain", "zero1"):
    fused_update.reset_launch_count()
    loop = TrainLoop(model=create_model_from_config(**cfg, device=device),
                     data=None, batch_size=4, microbatch=2,
                     init_params=init_params(cfg, 0), fused_update="true",
                     shard_optimizer=mode == "zero1", logger=Logger(""))
    m = [{k: float(v) for k, v in loop.run_step(rows).items()}
         for _ in range(3)]
    torch.cuda.synchronize()
    out[mode] = {"metrics": m, "launches": fused_update.launch_count(),
                 "plain_calls": fused_update.plain_call_count(),
                 "owned": loop.shard.own, "n": loop.n_params,
                 "mu_numel": loop.mu.numel()}
    torch.save([loop.full_flat(k).cpu() for k in ("params", "mu", "nu")]
               + [loop.full_flat("ema", k).cpu() for k in loop.ema_rates],
               f"{tmp}/{mode}_{r}.pt")
json.dump(out, open(f"{tmp}/out_{r}.json", "w"))
"""


@pytest.mark.cuda
def test_cuda_zero1_pair_is_bitwise_the_unsharded_pair(tmp_path):
    """Two gloo ranks on ``cuda:0``: under ZeRO-1 each rank launches the
    fused kernel once a step over its half of the flat buffers (no plain
    call), and losses, parameters, moments and EMAs are bitwise the
    unsharded pair's."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.device_count() > 1:
        pytest.skip("the ranks would each take a card of their own")
    _spawn_ranks(tmp_path, CUDA_SHARD, 2, timeout=300)
    for r in range(2):
        out = json.loads((tmp_path / f"out_{r}.json").read_text())
        z, p = out["zero1"], out["plain"]
        assert (z["launches"], z["plain_calls"]) == (3, 0)
        assert z["mu_numel"] == z["owned"] == -(-z["n"] // 2)
        for a, b in zip(z["metrics"], p["metrics"]):
            assert a["loss"] == b["loss"]
            assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
        for a, b in zip(torch.load(tmp_path / f"zero1_{r}.pt"),
                        torch.load(tmp_path / f"plain_{r}.pt")):
            assert torch.equal(a, b)

