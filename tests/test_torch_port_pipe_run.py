"""``--pipe`` on spawned gloo ranks on the CPU, against the JAX pipeline.

Tiny models (vocab 64, seq 16, hidden 32, 4 layers, 2 heads, f32), batch
8 in microbatches of 4, ``pp_chunks`` 4 (one-row chunks). The reference
is the JAX ``TrainLoop`` on ``make_mesh(dp=1, pipe=2)`` over the same
batches (the JAX DiffuSeq draws injected through the ``draws`` hook).
One spawn of two ranks runs every configuration, another of four ranks
the ``{dp 2, pipe 2}`` case:

* ``--pipe 2`` x {gpipe, 1f1b, interleaved V=2} x {gpt2, diffuseq}: two
  steps' losses at rtol 2e-5 against the JAX pipe run, both ranks
  logging the same; the step-1 gradients, gathered to full stacked
  tensors, against ``jax.grad`` of the JAX loss at rtol 5e-4 (atol
  1e-6); the 1F1B stash's peak at stage 0 ``stash_size(4, 2) = 3``;
* the forward-only eval value equals the F+B value (the JAX
  ``test_1f1b_eval_forward_only_matches_grad_value``), and eval costs
  no B slot;
* the stacked weights gathered by ``full_weights`` decode (greedy, the
  dense cache) token for token as the JAX ``_decode_pipe`` does;
* ``remat`` under 1F1B bitwise the run without it;
* a ``--pipe 2`` save resumed at ``--pipe 1`` (its block tensors full,
  leading dim 4) and a ``--pipe 1`` save resumed at ``--pipe 2``, each
  continuing the saving run's next step;
* ``{dp 2, pipe 2}`` on four ranks (DiffuSeq 1F1B, ``pp_chunks`` 2)
  against the JAX ``make_mesh(dp=2, pipe=2)`` run;
* ``run.train --distributed --nprocs 2 --pipe 2`` once a schedule: the
  sidecar's pipe fields and exchange gauges, ``pipe_p2p_s_per_step`` in
  ``progress.csv``, ``decode_acc`` from ``--eval_decode`` under the
  pipe, and the 1F1B run dir resumed by ``run.train`` at ``--pipe 1``.
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
from distributed_pipeline_tpu.models.sampling import \
    gpt2_decode as jax_gpt2_decode  # noqa: E402
from distributed_pipeline_tpu.parallel import make_mesh  # noqa: E402
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    params_from_flax, params_to_flax)
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.models.schedule_1f1b import \
    stash_size  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import \
    TrainLoop  # noqa: E402
from tests.test_torch_port_dist import _csv, _spawn_ranks, _train  # noqa: E402
from tests.test_torch_port_pipeline import _np  # noqa: E402

V, L, D, H, LAYERS, E = 64, 16, 32, 2, 4, 128
GB, GMB, M, STEPS = 8, 4, 4, 2
LOOP = dict(lr=1e-3, ema_rate="0.9", learning_steps=1000,
            gradient_clipping=1.0, log_interval=10 ** 9,
            save_interval=10 ** 9)
CFGS = {"gpt2": dict(model_family="gpt2", vocab_size=V, seq_len=L,
                     hidden_size=D, num_layers=LAYERS, num_heads=H,
                     dtype="float32", attention_impl="xla",
                     scan_layers=True),
        "diffuseq": dict(model_family="diffuseq", vocab_size=V, seq_len=L,
                         hidden_size=D, num_layers=LAYERS, num_heads=H,
                         diffusion_steps=50, dtype="float32",
                         attention_impl="xla", scan_layers=True)}
SCHEDULES = ("gpipe", "1f1b", "interleaved")
KEYS = [(f, s) for f in sorted(CFGS) for s in SCHEDULES]

RANK_PIPE = """
import sys
import torch
torch.set_num_threads(1)
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.models.sampling import gpt2_decode
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
r = dist.get_rank()
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)

def make(fam, sched, run="", resume="", remat=False, **kw):
    draws = spec["draws"].get(fam)
    return TrainLoop(
        model=create_model_from_config(**spec["cfgs"][fam], pp_schedule=sched,
                                       pp_chunks=spec["chunks"], pp_virtual=2,
                                       remat=remat, device="cpu"),
        data=None, init_params=spec["params"].get(fam), fused_update="false",
        checkpoint_dir=run, resume_checkpoint=resume, pipe=spec["pipe"],
        batch_size=spec["batch_size"], microbatch=spec["microbatch"], seed=5,
        draws=(lambda s, i: draws[s][i]) if draws else None, **spec["loop"],
        **kw)

def full_grads(loop):
    return loop.shard.gather_full(loop.grads,
                                  loop.grads.new_empty(loop.shard.n),
                                  pipe_group=loop.pipe.group).clone()

out = {}
for fam, sched in spec["keys"]:
    batches = spec["batches"][fam]
    run = f"{tmp}/{fam}_{sched}"
    loop = make(fam, sched, run)
    res = {"layers": list(loop.shard.stage_layers)}
    fb = loop.forward_backward(batches[0])
    res["fb_loss"] = float(fb["loss"])
    res["grads"] = loop.state_dict_of(full_grads(loop))
    if fam == "gpt2" and sched == "1f1b":
        b_slots = loop.pipe_ctx.b_slots
        res["eval_loss"] = loop.forward_only(batches[0])["eval_loss"]
        res["eval_b_slots"] = loop.pipe_ctx.b_slots - b_slots
        with loop.full_weights():
            if loop.pipe.index == 0:
                res["decode"] = gpt2_decode(
                    loop.model, torch.from_numpy(spec["decode_ids"]), 8)
            dist.barrier()
    res["metrics"] = [{k: float(v) for k, v in loop.run_step(b).items()}
                      for b in batches[:2]]
    if fam == "gpt2" and sched == "1f1b":
        loop.save()
        res["at2"] = loop.full_flat("params").clone()
        res["step3"] = float(loop.run_step(batches[2])["loss"])
    res["stash_peak"] = loop.pipe_ctx.stash_peak
    out[(fam, sched)] = res
loop = make("gpt2", "1f1b", remat=True)
out["remat"] = [{k: float(v) for k, v in loop.run_step(b).items()}
                for b in spec["batches"]["gpt2"][:2]]
loop = make("gpt2", "1f1b", resume=spec["resume"])
out["resumed"] = {"step": loop.step,
                  "params": loop.full_flat("params").clone(),
                  "step3": float(loop.run_step(
                      spec["batches"]["gpt2"][2])["loss"])}
out["pipe_bytes"] = dist.pipe_bytes()
torch.save(out, f"{tmp}/rank{r}.pt")
"""


def _batches(fam, n=3, rows=GB):
    name = "synthetic-lm" if fam == "gpt2" else "synthetic-seq2seq"
    return [next(jax_data.load_data_from_args(
        "train", batch_size=rows, dataset=name, seq_len=L, vocab_size=V,
        seed=s, skip_batches=s)) for s in range(n)]


def _jax_draws(sched, seed, steps, micro, rows):
    base = jax.random.PRNGKey(seed)
    draws = {}
    for s in range(steps):
        for i in range(micro):
            key = jax.random.fold_in(jax.random.fold_in(base, s), i)
            rng_t, rng_noise = jax.random.split(key)
            draws.setdefault(s, {})[i] = {
                "t": torch.from_numpy(np.array(sched.sample_t(rng_t, rows))),
                "noise": torch.from_numpy(np.array(jax.random.normal(
                    rng_noise, (rows, L, E), jnp.float32)))}
    return draws


def _jax_loop(fam, sched, tmp, chunks=M, **mesh):
    n = max(1, int(np.prod(list(mesh.values()))))
    return JaxTrainLoop(
        model=jax_create(**CFGS[fam], pp_schedule=sched, pp_virtual=2,
                         pp_chunks=chunks),
        data=None, mesh=make_mesh(**mesh, devices=jax.devices()[:n]),
        seed=5, checkpoint_dir=str(tmp / f"jax_{fam}_{sched}_{n}"),
        fused_update=False, batch_size=GB, microbatch=GMB, **LOOP)


def _jax_grads(jloop, batch):
    """Step 1's gradient: ``jax.grad`` of the JAX loss at pipe 1 (no mesh
    in context) on each global microbatch (its draws), averaged, as the
    loop's step does; from the loop's initial parameters."""
    wl = jloop.workload
    grads = []
    for i in range(GB // GMB):
        mb = {k: v[i * GMB:(i + 1) * GMB] for k, v in batch.items()}
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5),
                                                    0), i)
        grads.append(jax.grad(lambda p: wl.compute_losses(
            p, mb, key)["loss"])(jloop.state.params))
    mean = jax.tree_util.tree_map(lambda *g: sum(g) / len(g), *grads)
    return params_from_flax(_np(mean))


@pytest.fixture(scope="module")
def pipe2(tmp_path_factory):
    """Every configuration on two gloo ranks, the JAX pipe runs, and a
    ``--pipe 1`` save for the ranks to resume."""
    tmp = tmp_path_factory.mktemp("pipe2")
    jax_runs, params, draws, grads, batches = {}, {}, {}, {}, {}
    for fam in CFGS:
        batches[fam] = _batches(fam)
        for sched in SCHEDULES:
            jax_runs[(fam, sched)] = _jax_loop(fam, sched, tmp, dp=1,
                                               pipe=2)
        j0 = jax_runs[(fam, "1f1b")]
        params[fam] = params_from_flax(_np(j0.state.params))
        if fam == "diffuseq":
            draws[fam] = _jax_draws(j0.workload.schedule, 5, 3,
                                    GB // GMB, GMB)
        # the gradient at pipe 1 (the JAX pipe runs hold the pipe-1 loss)
        grads[fam] = _jax_grads(j0, batches[fam][0])
    # a --pipe 1 stacked run saved at step 2, for the ranks to resume
    one = TrainLoop(model=create_model_from_config(
        **CFGS["gpt2"], device="cpu"), data=None,
        init_params=params["gpt2"], fused_update="false",
        checkpoint_dir=str(tmp / "one"), batch_size=GB, microbatch=GMB,
        seed=5, **LOOP)
    for b in batches["gpt2"][:2]:
        one.run_step(b)
    one.save()
    one_step3 = float(one.run_step(batches["gpt2"][2])["loss"])
    decode_ids = next(jax_data.load_data_from_args(
        "valid", batch_size=4, dataset="synthetic-lm", seq_len=L,
        vocab_size=V, seed=0, deterministic=True))["input_ids"]
    # both ranks of the pipe read the same rows
    torch.save({"cfgs": CFGS, "params": params, "draws": draws, "pipe": 2,
                "batch_size": GB, "microbatch": GMB, "chunks": M,
                "loop": LOOP, "keys": KEYS, "decode_ids": decode_ids,
                "resume": str(tmp / "one" / "model_000002.pt"),
                "batches": batches}, tmp / "spec.pt")
    _spawn_ranks(tmp, RANK_PIPE, 2, timeout=300)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    jax_metrics = {k: [{m: float(v) for m, v in j.run_step(b).items()}
                       for b in batches[k[0]][:STEPS]]
                   for k, j in jax_runs.items()}
    wl = jax_runs[("gpt2", "1f1b")].workload
    with make_mesh(dp=1, pipe=2, devices=jax.devices()[:2]):
        jax_decode = np.asarray(jax_gpt2_decode(
            wl, jax.tree_util.tree_map(jnp.asarray,
                                       params_to_flax(params["gpt2"])),
            jnp.asarray(decode_ids), 8))
    return {"tmp": tmp, "ranks": ranks, "jax": jax_metrics, "grads": grads,
            "jax_decode": jax_decode, "one_step3": one_step3}


@pytest.mark.parametrize("fam,sched", KEYS)
def test_pipe2_losses_and_gradients_match_jax(pipe2, fam, sched):
    """Two steps' losses against the JAX ``{dp 1, pipe 2}`` run (rtol
    2e-5) on both ranks; the step-1 gradient gathered to full stacked
    tensors against ``jax.grad``; each rank holds its stage's layers."""
    ranks = [r[(fam, sched)] for r in pipe2["ranks"]]
    want = [m["loss"] for m in pipe2["jax"][(fam, sched)]]
    for r, res in enumerate(ranks):
        got = [m["loss"] for m in res["metrics"]]
        np.testing.assert_allclose(got, want, rtol=2e-5, err_msg=str(r))
        assert res["fb_loss"] == got[0]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    layers = ([[0, 2], [1, 3]] if sched == "interleaved"
              else [[0, 1], [2, 3]])
    assert [res["layers"] for res in ranks] == layers
    grads = ranks[0]["grads"]
    for key, ref in pipe2["grads"][fam].items():
        assert grads[key].shape == ref.shape, key
        np.testing.assert_allclose(grads[key].numpy(), ref.numpy(),
                                   rtol=5e-4, atol=1e-6, err_msg=key)
        assert torch.equal(grads[key], ranks[1]["grads"][key]), key
    peak = ranks[0]["stash_peak"]
    if sched == "1f1b":
        assert peak == stash_size(M, 2) == 3 and ranks[1]["stash_peak"] == 1
    elif sched == "interleaved":
        assert 0 < peak <= 2 * stash_size(M, 2, 2)
    else:
        assert peak == 0


def test_remat_under_the_pipe_is_bitwise(pipe2):
    """``remat`` under 1F1B (each layer checkpointed inside the B slot's
    recompute) gives the run without it, bit for bit."""
    for r in pipe2["ranks"]:
        assert r["remat"] == r[("gpt2", "1f1b")]["metrics"]


def test_forward_only_eval_equals_the_fb_value(pipe2):
    for res in (r[("gpt2", "1f1b")] for r in pipe2["ranks"]):
        np.testing.assert_allclose(res["eval_loss"], res["fb_loss"],
                                   rtol=1e-6)
        assert res["eval_b_slots"] == 0


def test_gathered_weights_decode_as_the_jax_pipe_decode(pipe2):
    """Stage 0 decodes through the gathered stacked weights: the tokens
    of the JAX ``_decode_pipe`` (``make_mesh(dp=1, pipe=2)``), exactly;
    stage 1 decodes nothing."""
    ranks = [r[("gpt2", "1f1b")] for r in pipe2["ranks"]]
    np.testing.assert_array_equal(ranks[0]["decode"].numpy(),
                                  pipe2["jax_decode"])
    assert "decode" not in ranks[1]


def test_pipe2_save_resumes_at_pipe1_and_back(pipe2):
    """The ``--pipe 2`` save is layout-free (full stacked tensors, leading
    dim 4): a one-process loop restores it bitwise and its step 3 is the
    pipe run's (rtol 2e-5); the ranks resumed a ``--pipe 1`` save at step
    2 bitwise and continued it likewise."""
    tmp = pipe2["tmp"]
    res = pipe2["ranks"][0][("gpt2", "1f1b")]
    saved = torch.load(tmp / "gpt2_1f1b" / "model_000002.pt",
                       weights_only=True)
    assert saved["backbone.blocks.qkv"].shape[0] == LAYERS
    one = TrainLoop(model=create_model_from_config(**CFGS["gpt2"],
                                                   device="cpu"),
                    data=None, fused_update="false",
                    checkpoint_dir=str(tmp / "gpt2_1f1b"), batch_size=GB,
                    microbatch=GMB, seed=5, **LOOP)
    assert one.step == 2
    assert torch.equal(one.full_flat("params"), res["at2"])
    step3 = float(one.run_step(_batches("gpt2")[2])["loss"])
    np.testing.assert_allclose(step3, res["step3"], rtol=2e-5)
    for r in pipe2["ranks"]:
        back = r["resumed"]
        assert back["step"] == 2
        np.testing.assert_allclose(back["step3"], pipe2["one_step3"],
                                   rtol=2e-5)
    assert torch.equal(pipe2["ranks"][0]["resumed"]["params"],
                       pipe2["ranks"][1]["resumed"]["params"])
    assert all(r["pipe_bytes"] > 0 for r in pipe2["ranks"])


RANK_DP_PIPE = """
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
draws = spec["draws"]
loop = TrainLoop(
    model=create_model_from_config(**spec["cfg"], pp_schedule="1f1b",
                                   pp_chunks=2, device="cpu"),
    data=None, init_params=spec["params"], fused_update="false", pipe=2,
    batch_size=4, microbatch=2, seed=5, draws=lambda s, i: draws[s][i],
    **spec["loop"])
out = {"mesh": loop.mesh.shape, "rows": loop.mesh.rows(),
       "layers": list(loop.shard.stage_layers),
       "metrics": [{k: float(v) for k, v in loop.run_step(b).items()}
                   for b in spec["batches"][r // 2]],
       "params": loop.full_flat("params").clone()}
torch.save(out, f"{tmp}/rank{r}.pt")
"""


def test_dp2_pipe2_on_four_ranks_matches_jax(tmp_path):
    """``{dp 2, pipe 2}``: rank r is data index r // 2 and stage r % 2; a
    pipe group's ranks read their row group's rows and draw its DiffuSeq
    draws; the stage slice's gradient sums over the data group and the
    rest's over every rank. Two steps against the JAX
    ``make_mesh(dp=2, pipe=2)`` run at rtol 2e-5; every rank logs the same
    losses and holds the same gathered parameters."""
    from tests.test_torch_port_dist import _rank_rows
    jloop = _jax_loop("diffuseq", "1f1b", tmp_path, chunks=2, dp=2, pipe=2)
    draws = _jax_draws(jloop.workload.schedule, 5, STEPS, GB // GMB, GMB)
    batches = _batches("diffuseq", STEPS)
    torch.save({"cfg": CFGS["diffuseq"], "loop": LOOP, "draws": draws,
                "params": params_from_flax(_np(jloop.state.params)),
                "batches": [[_rank_rows(b, d) for b in batches]
                            for d in range(2)]}, tmp_path / "spec.pt")
    _spawn_ranks(tmp_path, RANK_DP_PIPE, 4, timeout=240)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    want = [float(jloop.run_step(b)["loss"]) for b in batches]
    for r, res in enumerate(ranks):
        assert res["mesh"]["data"] == 2 and res["mesh"]["pipe"] == 2
        assert res["rows"] == (r // 2, 2)
        assert res["layers"] == ([0, 1] if r % 2 == 0 else [2, 3])
        np.testing.assert_allclose([m["loss"] for m in res["metrics"]],
                                   want, rtol=2e-5, err_msg=str(r))
        assert res["metrics"] == ranks[0]["metrics"]
        assert torch.equal(res["params"], ranks[0]["params"])


TINY_PIPE = ["--device", "cpu", "--dataset", "synthetic-lm",
             "--model_family", "gpt2", "--seq_len", "16", "--vocab_size",
             "64", "--hidden_size", "32", "--num_layers", "4",
             "--num_heads", "2", "--dtype", "float32", "--batch_size", "4",
             "--microbatch", "2", "--pp_chunks", "2", "--prefetch_depth",
             "0", "--data_loader_workers", "0", "--ema_rate", "0.9",
             "--log_interval", "1", "--scan_layers", "true"]


@pytest.mark.parametrize("sched,extra", [
    ("1f1b", ["--eval_decode", "true", "--eval_interval", "1",
              "--save_interval", "2"]),
    ("gpipe", ["--model_family", "diffuseq", "--dataset",
               "synthetic-seq2seq", "--diffusion_steps", "50"]),
    ("interleaved", ["--pp_virtual", "2"])])
def test_run_train_pipe2_through_the_entry_point(tmp_path, sched, extra):
    """``run.train --distributed --nprocs 2 --pipe 2``: both ranks log the
    same losses and end with the same parameters; the sidecars hold the
    stage, the stash's peak and the exchange's gauges, and
    ``progress.csv`` ``pipe_p2p_s_per_step``. The 1F1B run's
    ``--eval_decode`` logs ``decode_acc`` (stage 0 decodes through the
    gathered weights) and its step-2 save resumes through ``run.train``
    at ``--pipe 1``."""
    run = tmp_path / "run"
    out = _train(tmp_path, "--distributed", "--nprocs", "2", "--pipe", "2",
                 *TINY_PIPE, "--pp_schedule", sched, "--learning_steps",
                 "2", "--checkpoint_path", str(run), *extra)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = _csv(run / "progress.csv")
    assert rows[-1]["loss"] == _csv(run / "progress-rank001.csv")[-1]["loss"]
    assert "pipe_p2p_s_per_step" in rows[-1]
    sides = [json.loads((run / name).read_text()) for name in
             ("train_summary.json", "train_summary-rank001.json")]
    assert sides[0]["params_sha256"] == sides[1]["params_sha256"]
    for r, side in enumerate(sides):
        pipe = side["pipe"]
        assert (pipe["index"], pipe["size"], pipe["schedule"]) == \
            (r, 2, sched)
        assert side["pipe_p2p_calls"] > 0 and side["pipe_bytes"] > 0
        assert side["mesh"]["pipe"] == 2
        assert side["history"] == sides[0]["history"]
    assert sides[0]["pipe"]["layers"] == (
        [0, 2] if sched == "interleaved" else [0, 1])
    if sched == "1f1b":
        assert sides[0]["pipe"]["stash_peak"] == stash_size(2, 2)
        # step 1's eval row lands in step 2's dump
        accs = [float(r["decode_acc"]) for r in rows if r.get("decode_acc")]
        assert accs and all(0.0 <= a <= 1.0 for a in accs)
        saved = torch.load(run / "model_000002.pt", weights_only=True)
        assert saved["backbone.blocks.wi"].shape[0] == LAYERS
        back = _train(tmp_path, *TINY_PIPE, "--learning_steps", "3",
                      "--checkpoint_path", str(run))
        assert back.returncode == 0, back.stderr[-4000:]
        assert "resumed from step 2" in (run / "log.txt").read_text()
        assert json.loads((run / "train_summary.json").read_text())[
            "steps"] == 3


# ------------------------------------------------------------ on the card

CUDA_PIPE = """
import json, sys
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
device = resolve_device("")
dist.setup_dist(device)
r = dist.get_rank()
pipe = dist.PipeGroup(None, (0, 1), r)
out = {"backend": dist.backend(), "exchange": {}}
for dtype in (torch.bfloat16, torch.float32):
    g = torch.Generator(device=device).manual_seed(3)
    frames = [torch.randn(2, 1024, 768, generator=g, device=device)
              .to(dtype) for _ in range(2)]
    got = dist.pipe_exchange(pipe, [(frames[r], 1, 0)],
                             [((2, 1024, 768), dtype, -1, 0)], device)[0]
    out["exchange"][str(dtype)] = (got.device == device
                                   and got.dtype == dtype
                                   and bool(torch.equal(got, frames[1 - r])))
cfg = dict(model_family="gpt2", vocab_size=256, seq_len=1024,
           hidden_size=128, num_layers=4, num_heads=2, dtype="bfloat16",
           attention_impl="auto", scan_layers=True, pp_schedule="1f1b",
           pp_chunks=4)
batch = next(load_data_from_args("train", batch_size=8,
                                 dataset="synthetic-lm", seq_len=1024,
                                 vocab_size=256, seed=0, shard=(0, 1)))
loop = TrainLoop(model=create_model_from_config(**cfg, device=device),
                 data=None, batch_size=8, microbatch=4, pipe=2,
                 init_params=init_params(cfg, 0), fused_update="true",
                 logger=Logger(""))
flash_attention.reset_launch_counts()
fused_update.reset_launch_count()
m = loop.run_step(batch)
torch.cuda.synchronize()
out.update(loss=float(m["loss"]), stash_peak=loop.pipe_ctx.stash_peak,
           launches=[flash_attention.forward_launch_count(),
                     flash_attention.backward_launch_count(),
                     fused_update.launch_count()],
           plain=[sum(flash_attention.plain_call_counts().values()),
                  fused_update.plain_call_count()],
           owned=loop.shard.own)
json.dump(out, open(f"{tmp}/cuda_{r}.json", "w"))
"""


@pytest.mark.cuda
def test_cuda_pipe_exchange_and_a_1f1b_step_on_one_card(tmp_path):
    """Two gloo ranks on ``cuda:0``: the pipe exchange through pinned host
    buffers hands over bf16 and f32 frames bitwise; one 1F1B step of a
    4-layer GPT-2 at L 1024 (2 layers a stage, 2 microbatches of 4
    one-row chunks) launches the flash forward 2 x 4 x 2 x 2 = 32 times a
    rank (the B slot recomputes its stage), the backward 16 and the fused
    update once over the rank's buffer, with no plain call; both ranks
    log the same loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.device_count() > 1:
        pytest.skip("the ranks would each take a card of their own")
    _spawn_ranks(tmp_path, CUDA_PIPE, 2, timeout=300)
    ranks = [json.loads((tmp_path / f"cuda_{r}.json").read_text())
             for r in range(2)]
    for side in ranks:
        assert side["backend"] == "gloo"
        assert all(side["exchange"].values()), side["exchange"]
        assert side["launches"] == [32, 16, 1]
        assert side["plain"] == [0, 0]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert [x["stash_peak"] for x in ranks] == [stash_size(4, 2), 1]
