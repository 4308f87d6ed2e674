"""The pipe axis composed with the rest of the mesh, on four spawned gloo
ranks on the CPU, against the JAX package.

Tiny models (vocab 64, seq 16, hidden 32, 4 layers, 2 heads, f32; MoE: 4
experts top-2, ``moe_every`` 2), weights from ``convert.init_params``,
global batch 8 in global microbatches of 4, ``pp_chunks`` 2. The
reference is the JAX pure-data-parallel run over the same global batches
(one device: the JAX trainer's step written out, ``_jax_reference``; the
JAX DiffuSeq draws injected through the ``draws`` hook): the identity
JAX's own tests pin for these compositions (``tests/test_pipeline.py``:
pipe x fsdp, pipe x sequence and MoE x pipe against pure dp at rtol
2e-5), chosen because the JAX compiles of the composed meshes, and of
four JAX ``TrainLoop`` s, do not fit this file's budget.
One spawn of four ranks runs every configuration while the parent builds
the JAX references:

* ``{fsdp 2, pipe 2}`` (ZeRO-3 inside a stage) x {gpipe, 1f1b} x remat
  {off, on}, ``{dp 2, pipe 2}`` with ``--shard_optimizer``, ``{sequence
  2, pipe 2}`` (the ring inside a stage, on the GPipe stream) and MoE on
  ``{dp 2, pipe 2}`` (the GPipe stream; a 1F1B request falls back to it),
  both families: two steps' losses (and ``moe_aux``) against the JAX run
  (loss rtol 2e-5 as the JAX invariance tests, ``moe_aux`` rtol 1e-5 as
  the MoE trainer parity test), every rank logging the same; the step-1
  gradient gathered to full stacked tensors against ``jax.grad`` (rtol
  5e-4, atol 1e-6, the pipe-run test's bar); the fused update's elements
  a rank, weighted by the ranks that hold the same values, summing to
  the model's parameter count;
* the written-out reference against the JAX ``TrainLoop`` itself (GPT-2,
  two steps, rtol 1e-6);
* the sequence ring's partners from the mesh: ranks 0 and 2, 1 and 3;
* the ``--scan_layers`` MoE model at pipe 1 in the parent against the
  same JAX MoE runs;
* a ``{fsdp 2, pipe 2}`` save resumed at pipe 1 (full stacked tensors),
  and a pipe-1 save resumed at ``{fsdp 2, pipe 2}``, each continuing the
  saving run's next step;
* ``run.train --distributed --nprocs 4 --pipe 2 --fsdp 2`` once: the
  sidecars' stage unit, gathers and equal losses and parameters.
"""

import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction

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
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    init_params, params_from_flax, params_to_flax)
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import launcher  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import \
    TrainLoop  # noqa: E402
from tests.test_torch_port_dist import REPO, _csv, _train  # noqa: E402

V, L, D, H, LAYERS, E = 64, 16, 32, 2, 4, 128
GB, GMB, M, STEPS = 8, 4, 2, 2
MOE = dict(moe_experts=4, moe_top_k=2, moe_every=2)
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
FAMS = sorted(CFGS)
KINDS = ("dense", "moe")
# name -> (family, kind, mesh, model overrides)
CASES = {}
for _fam in FAMS:
    for _sched in ("gpipe", "1f1b"):
        for _remat in (False, True):
            CASES[f"fsdp-{_fam}-{_sched}-{'remat' if _remat else 'plain'}"] \
                = (_fam, "dense", dict(fsdp=2),
                   dict(pp_schedule=_sched, remat=_remat))
    CASES[f"zero1-{_fam}"] = (_fam, "dense",
                              dict(dp=2, shard_optimizer=True),
                              dict(pp_schedule="1f1b"))
    # the ring needs the seam's ring arm ("auto" inside a sequence context)
    CASES[f"seq-{_fam}"] = (_fam, "dense", dict(sequence=2),
                            dict(pp_schedule="gpipe", attention_impl="auto"))
    CASES[f"moe-{_fam}"] = (_fam, "moe", dict(dp=2),
                            dict(pp_schedule="gpipe", **MOE))
CASES["moe-gpt2-1f1b"] = ("gpt2", "moe", dict(dp=2),
                          dict(pp_schedule="1f1b", **MOE))

RANKS = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
r = dist.get_rank()
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)

def make(name, run="", resume=""):
    fam, kind, mesh, over = spec["cases"][name]
    draws = spec["draws"].get((fam, kind))
    rows = mesh.get("dp", 1) * mesh.get("fsdp", 1)
    loop = TrainLoop(
        model=create_model_from_config(**{**spec["cfgs"][fam], **over},
                                       pp_chunks=spec["chunks"],
                                       device="cpu"),
        data=None, init_params=spec["params"][(fam, kind)],
        fused_update="false", pipe=2, checkpoint_dir=run,
        resume_checkpoint=resume, batch_size=spec["gb"] // rows,
        microbatch=spec["gmb"] // rows, seed=5,
        draws=(lambda s, i: draws[s][i]) if draws else None, **mesh,
        **spec["loop"])
    return fam, loop

def part(loop, batch):
    # the rows of this rank's row group: its share of each global
    # microbatch (row group 0's, then 1's, form global microbatch i)
    row, rows = loop.mesh.rows()
    mb = spec["gmb"] // rows
    idx = np.concatenate([np.arange(i * spec["gmb"] + row * mb,
                                    i * spec["gmb"] + (row + 1) * mb)
                          for i in range(spec["gb"] // spec["gmb"])])
    return {k: v[idx] for k, v in batch.items()}

def full(loop, buf):
    shard = loop.shard
    local = buf
    if shard.zero1:
        local = buf.new_empty(shard.m_pad)
        dist.all_gather(local, loop._owned(buf), loop.mesh.group("data"))
    return loop.state_dict_of(shard.gather_full(
        local, local.new_empty(shard.n), loop.mesh.group("fsdp"),
        pipe_group=loop.pipe.group).clone())

out = {}
for name in spec["cases"]:
    run = f"{tmp}/{name}" if name == "fsdp-gpt2-1f1b-plain" else ""
    fam, loop = make(name, run)
    batches = spec["batches"][fam]
    loop.forward_backward(part(loop, batches[0]))
    res = {"grads": full(loop, loop.grads), "seq": loop.seq.ranks,
           "pipe_ranks": loop.pipe.ranks, "schedule": loop.pipe_ctx.schedule,
           "layout": loop.shard.describe(), "n": loop.shard.n,
           "mesh": loop.mesh.shape,
           "share": loop.update_share(),
           "gathered": loop.fsdp.gathered_bytes if loop.fsdp else 0}
    res["metrics"] = [{k: float(v) for k, v in loop.run_step(
        part(loop, b)).items()} for b in batches[:2]]
    if run:
        loop.save()
        res["step3"] = float(loop.run_step(part(loop, batches[2]))["loss"])
    out[name] = res
fam, loop = make("fsdp-gpt2-1f1b-plain", resume=spec["resume"])
out["resumed"] = {"step": loop.step, "step3": float(loop.run_step(
    part(loop, spec["batches"]["gpt2"][2]))["loss"])}
torch.save(out, f"{tmp}/rank{r}.pt")
"""


def _start_ranks(tmp_path, body: str, world: int):
    """Start ``world`` rank processes running ``body`` (``sys.argv[1]`` is
    ``tmp_path``); returns a function that waits for them and asserts
    each exited 0 (the parent works meanwhile)."""
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

    def wait(timeout: float = 300.0):
        try:
            outs = [p.communicate(timeout=timeout)[0].decode()
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r}:\n{out}"
    return wait


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _batches(fam, n=3):
    name = "synthetic-lm" if fam == "gpt2" else "synthetic-seq2seq"
    return [next(jax_data.load_data_from_args(
        "train", batch_size=GB, dataset=name, seq_len=L, vocab_size=V,
        seed=s, skip_batches=s)) for s in range(n)]


def _cfg(fam, kind):
    return dict(CFGS[fam], **(MOE if kind == "moe" else {}))


def _jax_draws(sched, steps):
    """The JAX loop's DiffuSeq draws (seed 5), global microbatch by
    microbatch."""
    base = jax.random.PRNGKey(5)
    draws = {}
    for s in range(steps):
        for i in range(GB // GMB):
            key = jax.random.fold_in(jax.random.fold_in(base, s), i)
            rng_t, rng_noise = jax.random.split(key)
            draws.setdefault(s, {})[i] = {
                "t": torch.from_numpy(np.array(sched.sample_t(rng_t, GMB))),
                "noise": torch.from_numpy(np.array(jax.random.normal(
                    rng_noise, (GMB, L, E), jnp.float32)))}
    return draws


def _jax_reference(fam, kind, params, batches):
    """The JAX pure-data-parallel run, the JAX trainer's step written out
    (its ``micro_scan`` and ``train_step`` with ``fused_update=False``):
    ``jax.value_and_grad`` of the JAX loss on each global microbatch with
    the loop's key ``fold_in(fold_in(PRNGKey(5), step), i)``, averaged,
    clipped by the global norm and applied through the ``optax.adamw`` of
    its ``_make_optimizer``. Returns each step's metrics and step 1's
    gradient."""
    import optax
    wl = jax_create(**_cfg(fam, kind))
    p = jax.tree_util.tree_map(jnp.asarray, params_to_flax(params))
    vg = None
    lr, total = LOOP["lr"], LOOP["learning_steps"]
    opt = optax.adamw(lambda c: lr * jnp.maximum(0.0, 1.0 - c / total),
                      b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    state, metrics, grads0 = opt.init(p), [], None
    n = GB // GMB
    for s, batch in enumerate(batches[:STEPS]):
        gs, ds = [], []
        for i in range(n):
            mb = {k: jnp.asarray(v[i * GMB:(i + 1) * GMB])
                  for k, v in batch.items()}
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(5), s), i)
            if vg is None:
                # a tiny graph: XLA's backend passes cost more than they
                # save (the values agree to the last bits)
                vg = jax.jit(jax.value_and_grad(
                    lambda q, mb_, k: (lambda d: (d["loss"], d))(
                        wl.compute_losses(q, mb_, k)), has_aux=True)).lower(
                    p, mb, key).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
            (_, d), g = vg(p, mb, key)
            gs.append(g)
            ds.append(d)
        g = jax.tree_util.tree_map(lambda *x: sum(x) / n, *gs)
        metrics.append({k: float(sum(d[k] for d in ds) / n) for k in ds[0]})
        if s == 0:
            grads0 = params_from_flax(_np(g))
        scale = jnp.minimum(1.0, LOOP["gradient_clipping"]
                            / (optax.global_norm(g) + 1e-6))
        g = jax.tree_util.tree_map(lambda x: x * scale, g)
        updates, state = opt.update(g, state, p)
        p = optax.apply_updates(p, updates)
    return metrics, grads0


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    """Every configuration on four gloo ranks, the JAX pure-dp runs and
    gradients, the pipe-1 stacked MoE loops, and the saves the ranks and
    the parent resume."""
    tmp = tmp_path_factory.mktemp("compose")
    params, draws, batches = {}, {}, {}
    for fam in FAMS:
        batches[fam] = _batches(fam)
        for kind in KINDS:
            params[(fam, kind)] = init_params(_cfg(fam, kind), 3)
            if fam == "diffuseq":
                draws[(fam, kind)] = _jax_draws(
                    jax_create(**_cfg(fam, kind)).schedule, 3)
    # a pipe-1 stacked save at step 2, for the ranks to resume
    one = TrainLoop(model=create_model_from_config(**CFGS["gpt2"],
                                                   device="cpu"),
                    data=None, init_params=params[("gpt2", "dense")],
                    fused_update="false", checkpoint_dir=str(tmp / "one"),
                    batch_size=GB, microbatch=GMB, seed=5, **LOOP)
    for b in batches["gpt2"][:2]:
        one.run_step(b)
    one.save()
    one_step3 = float(one.run_step(batches["gpt2"][2])["loss"])
    torch.save({"cfgs": CFGS, "params": params, "draws": draws,
                "batches": batches, "cases": CASES, "loop": LOOP,
                "gb": GB, "gmb": GMB, "chunks": M,
                "resume": str(tmp / "one" / "model_000002.pt")},
               tmp / "spec.pt")
    wait = _start_ranks(tmp, RANKS, 4)

    def reference(key):
        """The JAX run's two steps and step-1 gradient, and the pipe-1
        stacked MoE loop over the same batches (a thread each: the JAX
        compiles run beside each other and beside the ranks)."""
        fam, kind = key
        out = dict(zip(("jax", "grads"), _jax_reference(
            fam, kind, params[key], batches[fam])))
        if kind == "moe":
            d = draws.get(key)
            loop = TrainLoop(model=create_model_from_config(
                **_cfg(fam, kind), device="cpu"), data=None,
                init_params=params[key], fused_update="false",
                batch_size=GB, microbatch=GMB, seed=5,
                draws=(lambda s, i: d[s][i]) if d else None, **LOOP)
            out["scan"] = [{k: float(v) for k, v in loop.run_step(b).items()}
                           for b in batches[fam][:STEPS]]
        return out

    def trainloop():
        """The written-out step against the JAX ``TrainLoop`` itself
        (GPT-2, dense) from the loop's own initial weights: both runs'
        two steps."""
        jloop = JaxTrainLoop(
            model=jax_create(**CFGS["gpt2"]), data=None,
            mesh=make_mesh(dp=1, devices=jax.devices()[:1]), seed=5,
            checkpoint_dir=str(tmp / "jax_trainloop"), fused_update=False,
            batch_size=GB, microbatch=GMB, **LOOP)
        written, _ = _jax_reference("gpt2", "dense", params_from_flax(
            _np(jloop.state.params)), batches["gpt2"])
        return {"written": written,
                "trainloop": [{k: float(v) for k, v in jloop.run_step(
                    b).items()} for b in batches["gpt2"][:STEPS]]}

    keys = [(fam, kind) for fam in FAMS for kind in KINDS]
    with ThreadPoolExecutor(len(keys) + 1) as pool:
        check = pool.submit(trainloop)
        refs = dict(zip(keys, pool.map(reference, keys)))
        held = check.result()
    jax_metrics = {k: r["jax"] for k, r in refs.items()}
    jax_grads = {k: r["grads"] for k, r in refs.items()}
    scan = {k[0]: r["scan"] for k, r in refs.items() if "scan" in r}
    wait()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return {"tmp": tmp, "ranks": ranks, "jax": jax_metrics, "held": held,
            "grads": jax_grads, "scan": scan, "one_step3": one_step3,
            "batches": batches, "params": params}


def test_the_reference_is_the_jax_trainloop(composed):
    """The written-out JAX step (``_jax_reference``) gives the JAX
    ``TrainLoop``'s two steps from the same weights: the loss, the grad
    norm and the learning rate (rtol 1e-6: the loop scans its
    microbatches where the reference loops over them)."""
    got, want = composed["held"]["written"], composed["held"]["trainloop"]
    for k in ("loss", "nll", "acc"):
        np.testing.assert_allclose([m[k] for m in got],
                                   [m[k] for m in want], rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compositions_match_jax(composed, name):
    """Two steps' losses (and ``moe_aux``) against the JAX pure-dp run on
    every rank, every rank logging the same; the step-1 gradient gathered
    to full stacked tensors against ``jax.grad``."""
    fam, kind, _mesh, over = CASES[name]
    want = composed["jax"][(fam, kind)]
    ranks = [r[name] for r in composed["ranks"]]
    for r, res in enumerate(ranks):
        got = res["metrics"]
        np.testing.assert_allclose([m["loss"] for m in got],
                                   [m["loss"] for m in want], rtol=2e-5,
                                   err_msg=f"{name} rank {r}")
        if kind == "moe":
            np.testing.assert_allclose([m["moe_aux"] for m in got],
                                       [m["moe_aux"] for m in want],
                                       rtol=1e-5, err_msg=f"{name} rank {r}")
        assert got == ranks[0]["metrics"]
    # MoE stages and rings inside a stage take the GPipe stream
    assert ranks[0]["schedule"] == ("gpipe" if kind == "moe"
                                    or name.startswith("seq")
                                    else over["pp_schedule"])
    for key, ref in composed["grads"][(fam, kind)].items():
        got = ranks[0]["grads"][key]
        assert got.shape == ref.shape, key
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=5e-4,
                                   atol=1e-6, err_msg=f"{name} {key}")
        for res in ranks[1:]:
            assert torch.equal(res["grads"][key], got), key


@pytest.mark.parametrize("name", sorted(CASES))
def test_update_elements_sum_to_the_model(composed, name):
    """Each rank's fused-update elements, each divided by the ranks that
    update the same values, sum over the ranks to the parameter count;
    under fsdp the stage slice is cut (a stage unit of 2 rows, the JAX
    per-layer gather) and gathered; ZeRO-1 owns a data-th."""
    ranks = [r[name] for r in composed["ranks"]]
    assert sum(res["share"] for res in ranks) == ranks[0]["n"]
    lay = ranks[0]["layout"]
    if name.startswith("fsdp"):
        assert lay["stage_unit_elements"] > 0 and lay["pipe_layers"] in (
            [0, 1], [2, 3])
        assert all(res["gathered"] > 0 for res in ranks)
    if name.startswith("zero1"):
        assert lay["owned"] * 2 == lay["local_padded"]


def test_sequence_partners_come_from_the_mesh(composed):
    """Under ``{sequence 2, pipe 2}`` the pipe axis is the faster: ranks 0
    and 1 are pipe partners, 0 and 2 ring together (the JAX mesh's
    ``sequence`` axis), on the spawned ranks and from ``RankMesh``."""
    sizes = pmesh.resolve_axis_sizes(dp=1, sequence=2, pipe=2, n_devices=4)
    grid = np.arange(4).reshape(sizes)
    for r, res in enumerate(composed["ranks"]):
        seq = res["seq-gpt2"]
        assert seq["seq"] == ((0, 2) if r % 2 == 0 else (1, 3))
        assert seq["pipe_ranks"] == ((0, 1) if r < 2 else (2, 3))
        m = pmesh.RankMesh(sizes, r, pmesh.rank_coords(r, sizes), {})
        assert m.sequence_groups().ranks == seq["seq"] == tuple(
            int(x) for x in grid[0, 0, :, 0, 0, r % 2])
        assert m.sequence_groups().index == r // 2


@pytest.mark.parametrize("fam", FAMS)
def test_scan_moe_at_pipe1_matches_jax(composed, fam):
    """``--scan_layers`` MoE at pipe 1 (one process): two steps' ``loss``
    and ``moe_aux`` against the JAX run (rtol 2e-5, 1e-5)."""
    got, want = composed["scan"][fam], composed["jax"][(fam, "moe")]
    for k, rtol in (("loss", 2e-5), ("moe_aux", 1e-5)):
        np.testing.assert_allclose([m[k] for m in got],
                                   [m[k] for m in want], rtol=rtol,
                                   err_msg=k)


def test_fsdp_pipe_saves_resume_across_layouts(composed):
    """The ``{fsdp 2, pipe 2}`` save holds full stacked tensors: a
    one-process loop restores it and its step 3 is the ranks' (rtol
    2e-5); the ranks resumed a pipe-1 save and continued it likewise."""
    tmp = composed["tmp"]
    name = "fsdp-gpt2-1f1b-plain"
    saved = torch.load(tmp / name / "model_000002.pt", weights_only=True)
    assert saved["backbone.blocks.qkv"].shape[0] == LAYERS
    one = TrainLoop(model=create_model_from_config(**CFGS["gpt2"],
                                                   device="cpu"),
                    data=None, fused_update="false",
                    checkpoint_dir=str(tmp / name), batch_size=GB,
                    microbatch=GMB, seed=5, **LOOP)
    assert one.step == 2
    for k, v in one.state_dict_of(one.params).items():
        assert torch.equal(v, saved[k]), k
    step3 = float(one.run_step(composed["batches"]["gpt2"][2])["loss"])
    for res in composed["ranks"]:
        np.testing.assert_allclose(res[name]["step3"], step3, rtol=2e-5)
        assert res["resumed"]["step"] == 2
        np.testing.assert_allclose(res["resumed"]["step3"],
                                   composed["one_step3"], rtol=2e-5)


TINY = ["--device", "cpu", "--dataset", "synthetic-lm", "--model_family",
        "gpt2", "--seq_len", "16", "--vocab_size", "64", "--hidden_size",
        "32", "--num_layers", "4", "--num_heads", "2", "--dtype", "float32",
        "--batch_size", "4", "--microbatch", "2", "--pp_chunks", "2",
        "--prefetch_depth", "0", "--data_loader_workers", "0",
        "--ema_rate", "0.9", "--log_interval", "1", "--scan_layers", "true"]


def test_run_train_pipe2_fsdp2_through_the_entry_point(tmp_path):
    """``run.train --distributed --nprocs 4 --pipe 2 --fsdp 2``: every rank
    logs the same losses and ends with the same parameters; each sidecar
    holds the mesh, its stage's layers, the stage unit and the gathers."""
    run = tmp_path / "run"
    out = _train(tmp_path, "--distributed", "--nprocs", "4", "--pipe", "2",
                 "--fsdp", "2", *TINY, "--pp_schedule", "1f1b",
                 "--learning_steps", "2", "--checkpoint_path", str(run),
                 timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    names = ["train_summary.json"] + [f"train_summary-rank{r:03d}.json"
                                      for r in (1, 2, 3)]
    sides = [json.loads((run / n).read_text()) for n in names]
    rows = _csv(run / "progress.csv")
    assert rows[-1]["loss"] == _csv(run / "progress-rank003.csv")[-1]["loss"]
    for r, side in enumerate(sides):
        assert side["mesh"]["fsdp"] == 2 and side["mesh"]["pipe"] == 2
        assert side["pipe"]["layers"] == ([0, 1] if r % 2 == 0 else [2, 3])
        assert side["layout"]["stage_unit_elements"] > 0
        assert side["fsdp_gathers"] > 0 and side["fsdp_gathered_bytes"] > 0
        assert side["params_sha256"] == sides[0]["params_sha256"]
        assert side["history"] == sides[0]["history"]
    assert os.path.exists(run / "model_000002.pt")
    # the shares weighted by their copies sum to the model
    assert sum(Fraction(s["update_share"]) for s in sides) == \
        sides[0]["layout"]["n"]
