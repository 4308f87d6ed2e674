"""The port's sequence parallelism against the JAX package's, on the CPU.

* ``flash_attention_lse`` (the plain arm, ``impl="torch"``): ``out``,
  ``lse`` and the gradients of ``<out, g_out> + <lse, g_lse>`` for a
  seeded ``(g_out, g_lse)``, against ``jax.vjp`` of the JAX
  ``flash_attention_lse`` in interpret mode (blocks 16/16), causal and
  not, with a fully masked row; a ``None`` lse cotangent is zeros;
* ``ring_attention`` on 2 and 4 spawned gloo ranks (each holding its L
  slice) against the JAX ``ring_attention_sharded`` on a ``dp=1,
  sequence=n`` mesh of host devices: outputs and q/k/v gradients, the
  flash hop and the dense hop, causal and pad-masked (a fully masked
  row, and slices of a row that are all padding);
* ``TrainLoop`` steps of each family on dp1 x sp2 and dp2 x sp2 ranks
  against the JAX ``TrainLoop`` on the matching mesh, with the JAX
  weights converted and the JAX draws handed in; the ranks' parameters
  bitwise equal;
* a GPT-2 batch whose only targets sit right after the slice boundary:
  held to the JAX loss, which a slice-local shift would miss;
* ``--remat`` under sp2 bitwise the run without it;
* ``run.train --distributed --nprocs 2 --sequence 2 --device cpu`` for
  both families, against one process on the same global batch;
* the dispatcher's choice under a sequence context, the loader's data
  group shard, and the parse-time refusals.

Tolerances: ``flash_attention_lse`` 1e-5 (f32, another summation order);
the ring at 2e-5 (outputs) and 5e-5 (gradients), the bars of
``tests/test_ring.py``; training losses and grad norms at rtol 1e-4
(``test_ring.py``'s sequence-parallel step). Ranks are real processes
running the port alone (``launcher._worker_env`` gives them torch's
``env://`` keys).
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
from distributed_pipeline_tpu.ops.flash_attention import \
    flash_attention_lse as jax_flash_lse  # noqa: E402
from distributed_pipeline_tpu.parallel import make_mesh  # noqa: E402
from distributed_pipeline_tpu.parallel.ring import \
    ring_attention_sharded  # noqa: E402
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch import data as port_data  # noqa: E402
from distributed_pipeline_tpu_torch.config.train import \
    parse_settings  # noqa: E402
from distributed_pipeline_tpu_torch.convert import \
    params_from_flax  # noqa: E402
from distributed_pipeline_tpu_torch.ops import attention as att  # noqa: E402
from distributed_pipeline_tpu_torch.ops import \
    flash_attention as fa  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import dist  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import launcher  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import ring  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, L, D, H, LAYERS, E = 64, 16, 32, 2, 2, 128
GB, GMB = 8, 4
LOOP = dict(lr=1e-3, ema_rate="0.9", learning_steps=1000,
            gradient_clipping=1.0, log_interval=10 ** 9,
            save_interval=10 ** 9)
STEPS = 2


def _cfg(fam: str) -> dict:
    cfg = dict(model_family=fam, vocab_size=V, seq_len=L, hidden_size=D,
               num_layers=LAYERS, num_heads=H, dtype="float32",
               attention_impl="auto")
    if fam == "diffuseq":
        cfg["diffusion_steps"] = 2000
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _start_ranks(tmp_path, body: str, world: int) -> list:
    """Start ``body`` (``sys.argv[1]`` is ``tmp_path``) as ``world`` rank
    processes."""
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
    return procs


def _spawn_ranks(tmp_path, body: str, world: int, timeout: float = 180.0,
                 procs: list = None) -> list:
    """Run ``body`` as ``world`` rank processes (or wait for ``procs``,
    started by ``_start_ranks``); each must exit 0."""
    if procs is None:
        procs = _start_ranks(tmp_path, body, world)
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    return outs


def _lens_mask(L_, lens):
    return (np.arange(L_)[None, :] < np.asarray(lens)[:, None]).astype(
        np.int32)


# ------------------------------------------------ flash_attention_lse

@pytest.mark.parametrize("causal,lens", [(False, None), (True, None),
                                         (False, [40, 0]), (True, [40, 13])])
def test_flash_attention_lse_values_and_gradients_match_jax(causal, lens):
    """out, lse and the gradients with a random lse cotangent, against
    the JAX kernel in interpret mode; a fully masked row has out 0, a
    finite lse near NEG_INF and zero gradients."""
    rng = np.random.default_rng(3 + causal)
    B, Hh, L_, Dh = 2, 2, 40, 16
    arrays = [rng.standard_normal((B, Hh, L_, Dh)).astype(np.float32)
              for _ in range(3)]
    g_out = rng.standard_normal((B, Hh, L_, Dh)).astype(np.float32)
    g_lse = rng.standard_normal((B, Hh, L_)).astype(np.float32)
    mask = None if lens is None else _lens_mask(L_, lens)
    jm = None if mask is None else jnp.asarray(mask)
    (jout, jlse), vjp = jax.vjp(
        lambda q, k, v: jax_flash_lse(q, k, v, jm, causal, 16, 16),
        *map(jnp.asarray, arrays))
    jgrads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    out, lse = fa.flash_attention_lse(*t, m, causal, impl="torch")
    ((out * torch.from_numpy(g_out)).sum()
     + (lse * torch.from_numpy(g_lse)).sum()).backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), **tol)
    for got, want in zip(t, jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **tol)
    if lens is not None and 0 in lens:
        dead = lens.index(0)
        assert torch.all(out[dead] == 0)
        assert torch.all(torch.isfinite(lse[dead]))
        assert float(lse[dead].detach().max()) < fa.NEG_INF / 2
        assert all(torch.all(x.grad[dead] == 0) for x in t)


def test_flash_attention_lse_without_lse_cotangent_is_flash_attention():
    """An unused lse subtracts nothing: the gradients of ``out`` alone
    equal ``flash_attention``'s and those of a zero lse cotangent, and
    the plain backward with ``g_lse`` subtracts it from delta."""
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
              for _ in range(3)]
    g = torch.from_numpy(rng.standard_normal((1, 2, 24, 16)).astype(
        np.float32))
    grads = []
    for how in ("out_only", "zero_g_lse", "flash_attention"):
        t = [torch.from_numpy(a).requires_grad_() for a in arrays]
        if how == "flash_attention":
            loss = (fa.flash_attention(*t, None, True) * g).sum()
        else:
            out, lse = fa.flash_attention_lse(*t, None, True)
            loss = (out * g).sum() + (0.0 * lse.sum()
                                      if how == "zero_g_lse" else 0.0)
        loss.backward()
        grads.append([x.grad for x in t])
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            assert torch.equal(a, b)
    t = [torch.from_numpy(a) for a in arrays]
    out, lse = fa.torch_flash_forward(*t, None, False)
    g_lse = torch.ones_like(lse)
    with_lse = fa.torch_flash_backward(*t, None, False, out, lse, g, g_lse)
    # g_lse = 1 everywhere: d lse_i / d s_ij = p_ij, so dv gains nothing
    # and dq gains sum_j p_ij k_j * scale
    plain = fa.torch_flash_backward(*t, None, False, out, lse, g)
    torch.testing.assert_close(with_lse[2], plain[2], rtol=0, atol=0)
    scale = 16 ** -0.5
    p = torch.softmax(torch.einsum("bhld,bhmd->bhlm", t[0], t[1]) * scale,
                      dim=-1)
    torch.testing.assert_close(
        with_lse[0] - plain[0],
        torch.einsum("bhlm,bhmd->bhld", p, t[1]) * scale,
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- ring attention

RING_CASES = [("flash", True, True), ("flash", False, True),
              ("dense", True, True), ("flash", True, False),
              ("dense", False, False)]
RB, RH, RL, RD = 3, 2, 32, 16
RING_LENS = [RL, 21, 0]

RANK_RING = """
import sys
import torch
from distributed_pipeline_tpu_torch.parallel import dist, ring
from distributed_pipeline_tpu_torch.utils.perf import EventTimer
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)
seq = dist.sequence_groups(dist.get_world_size())
timer = EventTimer()
n, i = seq.size, seq.index
Ls = spec["q"].shape[2] // n
sl = slice(i * Ls, (i + 1) * Ls)
results = []
for hop, causal, masked in spec["cases"]:
    t = [spec[k][:, :, sl].clone().requires_grad_() for k in "qkv"]
    mask = spec["mask"][:, sl].contiguous() if masked else None
    with ring.sequence_parallel(seq, timer):
        out = ring.ring_attention(*t, mask, causal,
                                  use_flash=hop == "flash")
    (out * spec["g"][:, :, sl]).sum().backward()
    results.append({"out": out.detach(),
                    "grads": [x.grad for x in t]})
torch.save({"results": results, "shift_calls": timer.calls,
            "plain": __import__(
                "distributed_pipeline_tpu_torch.ops.flash_attention",
                fromlist=["x"]).plain_call_counts()},
           f"{tmp}/ring{seq.index}.pt")
"""

_ring_runs: dict = {}


def _ring_run(tmp_path_factory, world: int) -> dict:
    """Every RING_CASES case on ``world`` gloo ranks (one launch a world
    size), gathered over L."""
    if world in _ring_runs:
        return _ring_runs[world]
    rng = np.random.default_rng(21)
    arrays = {k: rng.standard_normal((RB, RH, RL, RD)).astype(np.float32)
              for k in ("q", "k", "v", "g")}
    mask = _lens_mask(RL, RING_LENS)
    tmp = tmp_path_factory.mktemp(f"ring{world}")
    torch.save({**{k: torch.from_numpy(a) for k, a in arrays.items()},
                "mask": torch.from_numpy(mask), "cases": RING_CASES},
               tmp / "spec.pt")
    _spawn_ranks(tmp, RANK_RING, world)
    ranks = [torch.load(tmp / f"ring{r}.pt", weights_only=False)
             for r in range(world)]
    got = []
    for c in range(len(RING_CASES)):
        parts = [r["results"][c] for r in ranks]
        got.append({"out": torch.cat([p["out"] for p in parts], 2).numpy(),
                    "grads": [torch.cat([p["grads"][j] for p in parts],
                                        2).numpy() for j in range(3)]})
    _ring_runs[world] = {"arrays": arrays, "mask": mask, "got": got,
                         "ranks": ranks}
    return _ring_runs[world]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", range(len(RING_CASES)),
                         ids=["-".join(map(str, c)) for c in RING_CASES])
def test_ring_attention_matches_jax_ring(tmp_path_factory, world, case):
    """The port's ring over ``world`` gloo ranks against the JAX ring on
    a ``dp=1, sequence=world`` mesh: outputs 2e-5, q/k/v gradients
    5e-5."""
    run = _ring_run(tmp_path_factory, world)
    hop, causal, masked = RING_CASES[case]
    a = run["arrays"]
    jm = jnp.asarray(run["mask"]) if masked else None
    mesh = make_mesh(dp=1, sequence=world, devices=jax.devices()[:world])

    def f(q, k, v):
        with mesh:
            return ring_attention_sharded(q, k, v, jm, causal,
                                          use_flash=hop == "flash")

    @jax.jit
    def out_and_grads(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(g)

    out, grads = out_and_grads(*(jnp.asarray(a[k]) for k in "qkvg"))
    got = run["got"][case]
    np.testing.assert_allclose(got["out"], np.asarray(out), rtol=2e-5,
                               atol=2e-5)
    dead = RING_LENS.index(0)
    for name, mine, want in zip("qkv", got["grads"], grads):
        want = np.asarray(want)
        if masked:
            # the JAX ring's q and k gradients of the fully padded row are
            # NaN (ROADMAP C.13); the port's are zero, as the JAX flash
            # kernel's alone are (tests/test_torch_port_flash.py)
            assert np.isfinite(np.delete(want, dead, axis=0)).all()
            assert np.all(mine[dead] == 0), f"d{name}"
            mine, want = (np.delete(x, dead, axis=0) for x in (mine, want))
        np.testing.assert_allclose(mine, want, rtol=5e-5, atol=5e-5,
                                   err_msg=f"d{name}")


def test_ring_shifts_and_hop_calls(tmp_path_factory):
    """Each rank shifts n - 1 times a forward and as many a backward, in
    every case; under a causal mask rank i runs i + 1 flash hops (the
    later slices launch nothing), else n."""
    for world in (2, 4):
        run = _ring_run(tmp_path_factory, world)
        n_cases = len(RING_CASES)
        flash = [c for c in RING_CASES if c[0] == "flash"]
        for i, r in enumerate(run["ranks"]):
            assert r["shift_calls"] == 2 * (world - 1) * n_cases
            want = sum(i + 1 if causal else world for _, causal, _ in flash)
            assert r["plain"] == {"forward": want, "backward": want}, i


# ------------------------------------------------------------ training

RANK_TRAIN = """
import sys
import torch
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.models import gpt2 as gpt2_mod
from distributed_pipeline_tpu_torch.parallel import dist
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
tmp = sys.argv[1]
dist.setup_dist(torch.device("cpu"))
r = dist.get_rank()
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)
out = {}


def make_loop(case, remat=False):
    draws = case["draws"]
    return TrainLoop(
        model=create_model_from_config(**case["cfg"], device="cpu",
                                       remat=remat),
        data=None, init_params=case["params"], fused_update="false",
        checkpoint_dir="", batch_size=spec["batch_size"],
        microbatch=spec["microbatch"], sequence=spec["sp"],
        draws=(lambda s, i: draws[s][i]) if draws else None, **spec["loop"])


for fam, case in spec["cases"].items():
    loop = make_loop(case)
    d = loop.seq.data_index
    metrics = [{k: float(v) for k, v in loop.run_step(b).items()}
               for b in case["batches"][d]]
    loop.flush_metrics()
    out[fam] = {"metrics": metrics, "params": loop.params.clone(),
                "seq": (loop.seq.data_index, loop.seq.index, loop.seq.size,
                        loop.seq.dp), "global_batch": loop.global_batch,
                "shift_calls": loop.shift_time.calls}
    if spec["remat"]:
        again = make_loop(case, remat=True)
        for b in case["batches"][d]:
            again.run_step(b)
        again.flush_metrics()
        out[fam]["remat_params"] = again.params.clone()
if spec["boundary"] is not None:
    loop = make_loop(spec["cases"]["gpt2"])
    ev = loop.forward_only(spec["boundary"])
    slice_fn = gpt2_mod.gpt2_sequence_slice

    def local(batch, index, size):   # a slice-local shift
        got = slice_fn(batch, index, size)
        got["next_mask"] = torch.zeros_like(got["next_mask"])
        return got

    import distributed_pipeline_tpu_torch.models as models_mod
    models_mod.gpt2_sequence_slice = local
    out["boundary"] = {"ring": ev["eval_loss"],
                       "local": loop.forward_only(spec["boundary"])[
                           "eval_loss"]}
torch.save(out, f"{tmp}/train{r}.pt")
"""


def _group_rows(batch, d, dp):
    """Data group d's rows of a global batch: its share of each global
    microbatch (group 0's microbatch i, then group 1's, form global
    microbatch i)."""
    mb = GMB // dp
    idx = np.concatenate([np.arange(i * GMB + d * mb, i * GMB + (d + 1) * mb)
                          for i in range(GB // GMB)])
    return {k: v[idx] for k, v in batch.items()}


def _jax_draws(jloop, seed):
    base = jax.random.PRNGKey(seed)
    sched = jloop.workload.schedule
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


_train_runs: dict = {}


def _train_run(tmp_path_factory, dp: int, sp: int = 2) -> dict:
    """Both families' steps on dp x sp gloo ranks and on the JAX
    TrainLoop over the matching mesh (one launch a topology, running
    while JAX compiles); on dp1 x sp2 also the remat runs and the
    slice-boundary batch."""
    key = (dp, sp)
    if key in _train_runs:
        return _train_runs[key]
    tmp = tmp_path_factory.mktemp(f"train_dp{dp}_sp{sp}")
    mesh = make_mesh(dp=dp, sequence=sp, devices=jax.devices()[:dp * sp])
    cases, jloops, batches, boundary = {}, {}, {}, None
    for fam in ("gpt2", "diffuseq"):
        seed = 5
        jloop = JaxTrainLoop(
            model=jax_create(**_cfg(fam)), data=None, mesh=mesh, seed=seed,
            checkpoint_dir=str(tmp / f"jax_{fam}"), fused_update=False,
            batch_size=GB, microbatch=GMB, **LOOP)
        dataset = "synthetic-lm" if fam == "gpt2" else "synthetic-seq2seq"
        batches[fam] = [next(jax_data.load_data_from_args(
            "train", batch_size=GB, dataset=dataset, seq_len=L,
            vocab_size=V, seed=s, skip_batches=s)) for s in range(STEPS)]
        if fam == "gpt2":
            for b in batches[fam]:   # pad tails: the slices' counts differ
                b["pad_mask"] = _lens_mask(L, [L, 13, 9, L, 5, L, 11, 7])
            if dp == 1:
                # the only targets: the token right after the slice
                # boundary, predicted by slice 0's last position
                boundary = dict(batches[fam][0])
                boundary["input_mask"] = np.zeros_like(
                    boundary["input_mask"])
                boundary["input_mask"][:, L // sp] = 1
                boundary["pad_mask"] = np.ones_like(boundary["pad_mask"])
        jloops[fam] = jloop
        cases[fam] = {"cfg": _cfg(fam),
                      "params": params_from_flax(_np(jloop.state.params)),
                      "draws": (_jax_draws(jloop, seed) if fam == "diffuseq"
                                else None),
                      "batches": [[_group_rows(b, d, dp)
                                   for b in batches[fam]]
                                  for d in range(dp)]}
    torch.save({"cases": cases, "sp": sp, "batch_size": GB // dp,
                "microbatch": GMB // dp, "loop": LOOP,
                "remat": dp == 1, "boundary": boundary}, tmp / "spec.pt")
    procs = _start_ranks(tmp, RANK_TRAIN, dp * sp)
    jax_boundary = None
    if boundary is not None:
        jloop = jloops["gpt2"]
        jax_boundary = float(jax.jit(jloop.workload.compute_losses)(
            jloop.state.params, {k: jnp.asarray(v)
                                 for k, v in boundary.items()},
            jax.random.PRNGKey(0))["loss"])
    jax_metrics = {fam: [{k: float(v) for k, v in
                          jloops[fam].run_step(b).items()}
                         for b in batches[fam]] for fam in jloops}
    _spawn_ranks(tmp, RANK_TRAIN, dp * sp, procs=procs)
    ranks = [torch.load(tmp / f"train{r}.pt", weights_only=False)
             for r in range(dp * sp)]
    _train_runs[key] = {"ranks": ranks, "jax": jax_metrics,
                        "jax_boundary": jax_boundary}
    return _train_runs[key]


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("fam", ["gpt2", "diffuseq"])
def test_sequence_parallel_steps_match_jax_mesh(tmp_path_factory, dp, fam):
    """2 steps on dp x 2 ranks against the JAX TrainLoop on a dp x
    sequence=2 mesh: every rank logs the JAX losses and grad norm (rtol
    1e-4), the ranks' parameters are bitwise equal, and the rank geometry
    follows the mesh's order (data before sequence)."""
    run = _train_run(tmp_path_factory, dp)
    keys = (("loss", "nll", "acc") if fam == "gpt2"
            else ("loss", "mse", "tT", "decoder_nll"))
    for r, rank in enumerate(run["ranks"]):
        got = rank[fam]
        assert got["seq"] == (r // 2, r % 2, 2, dp)
        assert got["global_batch"] == GB
        # two layers, two microbatches, two steps: one shift a hop
        # forward and one backward
        assert got["shift_calls"] == 2 * LAYERS * 2 * STEPS
        assert torch.equal(got["params"], run["ranks"][0][fam]["params"])
        for s in range(STEPS):
            for k in keys + ("grad_norm",):
                np.testing.assert_allclose(
                    got["metrics"][s][k], run["jax"][fam][s][k], rtol=1e-4,
                    atol=1e-7, err_msg=f"rank {r} step {s} {k}")


@pytest.mark.parametrize("fam", ["gpt2", "diffuseq"])
def test_remat_under_sequence_parallelism_is_bitwise(tmp_path_factory, fam):
    """``remat`` replays each block's ring in the backward, in the same
    order on both ranks: the parameters after 2 steps are the run's
    without it, bit for bit."""
    run = _train_run(tmp_path_factory, 1)
    for rank in run["ranks"]:
        assert torch.equal(rank[fam]["remat_params"], rank[fam]["params"])


def test_gpt2_target_across_the_slice_boundary(tmp_path_factory):
    """Every row's only target is the first token of slice 1, predicted
    by slice 0's last position: the ranks' loss is the JAX loss, and a
    slice-local shift (which drops that target) is far from it."""
    run = _train_run(tmp_path_factory, 1)
    want = run["jax_boundary"]
    assert want > 1.0
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank["boundary"]["ring"], want,
                                   rtol=1e-4)
        assert abs(rank["boundary"]["local"] - want) > 0.5 * want


# ------------------------------------------------------- run.train CLI

def _run_train(tmp_path, name, extra, fam):
    run = tmp_path / name
    data = "synthetic-lm" if fam == "gpt2" else "synthetic-seq2seq"
    argv = [sys.executable, "-m", "distributed_pipeline_tpu_torch.run.train",
            "--device", "cpu", "--checkpoint_path", str(run),
            "--model_family", fam, "--dataset", data, "--seq_len", "32",
            "--vocab_size", "64", "--hidden_size", "32", "--num_layers", "2",
            "--num_heads", "2", "--dtype", "float32", "--batch_size", "4",
            "--microbatch", "2", "--learning_steps", "3", "--log_interval",
            "1", "--prefetch_depth", "0", "--seed", "3", *extra]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        launcher.AUTORUN_ENV_FLAG)}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = (run / "progress.csv").read_text().splitlines()
    head = lines[0].split(",")
    rows = [dict(zip(head, line.split(","))) for line in lines[1:]]
    sides = [json.loads((run / n).read_text()) for n in os.listdir(run)
             if n.startswith("train_summary")]
    return rows, sorted(sides, key=lambda d: d["rank"])


@pytest.mark.parametrize("fam", ["gpt2", "diffuseq"])
def test_run_train_sequence_two_ranks_on_the_cpu(tmp_path, fam):
    """``run.train --distributed --nprocs 2 --sequence 2 --device cpu``:
    one data group of two sequence ranks reads the rows one process
    reads, and its losses are that process's (rtol 1e-4), step by step
    (the sidecars' history) and as logged (a row holds the step before
    its own: the metrics stay ``dispatch_lag`` steps in flight at a log);
    the sidecars record the geometry, the ring's shifts and equal
    parameters."""
    rows, sides = _run_train(
        tmp_path, "sp", ["--distributed", "--nprocs", "2", "--sequence",
                         "2"], fam)
    one, one_sides = _run_train(tmp_path, "one", [], fam)
    assert len(rows) == len(one) == 3
    np.testing.assert_allclose(
        [h["loss"] for h in sides[0]["history"]],
        [h["loss"] for h in one_sides[0]["history"]], rtol=1e-4)
    assert [h["step"] for h in sides[1]["history"]] == [1, 2, 3]
    assert rows[0]["loss"] == one[0]["loss"] == ""
    for a, b in zip(rows, one):
        if b["loss"]:
            np.testing.assert_allclose(float(a["loss"]), float(b["loss"]),
                                       rtol=1e-4)
        assert float(a["ring_shift_s_per_step"]) > 0
    assert [(s["data_index"], s["sequence_index"], s["sequence"])
            for s in sides] == [(0, 0, 2), (0, 1, 2)]
    assert sides[0]["params_sha256"] == sides[1]["params_sha256"]
    assert all(s["global_batch"] == 4 and s["ring_shift_calls"] == 2 * 2 *
               2 * 3 for s in sides)
    causal = fam == "gpt2"
    # GPT-2: rank 0 runs only its diagonal hop, rank 1 both
    assert [s["plain_calls"]["flash_forward"] for s in sides] == \
        ([12, 24] if causal else [24, 24])


# ------------------------------------------- dispatch, data, settings

def test_auto_picks_ring_under_a_sequence_context(monkeypatch):
    """``impl="auto"`` rings inside a sequence context of more than one
    rank (the JAX rule under a sequence mesh), not in one of one rank or
    outside any; ``impl="ring"`` outside a context raises."""
    q, k, v = (torch.randn(1, 2, 8, 16) for _ in range(3))
    calls = []
    monkeypatch.setattr(ring, "ring_attention",
                        lambda *a, **kw: calls.append(a) or a[0])
    two = dist.SequenceGroups(None, (0, 1), 0, 2, 0, 1)
    one = dist.SequenceGroups(None, (0,), 0, 1, 0, 1)
    with ring.sequence_parallel(two):
        assert att.dot_product_attention(q, k, v, impl="auto") is q
        assert ring.sequence_offset(8) == 0
    assert len(calls) == 1
    with ring.sequence_parallel(one):
        att.dot_product_attention(q, k, v, impl="auto")
    att.dot_product_attention(q, k, v, impl="auto")
    assert len(calls) == 1
    monkeypatch.undo()
    with pytest.raises(ValueError, match="needs a sequence group"):
        att.dot_product_attention(q, k, v, impl="ring")
    with ring.sequence_parallel(dist.SequenceGroups(None, (0, 1), 1, 2, 0,
                                                    1)):
        assert ring.sequence_offset(8) == 8
    assert ring.current_sequence() is None


@pytest.mark.parametrize("impl", ["xla", "cuda", "pallas", "torch"])
def test_other_arms_refuse_a_sequence_context(impl):
    """Inside a sequence context of more than one rank every arm but the
    ring raises: it would attend to this rank's L slice alone (the JAX
    arms see global arrays). A context of one rank leaves them alone."""
    q, k, v = (torch.randn(1, 2, 8, 16) for _ in range(3))
    with ring.sequence_parallel(dist.SequenceGroups(None, (0, 1), 0, 2, 0,
                                                    1)):
        with pytest.raises(ValueError, match="only the ring"):
            att.dot_product_attention(q, k, v, impl=impl)
    if impl in ("xla", "torch"):
        with ring.sequence_parallel(dist.SequenceGroups(None, (0,), 0, 1,
                                                        0, 1)):
            want = att.dot_product_attention(q, k, v, impl=impl)
        torch.testing.assert_close(
            want, att.dot_product_attention(q, k, v, impl=impl))


@pytest.mark.parametrize("d", [0, 1])
def test_data_group_shard_is_the_jax_process_shard(d, monkeypatch):
    """``shard=(d, dp)`` streams the JAX loader's process d of dp, so the
    sequence ranks of a data group read the same rows."""
    kw = dict(batch_size=2, dataset="synthetic-lm", seq_len=L,
              vocab_size=V, seed=4)
    monkeypatch.setattr(jax, "process_index", lambda: d)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    want = jax_data.load_data_from_args("train", **kw)
    got = port_data.load_data_from_args("train", shard=(d, 2), **kw)
    for _ in range(3):
        a, b = next(got), next(want)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("world,argv,expect", [
    ("1", ["--sequence", "2"], "must divide the world size"),
    ("4", ["--sequence", "2", "--dp", "4"], "dp * sequence"),
    ("2", ["--sequence", "2", "--seq_len", "33"], "not divisible"),
    ("2", ["--sequence", "2", "--moe_experts", "4"], "ROADMAP A.8e"),
    ("2", ["--sequence", "2", "--eval_decode", "true"], "ROADMAP A.8f"),
    ("2", ["--sequence", "3"], "must divide the world size"),
    ("4", ["--sequence", "2", "--dp", "1"], "dp * sequence"),
    ("2", ["--sequence", "2", "--attention_impl", "xla"], "only the ring"),
    ("2", ["--sequence", "2", "--attention_impl", "cuda"], "only the ring"),
    ("2", ["--sequence", "2", "--attention_impl", "torch"],
     "only the ring")])
def test_sequence_refusals_at_parse_time(world, argv, expect, monkeypatch,
                                         capsys):
    """Each case is refused with its message, but for the refusals a
    later slice lifted (MoE and the decode callback under a sequence
    group, ROADMAP A.8e and A.8f): those settings parse."""
    monkeypatch.setenv("WORLD_SIZE", world)
    if expect in ("ROADMAP A.8e", "ROADMAP A.8f"):
        assert parse_settings(argv).sequence == 2
        return
    # the mesh of dp, fsdp and sequence is checked as a whole since the
    # sharded state came (ROADMAP A.8c), with the JAX mesh's message
    expect = {"dp * sequence": "must multiply to the world size"}.get(
        expect, expect)
    with pytest.raises(SystemExit) as e:
        parse_settings(argv)
    assert e.value.code == 2
    assert expect in capsys.readouterr().err


def test_sequence_settings_that_parse(monkeypatch):
    """--sequence 2 over 2 and 4 ranks (dp -1 resolves to the rest),
    --remat and --attention_impl ring with it."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    s = parse_settings(["--sequence", "2", "--remat", "true",
                        "--attention_impl", "ring", "--dp", "2"])
    assert (s.sequence, s.dp, s.remat) == (2, 2, True)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert parse_settings(["--sequence", "2"]).sequence == 2


# ------------------------------------------------------------ the card

RANK_RING_CUDA = """
import sys
import torch
from distributed_pipeline_tpu_torch.ops import flash_attention as fa
from distributed_pipeline_tpu_torch.parallel import dist, ring
tmp = sys.argv[1]
dev = torch.device("cuda", 0)
dist.setup_dist(dev)
spec = torch.load(f"{tmp}/spec.pt", weights_only=False)
seq = dist.sequence_groups(2)
Ls = spec["q"].shape[2] // 2
sl = slice(seq.index * Ls, (seq.index + 1) * Ls)
out = {"backend": dist.backend(), "cases": []}
for causal in (True, False):
    t = [spec[k][:, :, sl].to(dev).contiguous().requires_grad_()
         for k in "qkv"]
    mask = spec["mask"][:, sl].to(dev).contiguous()
    fa.reset_launch_counts()
    with ring.sequence_parallel(seq):
        o = ring.ring_attention(*t, mask, causal)
    (o.float() * spec["g"][:, :, sl].to(dev)).sum().backward()
    torch.cuda.synchronize()
    out["cases"].append({
        "out": o.detach().cpu(), "grads": [x.grad.cpu() for x in t],
        "launches": (fa.forward_launch_count(), fa.backward_launch_count(),
                     fa.lse_backward_launch_count()),
        "plain": fa.plain_call_counts()})
torch.save(out, f"{tmp}/cuda{seq.index}.pt")
"""


@pytest.mark.cuda
def test_cuda_ring_on_two_ranks_sharing_the_card(tmp_path):
    """Two gloo ranks on ``cuda:0`` (K/V staged through host memory) ring
    bf16 attention through the flash kernels at GPT-2's hop shape (L 1024
    in two slices of 512, Dh 64), causal and not, pad-masked: against the
    plain version over the whole sequence in f32 from the same bf16
    inputs, at the bf16 bars of ``tests/test_torch_port_flash.py``; rank 0
    launches only its diagonal hop under the causal mask, rank 1 both, and
    every backward takes the lse cotangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    B, Hh, L_, Dh = 2, 4, 1024, 64
    g = torch.Generator().manual_seed(0)
    spec = {k: torch.randn((B, Hh, L_, Dh), generator=g).to(torch.bfloat16)
            for k in "qkv"}
    spec["g"] = torch.randn((B, Hh, L_, Dh), generator=g)
    spec["mask"] = torch.from_numpy(_lens_mask(L_, [L_, 700]))
    torch.save(spec, tmp_path / "spec.pt")
    _spawn_ranks(tmp_path, RANK_RING_CUDA, 2, timeout=300)
    ranks = [torch.load(tmp_path / f"cuda{r}.pt", weights_only=False)
             for r in range(2)]
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    f = [spec[k].float().requires_grad_() for k in "qkv"]
    for c, causal in enumerate((True, False)):
        for r, rank in enumerate(ranks):
            n = r + 1 if causal else 2
            assert rank["cases"][c]["launches"] == (n, n, n)
            assert rank["cases"][c]["plain"] == {"forward": 0, "backward": 0}
        ref = fa.flash_attention(*f, spec["mask"], causal, impl="torch")
        grads = torch.autograd.grad(ref, f, spec["g"])
        got = torch.cat([r["cases"][c]["out"] for r in ranks], 2).float()
        torch.testing.assert_close(got, ref.detach(), rtol=8e-3,
                                   atol=1e-3 * float(ref.abs().max()))
        for j, want in enumerate(grads):
            mine = torch.cat([r["cases"][c]["grads"][j] for r in ranks],
                             2).float()
            torch.testing.assert_close(
                mine, want, rtol=1e-2,
                atol=max(1e-2 * float(want.abs().max()), 1e-4))
            assert float((mine - want).norm()) <= 1e-2 * float(want.norm())
