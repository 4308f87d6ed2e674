"""The port's stacked layers and pipeline schedule functions against the
JAX package's, in one process on the CPU (vocab 64, seq 16, hidden 32, 4
layers, 2 heads, f32):

* ``block_fwd`` (causal and bidirectional, pad-masked) and ``stage_apply``
  (with and without remat) against the JAX functions, rtol 2e-5;
* ``stash_size`` over a grid, ``_slot_indices`` at every ``(t, sid)`` of
  (S, M, V) in {(2,4,1), (4,8,1), (2,4,2), (4,8,2)} exactly, and the
  frame plan derived from it: every frame a stage sends is one its
  neighbour's next slot receives, and no slot waits for one that is not
  sent; the interleaved layer assignment (``stage_layers``) against the
  JAX ``_interleave_stack`` exactly;
* the JAX stacked tree (``params/backbone/blocks/...``) through the port's
  stacked model and back, bitwise; named <-> stacked blocks bitwise;
* the stacked and the named-block model on the same converted weights:
  the forward, the loss and three ``TrainLoop`` steps bitwise; greedy
  ``gpt2_decode`` (the dense cache) token-identical to the JAX stacked
  model's;
* the ``--scan_layers`` pipe-1 ``TrainLoop`` against the JAX scan-layers
  ``TrainLoop`` for 3 steps on both families (the JAX DiffuSeq draws
  injected): losses rtol 2e-5, parameters after 3 steps within
  ``PARAM_RTOL`` / ``PARAM_ATOL`` (the trainer parity tests' bar);
* a stacked checkpoint resumed by a named-block loop and the reverse;
* the parse-time refusals (the JAX ``--pipe`` and ``moe_stacked_specs``
  messages, A.8g, the MPMD stages' dense slice), the compositions that
  parse (pipe x fsdp, x ZeRO-1, x sequence, MoE scan blocks) and the
  ``DEFERRED`` table; ``RankMesh.rows`` and the pipe groups under a pipe
  axis; ``run.serve`` refusing a stacked run dir with the JAX message,
  ``run.sample`` decoding one through ``gpt2_decode``.

The spawned-rank runs of ``--pipe 2`` are ``test_torch_port_pipe_run.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu import data as jax_data  # noqa: E402
from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.models import pipeline as jpl  # noqa: E402
from distributed_pipeline_tpu.models import schedule_1f1b as js1  # noqa: E402
from distributed_pipeline_tpu.models.sampling import \
    gpt2_decode as jax_gpt2_decode  # noqa: E402
from distributed_pipeline_tpu.parallel import make_mesh  # noqa: E402
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch.config.train import (  # noqa: E402
    DEFERRED, MPMD_DENSE, PIPE_NEEDS_SCAN, parse_settings)
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    init_params, params_from_flax, params_to_flax, stack_blocks,
    unstack_blocks)
from distributed_pipeline_tpu_torch.models import (  # noqa: E402
    compute_losses, create_model_from_config)
from distributed_pipeline_tpu_torch.models import pipeline as pl  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    schedule_1f1b as s1  # noqa: E402
from distributed_pipeline_tpu_torch.models.sampling import \
    gpt2_decode  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from distributed_pipeline_tpu_torch.run import serve as serve_mod  # noqa: E402
from distributed_pipeline_tpu_torch.utils.checkpoint import \
    save_run  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import \
    TrainLoop  # noqa: E402

V, L, D, H, LAYERS, E = 64, 16, 32, 2, 4, 128
CFGS = {"gpt2": dict(model_family="gpt2", vocab_size=V, seq_len=L,
                     hidden_size=D, num_layers=LAYERS, num_heads=H,
                     dtype="float32", attention_impl="xla"),
        "diffuseq": dict(model_family="diffuseq", vocab_size=V, seq_len=L,
                         hidden_size=D, num_layers=LAYERS, num_heads=H,
                         diffusion_steps=50, dtype="float32",
                         attention_impl="xla")}
LOOP = dict(batch_size=8, microbatch=4, lr=1e-3, ema_rate="0.9",
            learning_steps=1000, gradient_clipping=1.0,
            log_interval=10 ** 9, save_interval=10 ** 9)
STEPS = 3
# parameters after 3 steps against the JAX loop: the trainer parity
# tests' bar (tests/test_torch_port_train.py)
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
SLOT_GRID = [(2, 4, 1), (4, 8, 1), (2, 4, 2), (4, 8, 2)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _layer(seed=0):
    gen = np.random.default_rng(seed)
    dh = D // H
    f = lambda *s: gen.standard_normal(s).astype(np.float32) * 0.2  # noqa
    return {"ln1_scale": 1 + f(D), "ln1_bias": f(D), "qkv": f(D, 3, H, dh),
            "out": f(H, dh, D), "ln2_scale": 1 + f(D), "ln2_bias": f(D),
            "wi": f(D, 4 * D), "wo": f(4 * D, D)}


def _stack(n=LAYERS):
    layers = [_layer(i) for i in range(n)]
    return {k: np.stack([lp[k] for lp in layers]) for k in layers[0]}


def _x_mask(B=2, seed=1):
    gen = np.random.default_rng(seed)
    x = gen.standard_normal((B, L, D)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[1, 12:] = 0
    return x, mask


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ------------------------------------------------------ the pure functions

@pytest.mark.parametrize("causal", [True, False])
def test_block_fwd_matches_jax(causal):
    lp = _layer()
    x, mask = _x_mask()
    want = jpl.block_fwd(lp, jnp.asarray(x), jnp.asarray(mask), num_heads=H,
                         dtype=jnp.float32, causal=causal,
                         attention_impl="xla")
    got = pl.block_fwd(_t(lp), torch.from_numpy(x), torch.from_numpy(mask),
                       dtype=torch.float32, causal=causal,
                       attention_impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_stage_apply_matches_jax(remat):
    """The stage's layer loop, and its input and weight gradients, against
    the JAX scan (remat checkpoints each layer on both sides)."""
    lp = _stack()
    x, mask = _x_mask()

    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jax_loss(lp_, x_):
        out = jpl.stage_apply(lp_, x_, jnp.asarray(mask), num_heads=H,
                              dtype=jnp.float32, causal=True,
                              attention_impl="xla", remat=remat, gather={})
        return jnp.sum(out * w), out

    want = jax_loss(lp, jnp.asarray(x))[1]
    g_lp, g_x = jax.grad(lambda a, b: jax_loss(a, b)[0],
                         argnums=(0, 1))(lp, jnp.asarray(x))
    tlp = {k: v.requires_grad_() for k, v in _t(lp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = pl.stage_apply(tlp, tx, torch.from_numpy(mask),
                         dtype=torch.float32, causal=True,
                         attention_impl="xla", remat=remat)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    # gradients: within 2e-5 of each one's largest entry (f32 sums over
    # the batch and the positions in another order)
    for got, ref, what in [(tx.grad, g_x, "x")] + [
            (tlp[k].grad, g_lp[k], k) for k in lp]:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max(),
                                   err_msg=what)


def test_stash_size_matches_jax():
    for M in range(1, 17):
        for S in range(2, 6):
            for Vv in (1, 2, 3):
                assert s1.stash_size(M, S, Vv) == js1.stash_size(M, S, Vv)


@pytest.mark.parametrize("S,M,Vv", SLOT_GRID)
def test_slot_indices_match_jax_and_every_frame_pairs(S, M, Vv):
    """``_slot_indices`` at every (t, sid) exactly the JAX closed form;
    then the port's frame plan: a stage sends a forward frame where its F
    slot is valid and not the last virtual stage, and the next stage's
    slot at t + 1 receives exactly those (likewise the cotangents, the
    other way round); each (virtual stage, chunk) gets one F and one B
    slot; the last stage's B slot shares its head's chunk."""
    T = M * Vv + S * Vv + S - 2
    seen_f, seen_b = set(), set()
    for t in range(T + 1):
        for sid in range(S):
            got = s1._slot_indices(t, sid, S, M, Vv)
            want = tuple(int(a) if a.dtype != bool else bool(a)
                         for a in js1._slot_indices(jnp.int32(t),
                                                    jnp.int32(sid), S, M,
                                                    Vv))
            assert got == want, (t, sid)
            jf, cf, vf, jb, cb, vb = got
            if t == T:
                assert not vf and not vb
                continue
            if vf:
                assert (jf * S + sid, cf) not in seen_f
                seen_f.add((jf * S + sid, cf))
            if vb:
                assert (jb * S + sid, cb) not in seen_b
                seen_b.add((jb * S + sid, cb))
            if vf and sid == S - 1 and jf == Vv - 1:
                assert vb and (jb, cb) == (jf, cf)
            # forward frame to the next stage, read at t + 1
            sends_f = vf and not (sid == S - 1 and jf == Vv - 1)
            nxt = (sid + 1) % S
            assert sends_f == s1._receives(t + 1, nxt, S, M, Vv, T)[0], \
                (t, sid)
            # cotangent to the stage before, read at t + 1
            sends_b = vb and not (sid == 0 and jb == 0)
            prv = (sid - 1) % S
            assert sends_b == s1._receives(t + 1, prv, S, M, Vv, T)[1], \
                (t, sid)
            if Vv == 1:
                assert not (sends_f and sid == S - 1)
                assert not (sends_b and sid == 0)
    assert seen_f == seen_b == {(k, c) for k in range(S * Vv)
                                for c in range(M)}


@pytest.mark.parametrize("S,Vv", [(2, 1), (2, 2), (4, 2), (2, 3)])
def test_interleave_order_matches_jax(S, Vv):
    """Rank s's rows are the JAX ``_interleave_stack`` block s, exactly."""
    n = 24
    stacked = js1._interleave_stack({"a": jnp.arange(n)}, S, Vv)["a"]
    per_rank = n // S
    for s in range(S):
        want = [int(i) for i in stacked[s * per_rank:(s + 1) * per_rank]]
        assert list(pl.stage_layers(n, S, s, Vv)) == want
    with pytest.raises(ValueError, match="not divisible"):
        pl.stage_layers(10, 4, 0)


def test_scan_unroll_for_matches_jax():
    for n in (1, 4, 16, 24):
        for knob in (0, 1, 2, 7, 64):
            assert pl.scan_unroll_for(n, knob) == jpl.scan_unroll_for(n, knob)


# ------------------------------------------------------ weights and models

@pytest.fixture(scope="module", params=sorted(CFGS))
def stacked(request):
    """One family's JAX stacked workload, its weights, and the same weights
    in the port's stacked and named layouts."""
    fam = request.param
    wl = jax_create(**CFGS[fam], scan_layers=True)
    params = _np(wl.init_params(jax.random.PRNGKey(0)))
    sd = params_from_flax(params)
    return {"fam": fam, "wl": wl, "params": params, "sd": sd,
            "named": unstack_blocks(sd)}


def _port(fam, scan, sd):
    m = create_model_from_config(**CFGS[fam], scan_layers=scan,
                                 device="cpu")
    m.load_state_dict(sd)
    return m


def test_flax_stacked_round_trip_is_bitwise(stacked):
    """The JAX stacked tree loads key for key into the port's stacked
    model and comes back bitwise; named <-> stacked bitwise."""
    m = _port(stacked["fam"], True, stacked["sd"])
    assert m.backbone.blocks.qkv.shape[0] == LAYERS
    back = params_to_flax(m.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(stacked["params"]))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])
    again = stack_blocks(stacked["named"])
    assert set(again) == set(stacked["sd"])
    for k, v in again.items():
        assert torch.equal(v, stacked["sd"][k]), k
    assert "backbone.block_3.attn.qkv" in stacked["named"]


def _batch(fam, seed=2, n=8):
    name = "synthetic-lm" if fam == "gpt2" else "synthetic-seq2seq"
    return next(jax_data.load_data_from_args(
        "train", batch_size=n, dataset=name, seq_len=L, vocab_size=V,
        seed=seed))


def test_stacked_and_named_models_agree_bitwise(stacked):
    """The same converted weights through the stacked and the named-block
    model: forward and loss bitwise, and three ``TrainLoop`` steps with the
    final parameters bitwise (clipping off: the clip's global norm sums
    the two models' differently ordered flat buffers, a rounding apart)."""
    fam = stacked["fam"]
    a = _port(fam, True, stacked["sd"])
    b = _port(fam, False, stacked["named"])
    batch = {k: torch.from_numpy(v) for k, v in _batch(fam).items()}
    draws = {"t": torch.arange(8) % 50,
             "noise": torch.randn(8, L, E, generator=torch.Generator()
                                  .manual_seed(0))}
    with torch.no_grad():
        la = compute_losses(a, batch, draws)
        lb = compute_losses(b, batch, draws)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    losses = {}
    for scan, sd in ((True, stacked["sd"]), (False, stacked["named"])):
        loop = TrainLoop(model=create_model_from_config(
            **CFGS[fam], scan_layers=scan, device="cpu"), data=None,
            init_params=sd, fused_update="false", checkpoint_dir="", seed=3,
            **{**LOOP, "gradient_clipping": -1.0})
        losses[scan] = [float(loop.run_step(_batch(fam, s))["loss"])
                        for s in range(STEPS)]
        if scan:
            final = unstack_blocks(loop.state_dict_of(loop.params))
        else:
            final_named = loop.state_dict_of(loop.params)
    assert losses[True] == losses[False]
    for k, v in final_named.items():
        assert torch.equal(final[k], v), k


def test_stacked_gpt2_decode_is_the_jax_dense_cache_decode():
    """Greedy ``gpt2_decode`` of a stacked model (the dense cache, one
    ``DenseKV`` a layer) token-identical to the JAX stacked decode and to
    the named-block model's, cached and uncached."""
    wl = jax_create(**CFGS["gpt2"], scan_layers=True)
    params = wl.init_params(jax.random.PRNGKey(0))
    sd = params_from_flax(_np(params))
    batch = next(jax_data.load_data_from_args(
        "valid", batch_size=8, dataset="synthetic-lm", seq_len=L,
        vocab_size=V, seed=0, deterministic=True))
    want = np.asarray(jax_gpt2_decode(wl, params, jnp.asarray(
        batch["input_ids"]), 8))
    ids = torch.from_numpy(batch["input_ids"])
    for scan, state in ((True, sd), (False, unstack_blocks(sd))):
        m = _port("gpt2", scan, state).eval()
        for cache in (True, False):
            got = gpt2_decode(m, ids, 8, use_cache=cache).numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{scan} {cache}")


def _jax_draws(jloop, seed, steps, micro=2, rows=4):
    sched = jloop.workload.schedule
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


def test_scan_layers_trainloop_matches_jax(stacked, tmp_path):
    """``--scan_layers`` at pipe 1: 3 ``TrainLoop`` steps against the JAX
    scan-layers ``TrainLoop`` (losses rtol 2e-5, the final parameters at
    the trainer parity bar)."""
    fam = stacked["fam"]
    jloop = JaxTrainLoop(
        model=jax_create(**CFGS[fam], scan_layers=True), data=None,
        mesh=make_mesh(dp=1, devices=jax.devices()[:1]), seed=5,
        checkpoint_dir=str(tmp_path / "jax"), fused_update=False, **LOOP)
    draws = _jax_draws(jloop, 5, STEPS) if fam == "diffuseq" else None
    port = TrainLoop(
        model=create_model_from_config(**CFGS[fam], scan_layers=True,
                                       device="cpu"),
        data=None, init_params=params_from_flax(_np(jloop.state.params)),
        fused_update="false", checkpoint_dir="",
        draws=(lambda s, i: draws[s][i]) if draws else None, **LOOP)
    for s in range(STEPS):
        batch = _batch(fam, s)
        jm, pm = jloop.run_step(batch), port.run_step(batch)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=2e-5)
    want = params_from_flax(_np(jloop.state.params))
    got = port.state_dict_of(port.params)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("src_scan", [True, False])
def test_checkpoint_loads_across_block_layouts(tmp_path, src_scan):
    """A stacked loop's save resumes in a named-block loop and the
    reverse: the restored state is the saved one, and the next step
    equals the uninterrupted run's."""
    fam = "gpt2"
    sd = init_params(dict(CFGS[fam], scan_layers=src_scan), 0)
    run = str(tmp_path / "run")

    def loop(scan, state=None, ckpt=run):
        return TrainLoop(model=create_model_from_config(
            **CFGS[fam], scan_layers=scan, device="cpu"), data=None,
            init_params=state, fused_update="false", checkpoint_dir=ckpt,
            seed=3, **LOOP)

    a = loop(src_scan, sd)
    for s in range(2):
        a.run_step(_batch(fam, s))
    a.save()
    want = float(a.run_step(_batch(fam, 2))["loss"])
    b = loop(not src_scan)
    assert b.step == 2
    convert = stack_blocks if not src_scan else unstack_blocks
    saved = convert(torch.load(f"{run}/model_000002.pt", weights_only=True))
    for k, v in b.state_dict_of(b.params).items():
        assert torch.equal(v, saved[k]), k
    assert float(b.run_step(_batch(fam, 2))["loss"]) == want


# -------------------------------------------------- settings and the mesh

def test_deferred_holds_no_pipeline_option():
    for name in ("scan_layers", "scan_unroll", "pp_chunks", "pp_schedule",
                 "pp_virtual", "pipe"):
        assert name not in DEFERRED
    # the MPMD runtime (A.9b) took its options out too
    assert set(DEFERRED) == {"tensor", "expert", "auto_tune",
                             "auto_tune_budget_s"}
    s = parse_settings(["--scan_layers", "true", "--scan_unroll", "2",
                        "--pp_schedule", "interleaved", "--pp_virtual", "3",
                        "--pp_chunks", "8"])
    assert (s.scan_layers, s.scan_unroll, s.pp_schedule, s.pp_virtual,
            s.pp_chunks) == (True, 2, "interleaved", 3, 8)


@pytest.mark.parametrize("argv,expect", [
    (["--pipe", "2"], PIPE_NEEDS_SCAN),
    (["--pipe", "2", "--scan_layers", "true", "--moe_experts", "4",
      "--fsdp", "2"], "MoE x pipe composes with the data axis only (v1); "
                      "mesh has fsdp=2"),
    (["--pipe", "2", "--scan_layers", "true", "--moe_experts", "4",
      "--sequence", "2"], "MoE x pipe composes with the data axis only "
                          "(v1); mesh has sequence=2"),
    (["--pipe", "2", "--scan_layers", "true", "--sequence", "2",
      "--shard_optimizer", "true"], "ROADMAP A.8g"),
    (["--mpmd", "true", "--scan_layers", "true", "--moe_experts", "4"],
     MPMD_DENSE),
    (["--pp_chunks", "0"], "--pp_chunks and --pp_virtual must be >= 1"),
    (["--pp_schedule", "zigzag"], "invalid choice"),
    (["--mpmd", "true"], "--mpmd requires --scan_layers true")])
def test_pipeline_refusals_at_parse_time(argv, expect, monkeypatch, capsys):
    """What stays refused: ``--pipe`` over named blocks and MoE stages
    beside fsdp or sequence with the JAX messages, sharding with a ring
    (A.8g), ``--mpmd`` over MoE groups (the JAX stages are dense); none
    names A.9c (the checks run on a world the mesh fits)."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit) as e:
        parse_settings(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert expect in err and "A.9c" not in err


@pytest.mark.parametrize("argv", [
    ["--pipe", "2", "--scan_layers", "true", "--fsdp", "2"],
    ["--pipe", "2", "--scan_layers", "true", "--shard_optimizer", "true"],
    ["--pipe", "2", "--scan_layers", "true", "--sequence", "2"],
    ["--pipe", "2", "--scan_layers", "true", "--moe_experts", "4"],
    ["--scan_layers", "true", "--moe_experts", "4"]])
def test_pipeline_compositions_parse(argv, monkeypatch):
    """The compositions the JAX package trains parse: pipe x fsdp, x
    ZeRO-1, x sequence, MoE under a pipe ({data, pipe}) and the stacked
    MoE groups."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    s = parse_settings(argv)
    assert s.scan_layers
    assert (s.pipe, s.fsdp, s.shard_optimizer, s.sequence, s.moe_experts) \
        == (int(dict(zip(argv, argv[1:])).get("--pipe", 1)),
            int(dict(zip(argv, argv[1:])).get("--fsdp", 1)),
            "--shard_optimizer" in argv,
            int(dict(zip(argv, argv[1:])).get("--sequence", 1)),
            int(dict(zip(argv, argv[1:])).get("--moe_experts", 0)))


@pytest.mark.parametrize("dp,pipe", [(1, 2), (2, 2), (2, 4), (3, 2)])
def test_rank_mesh_pipe_groups_and_rows(dp, pipe):
    """Under a pipe axis the S consecutive ranks of a pipe group read the
    same rows (pipe is not a row axis), the data ranks distinct ones; the
    pipe group is the ranks the JAX mesh puts on the pipe axis."""
    world = dp * pipe
    sizes = pmesh.resolve_axis_sizes(dp=dp, pipe=pipe, n_devices=world)
    jmesh = np.arange(world).reshape(sizes)
    rows = {}
    for r in range(world):
        m = pmesh.RankMesh(sizes, r, pmesh.rank_coords(r, sizes), {})
        assert m.rows() == (r // pipe, dp)
        rows.setdefault(m.rows()[0], []).append(r)
        group = m.pipe_group()
        assert group.ranks == tuple(range(r - r % pipe, r - r % pipe + pipe))
        assert group.ranks == tuple(int(x) for x in
                                    jmesh[r // pipe, 0, 0, 0, 0, :])
        assert group.index == r % pipe and group.peer(1) == \
            group.ranks[(r % pipe + 1) % pipe]
    assert all(len(v) == pipe for v in rows.values())


def test_tuned_pipe_recommendation_applies_as_in_jax(monkeypatch):
    """A tuner artifact's ``pipe`` folds into the settings as the JAX
    entry point folds it (default mesh flags, a fitting product and
    microbatch), for a ``--scan_layers`` run; without stacked layers the
    port logs it and keeps its mesh (a pipe over named blocks is
    refused)."""
    from distributed_pipeline_tpu_torch.config.train import TrainSettings
    from distributed_pipeline_tpu_torch.run.train import apply_tuned_layout
    from tests.test_torch_port_shard_rules import _jax_apply
    monkeypatch.setenv("WORLD_SIZE", "4")
    art = {"rules": None, "mesh": {"data": 2, "pipe": 2},
           "shard_optimizer": None}
    kw = dict(scan_layers=True, batch_size=8, microbatch=4)
    want = _jax_apply(kw, art, 4)
    logs = []
    got = apply_tuned_layout(TrainSettings(**kw), art, n_devices=4,
                             log=logs.append)
    assert (got.dp, got.pipe) == (want.dp, want.pipe) == (2, 2)
    logs = []
    kept = apply_tuned_layout(TrainSettings(batch_size=8, microbatch=4),
                              art, n_devices=4, log=logs.append)
    assert (kept.dp, kept.pipe) == (-1, 1)
    assert any("requires --scan_layers true" in line for line in logs)


def test_run_serve_refuses_a_stacked_run_dir(tmp_path):
    cfg = dict(CFGS["gpt2"], model_size="base", scan_layers=True)
    save_run(str(tmp_path / "run"), cfg, init_params(cfg, 0), step=3)
    with pytest.raises(NotImplementedError,
                       match="paged decode needs per-layer named blocks"):
        serve_mod.main(["--checkpoint_path", str(tmp_path / "run"),
                        "--device", "cpu", "--synthetic_requests", "1"])


def test_run_sample_decodes_a_stacked_run_dir(tmp_path):
    """``run.sample`` on a stacked GPT-2 run dir takes ``gpt2_decode``
    (the dense cache, as the JAX entry point routes stacked models):
    the decode accuracy and the eval loss of the same weights as a
    named-block run dir, which decodes through the paged engine."""
    from distributed_pipeline_tpu_torch.run import sample as sample_mod
    out = {}
    for scan in (True, False):
        cfg = dict(CFGS["gpt2"], model_size="base", scan_layers=scan)
        run = str(tmp_path / f"run{int(scan)}")
        save_run(run, cfg, init_params(cfg, 0), step=3)
        out[scan] = sample_mod.main(["--checkpoint_path", run, "--device",
                                     "cpu", "--batch_size", "4",
                                     "--num_batches", "2"])
    assert out[True] == out[False]
    assert out[True]["step"] == 3 and 0.0 <= out[True]["decode_acc"] <= 1


def test_stacked_model_refuses_a_paged_cache():
    m = create_model_from_config(**CFGS["gpt2"], scan_layers=True,
                                 device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="named blocks"):
        m(ids, block_table=torch.zeros(1, 2, dtype=torch.int32),
          kv_cache=[(torch.zeros(1), torch.zeros(1))] * LAYERS)
    moe = create_model_from_config(**CFGS["gpt2"], scan_layers=True,
                                   moe_experts=4, device="cpu")
    assert type(moe.backbone.blocks).__name__ == "MoEScanBlocks"
    assert moe.backbone.blocks.moe_wi.shape[:2] == (LAYERS // 2, 4)
    with pytest.raises(ValueError, match="no KV-cache decode path"):
        moe(ids, cache_index=torch.zeros((), dtype=torch.int64),
            kv_cache=[pl.DenseKV() for _ in range(LAYERS)])
