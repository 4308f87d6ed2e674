"""The port's mixture of experts and per-block rematerialization against
the JAX package's, on the CPU.

* ``moe_mlp_fwd`` against the JAX function on numpy-seeded inputs: top-1
  and top-2, capacity factor 1.25 and 0.5 (tokens overflow), with pads,
  ``no_drop`` and ``return_stats``; the dispatch plan is exact (also
  against the JAX module's sowed ``intermediates/dispatch``), ``y`` and
  the aux within rtol 1e-5 (f32, another summation order), gradients of
  ``sum(y) + 0.01 * aux`` within rtol 1e-4 and an atol of 1e-6 times the
  largest gradient entry: f32 rounding at the gradient's scale, which is
  all there is where an entry cancels to near zero (at top-1 the
  normalized gate is g/g, whose router gradient is 0 but for rounding;
  measured on the CPU: at most 3.7e-6 against entries up to 11);
* routing is causal under capacity (``tests/test_moe.py``'s check);
* both families' losses (``moe_aux`` included) and gradients on MoE
  models with converted weights, DiffuSeq fed the JAX draws (the loss
  and gradient bars of ``tests/test_torch_port_diffuseq.py``);
* 3 GPT-2 ``TrainLoop`` steps against the JAX trainer, without and with
  remat (the bars of ``tests/test_torch_port_train.py``); the port's remat
  run bitwise its run without;
* inference routes without drops: ``gpt2_decode`` cached == uncached and
  the JAX decoder's tokens, ``DecodeServer`` the JAX dense greedy
  decoder's, ``diffuseq_sample`` token-identical to JAX's; a token that
  differs from the JAX side is accepted only where the JAX logits' top-2
  gap is below 1e-4 (the rule of the port's other decode tests);
* ``run.train --moe_experts 4 --remat true --device cpu``, then
  ``run.sample`` and ``run.serve`` on the run dir; the parameter counts
  against the JAX ``active_param_count``; the initializer's keys and
  shapes against the JAX tree's; a deleted ``TrainLoop`` frees its state
  at once (no reference cycle).

The ``cuda`` tests (one MoE GPT-2 step at L = 1024 through the kernels
against the plain versions, and remat bitwise no remat on the card) run
through ``scripts/run_torch_cuda_tests.py -k moe``.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu.data import \
    load_data_from_args as jax_load_data  # noqa: E402
from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.models import \
    sampling as jax_sampling  # noqa: E402
from distributed_pipeline_tpu.models.moe import MoEMlp as JaxMoEMlp  # noqa
from distributed_pipeline_tpu.models.moe import \
    moe_mlp_fwd as jax_moe_fwd  # noqa: E402
from distributed_pipeline_tpu.parallel import make_mesh  # noqa: E402
from distributed_pipeline_tpu.utils.perf import \
    active_param_count as jax_active  # noqa: E402
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch.config.train import \
    parse_settings  # noqa: E402
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    init_params, opt_state_from_optax, params_from_flax)
from distributed_pipeline_tpu_torch.data import \
    load_data_from_args  # noqa: E402
from distributed_pipeline_tpu_torch.models import (  # noqa: E402
    compute_losses, create_model_from_config)
from distributed_pipeline_tpu_torch.models import sampling  # noqa: E402
from distributed_pipeline_tpu_torch.models.moe import (  # noqa: E402
    MOE_AUX_WEIGHT, moe_mlp_fwd)
from distributed_pipeline_tpu_torch.run import sample as sample_mod  # noqa
from distributed_pipeline_tpu_torch.run import serve as serve_mod  # noqa
from distributed_pipeline_tpu_torch.run import train as train_mod  # noqa
from distributed_pipeline_tpu_torch.serving.scheduler import \
    DecodeServer  # noqa: E402
from distributed_pipeline_tpu_torch.utils.perf import \
    active_param_count  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import \
    TrainLoop  # noqa: E402

V, L, D, H, LAYERS, EXPERTS = 64, 32, 32, 2, 4, 4
MOE = dict(moe_experts=EXPERTS, moe_top_k=2, moe_every=2)
GPT2 = dict(model_family="gpt2", vocab_size=V, seq_len=L, hidden_size=D,
            num_layers=LAYERS, num_heads=H, dtype="float32", **MOE)
DIFFUSEQ = dict(model_family="diffuseq", vocab_size=V, seq_len=16,
                hidden_size=D, num_layers=LAYERS, num_heads=H,
                diffusion_steps=50, dtype="float32", attention_impl="xla",
                **MOE)
EMB = 128  # DiffuSeq's embedding width
GAP_BAR = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _pair(cfg, seed=3):
    """(JAX workload, numpy flax params, port model with those weights)."""
    wl = jax_create(**cfg)
    params = _np(jax.jit(wl.init_params)(jax.random.PRNGKey(seed)))
    model = create_model_from_config(**cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return wl, params, model


@pytest.fixture(scope="module")
def gpt2_pair():
    return _pair(GPT2)


# ------------------------------------------------------------ moe_mlp_fwd

def _moe_inputs(seed, pads):
    rng = np.random.default_rng(seed)
    B, Lm, Dm, E = 2, 16, 32, EXPERTS
    x = rng.standard_normal((B, Lm, Dm), dtype=np.float32)
    mp = {"router": rng.standard_normal((Dm, E), dtype=np.float32)
          * np.float32(Dm ** -0.5),
          "wi": rng.standard_normal((E, Dm, 4 * Dm), dtype=np.float32)
          * np.float32(Dm ** -0.5),
          "wo": rng.standard_normal((E, 4 * Dm, Dm), dtype=np.float32)
          * np.float32((4 * Dm) ** -0.5)}
    pad = np.ones((B, Lm), np.int32)
    if pads:
        pad[0, 12:] = 0
        pad[1, 5:] = 0
    return x, mp, pad


def _objective(y, aux, stats: bool, clamp):
    """``sum(y) + 0.01 * aux``, the aux formed from the stats ``(F, P, n)``
    when the function returned them (``clamp`` is the library's max(n, 1))."""
    if stats:
        F, P, n = aux
        n = clamp(n)
        aux = EXPERTS * ((F / n) * (P / n)).sum()
    return y.sum() + MOE_AUX_WEIGHT * aux


@pytest.mark.parametrize("top_k,cf,pads,no_drop,stats", [
    (1, 1.25, False, False, False),
    (2, 1.25, True, False, False),
    (1, 0.5, False, False, False),
    (2, 0.5, True, False, False),
    (2, 1.25, True, True, False),
    (2, 0.5, True, False, True),
], ids=["top1", "top2-pads", "top1-overflow", "top2-overflow-pads",
        "no_drop", "return_stats"])
def test_moe_mlp_fwd_matches_jax(top_k, cf, pads, no_drop, stats):
    x, mp, pad = _moe_inputs(top_k * 10 + int(cf * 4), pads)
    kw = dict(top_k=top_k, capacity_factor=cf, no_drop=no_drop,
              return_stats=stats)
    jx, jmp = jnp.asarray(x), {k: jnp.asarray(v) for k, v in mp.items()}

    def jax_fn(x_, mp_):
        y, aux, dispatch = jax_moe_fwd(mp_, x_, jnp.asarray(pad),
                                       dtype=jnp.float32, **kw)
        obj = _objective(y, aux, stats, lambda n: jnp.maximum(n, 1.0))
        return obj, (y, aux, dispatch)

    (_, (jy, jaux, jdispatch)), (gx, gmp) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(jx, jmp)

    tx = torch.from_numpy(x).requires_grad_()
    tmp = {k: torch.from_numpy(v).requires_grad_() for k, v in mp.items()}
    y, aux, dispatch = moe_mlp_fwd(tmp, tx, torch.from_numpy(pad),
                                   dtype=torch.float32, **kw)
    _objective(y, aux, stats, lambda n: n.clamp(min=1.0)).backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    if stats:
        F, P, n = aux
        np.testing.assert_array_equal(F.numpy(), np.asarray(jaux[0]))
        np.testing.assert_allclose(P.detach().numpy(), np.asarray(jaux[1]),
                                   rtol=1e-5)
        assert float(n) == float(jaux[2]) == float(pad.sum())
    else:
        np.testing.assert_allclose(float(aux.detach()), float(jaux),
                                   rtol=1e-5)
    if no_drop:
        assert dispatch is None and jdispatch is None
    else:
        np.testing.assert_array_equal(dispatch.numpy(),
                                      np.asarray(jdispatch))
        claims = min(top_k, EXPERTS) * int(pad.sum())
        assert 0 < dispatch.sum() <= claims
        if cf < 1:
            assert dispatch.sum() < claims  # tokens overflowed
    want = {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gmp.items()}}
    got = {"x": tx.grad.numpy(), **{k: tmp[k].grad.numpy() for k in mp}}
    atol = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


def test_dispatch_equals_the_jax_modules_sowed_plan():
    """The JAX ``MoEMlp`` sows its ``[B, L, E, C]`` plan into
    ``intermediates/dispatch``; the port's plan for the same weights is
    that tensor exactly, and each (expert, slot) holds one token at most,
    each expert C at most, pads none."""
    x, mp, pad = _moe_inputs(5, pads=True)
    mod = JaxMoEMlp(num_experts=EXPERTS, top_k=2, capacity_factor=1.0,
                    dtype=jnp.float32)
    _, mvars = mod.apply({"params": mp}, jnp.asarray(x), jnp.asarray(pad),
                         mutable=["losses", "intermediates"])
    want = np.asarray(jax.tree_util.tree_leaves(mvars["intermediates"])[0])
    _, _, got = moe_mlp_fwd({k: torch.from_numpy(v) for k, v in mp.items()},
                            torch.from_numpy(x), torch.from_numpy(pad),
                            top_k=2, capacity_factor=1.0,
                            dtype=torch.float32)
    got = got.numpy()
    np.testing.assert_array_equal(got, want)
    C = got.shape[-1]
    assert (got.sum(axis=1) <= 1).all() and (got.sum(axis=(1, 3)) <= C).all()
    assert (got.sum(axis=(2, 3))[pad == 0] == 0).all() and got.sum() > 0


def test_routing_is_causal_under_capacity(gpt2_pair):
    """Logits before position j do not move when the tokens from j on
    change: capacity slots are claimed in positional priority across
    both top-k levels."""
    _, _, model = gpt2_pair
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        4, V, (2, L)).astype(np.int64))
    j = 20
    alt = ids.clone()
    alt[:, j:] = (alt[:, j:] + 17) % 60 + 4
    with torch.no_grad():
        a, b = model(ids), model(alt)
    torch.testing.assert_close(a[:, :j], b[:, :j], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(a[:, j:], b[:, j:])


# ------------------------------------------------------------ the losses

def _lm_batch(seed, n=8):
    return next(jax_load_data("train", batch_size=n, dataset="synthetic-lm",
                              seq_len=L, vocab_size=V, seed=seed))


def _s2s_batch(seed, n=8):
    return next(jax_load_data("train", batch_size=n,
                              dataset="synthetic-seq2seq", seq_len=16,
                              vocab_size=V, seed=seed, skip_batches=seed))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _draws(key, sched, n, seq):
    rng_t, rng_noise = jax.random.split(key)
    return {"t": torch.from_numpy(np.array(sched.sample_t(rng_t, n))),
            "noise": torch.from_numpy(np.array(
                jax.random.normal(rng_noise, (n, seq, EMB), jnp.float32)))}


@pytest.mark.parametrize("family", ["gpt2", "diffuseq"])
def test_losses_and_grads_match_jax(family, gpt2_pair):
    """An MoE model's loss terms, ``moe_aux`` (the sum over its two MoE
    blocks) and every gradient against JAX on converted weights."""
    if family == "gpt2":
        wl, params, model = gpt2_pair
        batch, draws, key = _lm_batch(1), None, jax.random.PRNGKey(0)
    else:
        wl, params, model = _pair(DIFFUSEQ)
        batch, key = _s2s_batch(2), jax.random.PRNGKey(9)
        draws = _draws(key, wl.schedule, 8, 16)

    def jax_loss(p):
        d = wl.compute_losses(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, key)
        return d["loss"], d

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    model.zero_grad(set_to_none=True)
    got = compute_losses(model, _t(batch), draws)
    assert "moe_aux" in ref and set(got) == set(ref)
    for name in got:
        np.testing.assert_allclose(float(got[name].detach()),
                                   float(ref[name]), rtol=1e-5, err_msg=name)
    got["loss"].backward()
    want = params_from_flax(_np(grads))
    assert any(".moe." in name for name in want)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=5e-4, atol=1e-6, err_msg=name)


def test_dense_models_log_no_aux():
    model = create_model_from_config(**{**GPT2, "moe_experts": 0},
                                     device="cpu")
    model.load_state_dict(init_params({**GPT2, "moe_experts": 0}, 0))
    assert "moe_aux" not in compute_losses(model, _t(_lm_batch(0)))


LOOP = dict(batch_size=8, microbatch=4, lr=1e-3, ema_rate="0.9",
            learning_steps=1000, gradient_clipping=1.0,
            log_interval=10 ** 9, save_interval=10 ** 9)


@pytest.mark.parametrize("remat", [False, True], ids=["dense", "remat"])
def test_trainer_matches_jax_trainloop(tmp_path, remat):
    """3 steps of 2 microbatches on an MoE GPT-2: the port's TrainLoop
    against the JAX one (``remat`` on both sides); with remat the port's
    losses, grad norms and parameters are bitwise its run without."""
    jloop = JaxTrainLoop(
        model=jax_create(**GPT2, remat=remat), data=None,
        mesh=make_mesh(dp=1, devices=jax.devices()[:1]), seed=5,
        checkpoint_dir=str(tmp_path / "jax"), fused_update=False, **LOOP)
    init = params_from_flax(_np(jloop.state.params))
    ports = {r: TrainLoop(model=create_model_from_config(
        **GPT2, remat=r, device="cpu"), data=None, init_params=init,
        fused_update="false", checkpoint_dir="", **LOOP)
        for r in sorted({False, remat})}
    for s in range(3):
        batch = _lm_batch(s + 3)
        jm = jloop.run_step(batch)
        pms = {r: loop.run_step(batch) for r, loop in ports.items()}
        pm = pms[remat]
        for k in ("loss", "nll", "acc", "moe_aux"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=2e-5 if k != "moe_aux" else 1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        if remat:
            for k in pm:
                assert torch.equal(pm[k], pms[False][k]), k
    port = ports[remat]
    if remat:
        assert torch.equal(port.params, ports[False].params)
    opt = opt_state_from_optax(jloop.state.opt_state)
    checks = [(port.state_dict_of(port.params),
               params_from_flax(_np(jloop.state.params)), 1e-5),
              (port.state_dict_of(port.mu), opt["mu"], 1e-7),
              (port.state_dict_of(port.nu), opt["nu"], 1e-10)]
    for ours, ref, atol in checks:
        for key in ref:
            np.testing.assert_allclose(ours[key].numpy(), ref[key].numpy(),
                                       rtol=1e-4, atol=atol, err_msg=key)


def test_parameter_counts_match_jax(gpt2_pair):
    wl, params, model = gpt2_pair
    n = sum(p.numel() for p in model.parameters())
    assert n == wl.param_count(params)
    want = jax_active(params, n, moe_experts=EXPERTS, moe_top_k=2)
    assert active_param_count(model.state_dict(), n, moe_experts=EXPERTS,
                              moe_top_k=2) == want < n
    for k in (1, 4):
        assert active_param_count(dict(model.named_parameters()), n,
                                  moe_experts=EXPERTS, moe_top_k=k) == \
            jax_active(params, n, moe_experts=EXPERTS, moe_top_k=k)


@pytest.mark.parametrize("cfg", [GPT2, DIFFUSEQ], ids=["gpt2", "diffuseq"])
def test_init_params_draws_the_jax_tree(cfg):
    """``convert.init_params`` gives the JAX tree's keys and shapes (the
    MoE blocks' router/wi/wo included) with the initializers' scales."""
    want = params_from_flax(_np(jax.jit(jax_create(**cfg).init_params)(
        jax.random.PRNGKey(0))))
    got = init_params({**cfg, "moe_every": 2}, 0)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    # the router's 128 draws estimate its std within ~6% (one sigma)
    for name, bar in (("backbone.block_1.moe.router", 0.25),
                      ("backbone.block_3.moe.wi", 0.05),
                      ("backbone.block_3.moe.wo", 0.05)):
        fan_in = got[name].shape[-2]
        np.testing.assert_allclose(float(got[name].std()), fan_in ** -0.5,
                                   rtol=bar, err_msg=name)


def test_settings_take_the_moe_and_remat_flags(capsys):
    s = parse_settings(["--remat", "true", "--moe_experts", "8",
                        "--moe_top_k", "1", "--moe_every", "3",
                        "--moe_capacity_factor", "2.0"])
    assert (s.remat, s.moe_experts, s.moe_top_k, s.moe_every,
            s.moe_capacity_factor) == (True, 8, 1, 3, 2.0)
    cfg = {**s.to_dict(), "num_layers": 6, "vocab_size": 64}
    cfg.pop("device")
    model = create_model_from_config(**cfg, device="meta")
    moe = [i for i in range(6)
           if hasattr(getattr(model.backbone, f"block_{i}"), "moe")]
    assert moe == [2, 5] and model.backbone.remat
    with pytest.raises(SystemExit):
        parse_settings(["--moe_experts", "4", "--moe_every", "0"])
    assert "moe_every must be >= 1" in capsys.readouterr().err


@pytest.mark.parametrize("family", ["gpt2", "diffuseq"])
def test_a_deleted_trainloop_frees_its_state(family):
    """``del loop`` frees the loop's flat state at once, with the cyclic
    collector off: the loop holds no reference cycle (a bound method kept
    as the draws hook was one, and phase 13's peaks on the card counted
    the earlier runs' state until the collector ran)."""
    cfg = GPT2 if family == "gpt2" else DIFFUSEQ
    model = create_model_from_config(**cfg, device="cpu")
    loop = TrainLoop(model=model, data=None, batch_size=4, microbatch=2,
                     fused_update="false", checkpoint_dir="")
    loop.run_step(_lm_batch(0, 4) if family == "gpt2" else _s2s_batch(0, 4))
    refs = [weakref.ref(t) for t in (loop.params, loop.grads, loop.mu)]
    enabled = gc.isenabled()
    gc.disable()
    try:
        del loop, model
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


# ------------------------------------------------------------ inference

def _jax_forward(wl):
    model = wl.model.clone(moe_no_drop=True)
    fn = jax.jit(lambda p, x: model.apply(p, x, jnp.ones_like(x)))
    return fn


def _hold_stream(fwd, params, prompt, tokens, seq_len):
    """Each of the port's greedy tokens is the JAX dense forward's argmax
    after the same prefix, or within GAP_BAR of its max (a near-tie)."""
    ids = list(map(int, prompt))
    for tok in tokens:
        row = np.zeros((1, seq_len), np.int32)
        row[0, :len(ids)] = ids
        logits = np.asarray(fwd(params, jnp.asarray(row)))[0, len(ids) - 1]
        logits = logits.astype(np.float64)
        assert logits.max() - logits[int(tok)] < GAP_BAR or \
            int(tok) == int(np.argmax(logits)), (ids, tok)
        ids.append(int(tok))


def test_gpt2_decode_routes_without_drops(gpt2_pair):
    """``gpt2_decode`` on the MoE model: cached == uncached exactly (no
    capacity competition at inference), and the JAX decoder's tokens."""
    wl, params, model = gpt2_pair
    ids = np.random.default_rng(3).integers(4, V, (4, L)).astype(np.int32)
    plen = 12
    cached = sampling.gpt2_decode(model, torch.from_numpy(ids), plen)
    uncached = sampling.gpt2_decode(model, torch.from_numpy(ids), plen,
                                    use_cache=False)
    assert torch.equal(cached, uncached)
    ref = np.asarray(jax.jit(lambda p, x: jax_sampling.gpt2_greedy_decode(
        wl, p, x, plen))(params, jnp.asarray(ids)))
    fwd = _jax_forward(wl)
    for row, want in zip(cached.numpy(), ref):
        if not np.array_equal(row, want):
            _hold_stream(fwd, params, row[:plen], row[plen:], L)
    # the training routing (with capacity) is another function
    with torch.no_grad():
        x = torch.from_numpy(ids)
        assert not torch.equal(model(x), model(x, moe_no_drop=True))


def test_decode_server_gives_the_jax_dense_greedy_tokens(gpt2_pair):
    """The paged server (prefill and decode phases, no-drop routing) on
    the MoE model: every request's greedy tokens are the JAX dense
    forward's picks."""
    wl, params, model = gpt2_pair
    srv = DecodeServer(model, device="cpu", decode_slots=2, page_size=4,
                       max_prompt_len=12, max_len=L, seed=0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(4, V, (n,)).astype(np.int32)
               for n in (3, 9, 12, 1, 6)]
    reqs = [srv.submit(p, 6) for p in prompts]
    srv.drain()
    fwd = _jax_forward(wl)
    for p, r in zip(prompts, reqs):
        assert len(r.tokens) == 6
        _hold_stream(fwd, params, p, r.tokens, L)


def test_diffuseq_sample_token_identical():
    wl, params, model = _pair(DIFFUSEQ)
    batch = _s2s_batch(3)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax_sampling.diffuseq_sample(
        wl, params, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        sample_steps=4))
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, (8, 16, EMB), jnp.float32)))
    got = sampling.diffuseq_sample(model, _t(batch), noise,
                                   sample_steps=4).numpy()
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------ entry points

def _argv(family):
    cfg = GPT2 if family == "gpt2" else DIFFUSEQ
    argv = ["--device", "cpu", "--model_family", family,
            "--dataset", "synthetic-lm" if family == "gpt2"
            else "synthetic-seq2seq"]
    for k in ("seq_len", "vocab_size", "hidden_size", "num_layers",
              "num_heads", "dtype", "moe_experts", "moe_top_k",
              "moe_every"):
        argv += [f"--{k}", str(cfg[k])]
    return argv + ["--remat", "true", "--batch_size", "8",
                   "--microbatch", "4", "--ema_rate", "0.9",
                   "--log_interval", "1", "--learning_steps", "2",
                   "--data_loader_workers", "0", "--prefetch_depth", "0"]


@pytest.mark.parametrize("family", ["gpt2", "diffuseq"])
def test_run_train_sample_serve_on_an_moe_run_dir(family, tmp_path, capsys):
    """``run.train --moe_experts 4 --remat true`` for 2 steps logs
    ``moe_aux`` and writes an MoE run dir; ``run.sample`` (and, for GPT-2,
    ``run.serve``) load it as an MoE model, never a dense one."""
    run = str(tmp_path / "run")
    loop = train_mod.main(_argv(family) + ["--checkpoint_path", run])
    assert loop.step == 2 and loop.model.backbone.remat
    assert all(np.isfinite(h["moe_aux"]) for h in loop.history)
    assert loop.n_active_params < loop.n_params
    model, targs, step = sample_mod.load_run(run, device="cpu")
    assert step == 2 and targs["moe_experts"] == EXPERTS
    assert hasattr(model.backbone.block_1, "moe")
    capsys.readouterr()
    out = sample_mod.main(["--checkpoint_path", run, "--device", "cpu",
                           "--batch_size", "4", "--num_batches", "1",
                           "--sample_steps", "4"])
    assert out["step"] == 2 and np.isfinite(out["eval_loss"])
    if family == "gpt2":
        result = serve_mod.main([
            "--checkpoint_path", run, "--device", "cpu",
            "--decode_slots", "2", "--page_size", "4",
            "--max_prompt_len", "8", "--synthetic_requests", "3",
            "--max_new_tokens", "4"])
        assert result["step"] == 2 and result["decode_tokens"] == 12


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


def _card_step(device, attn, fused, remat):
    cfg = dict(GPT2, hidden_size=128, num_heads=2, seq_len=1024,
               dtype="bfloat16", attention_impl=attn, remat=remat)
    batch = next(load_data_from_args("train", batch_size=4,
                                     dataset="synthetic-lm", seq_len=1024,
                                     vocab_size=V, seed=0))
    loop = TrainLoop(model=create_model_from_config(**cfg, device=device),
                     data=None, batch_size=4, microbatch=2, seed=0,
                     fused_update=fused, checkpoint_dir="")
    m = loop.run_step(batch)
    return {k: float(v) for k, v in m.items()}, loop.params.clone()


@pytest.mark.cuda
def test_cuda_moe_step_kernels_against_plain(cuda_device):
    """One bf16 MoE GPT-2 step at L = 1024 through the flash kernels and
    the fused update against the plain versions: loss within 0.5%, grad
    norm within 3% (the bars of chip_smoke.py's training steps)."""
    from distributed_pipeline_tpu_torch.ops import flash_attention as fa
    fa.reset_launch_counts()
    a, _ = _card_step(cuda_device, "cuda", "true", False)
    assert fa.forward_launch_count() == LAYERS * 2
    b, _ = _card_step(cuda_device, "torch", "false", False)
    assert abs(a["loss"] - b["loss"]) <= 5e-3 * abs(b["loss"])
    assert abs(a["grad_norm"] - b["grad_norm"]) <= 3e-2 * b["grad_norm"]
    assert np.isfinite(a["moe_aux"])


@pytest.mark.cuda
def test_cuda_remat_is_bitwise_no_remat(cuda_device):
    """On the card the remat step recomputes each block with the same
    kernels on the same inputs: metrics and parameters bitwise equal, the
    flash forward launched twice a block."""
    from distributed_pipeline_tpu_torch.ops import flash_attention as fa
    fa.reset_launch_counts()
    a, pa = _card_step(cuda_device, "auto", "auto", False)
    fwd = fa.forward_launch_count()
    b, pb = _card_step(cuda_device, "auto", "auto", True)
    assert fa.forward_launch_count() - fwd == 2 * fwd
    assert a == b and torch.equal(pa, pb)
