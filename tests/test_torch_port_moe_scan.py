"""Stacked MoE groups (``--scan_layers`` with ``--moe_experts``, the JAX
``MoEScanBlocks``) in one process on the CPU, against the JAX package.

Tiny models (vocab 64, seq 16, hidden 32, 4 layers, 2 heads, f32, 4
experts top-2, ``moe_every`` 2: two groups of one dense layer and one MoE
block), weights through ``convert.py``:

* ``moe_stage_apply`` against the JAX function, with and without remat:
  the output, the raw per-group sums (F bitwise, P and n at rtol 2e-5)
  and the input and weight gradients (within 2e-5 of each one's largest
  entry);
* the named <-> stacked transplant: ``stack_blocks`` of the JAX named MoE
  tree equals the JAX test's hand transplant into ``params/backbone/
  blocks`` bitwise, the JAX stacked tree round-trips through the port's
  stacked model bitwise, and the named and the stacked port models give
  the same losses and ``moe_aux`` bitwise;
* the JAX ``MoEScanBlocks`` loss and ``moe_aux`` (rtol 1e-5, the JAX
  transplant test's) and ``jax.grad`` (rtol 5e-4, atol 1e-6, the MoE
  gradient test's bar), for both families;
* (the stacked MoE ``TrainLoop`` against the JAX one runs beside the
  MoE x pipe ranks in ``test_torch_port_pipe_compose.py``, on the same
  JAX runs);
* a stacked MoE save resumed by a named-block loop and the reverse,
  bitwise, and the next step equal;
* ``run.sample`` on a stacked MoE GPT-2 run dir (``gpt2_decode``'s full
  recompute: MoE groups keep no cache) token for token the named-block
  run dir's (the paged engine), and the stacked model refusing a cache.
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
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    init_params, params_from_flax, params_to_flax, stack_blocks,
    unstack_blocks)
from distributed_pipeline_tpu_torch.models import (  # noqa: E402
    compute_losses, create_model_from_config)
from distributed_pipeline_tpu_torch.models import pipeline as pl  # noqa: E402
from distributed_pipeline_tpu_torch.models.sampling import \
    gpt2_decode  # noqa: E402
from distributed_pipeline_tpu_torch.run import sample as sample_mod  # noqa: E402
from distributed_pipeline_tpu_torch.utils.checkpoint import \
    save_run  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import \
    TrainLoop  # noqa: E402

V, L, D, H, LAYERS, E, EXPERTS = 64, 16, 32, 2, 4, 128, 4
MOE = dict(moe_experts=EXPERTS, moe_top_k=2, moe_every=2)
CFGS = {"gpt2": dict(model_family="gpt2", vocab_size=V, seq_len=L,
                     hidden_size=D, num_layers=LAYERS, num_heads=H,
                     dtype="float32", attention_impl="xla", **MOE),
        "diffuseq": dict(model_family="diffuseq", vocab_size=V, seq_len=L,
                         hidden_size=D, num_layers=LAYERS, num_heads=H,
                         diffusion_steps=50, dtype="float32",
                         attention_impl="xla", **MOE)}
LOOP = dict(batch_size=8, microbatch=4, lr=1e-3, ema_rate="0.9",
            learning_steps=1000, gradient_clipping=1.0,
            log_interval=10 ** 9, save_interval=10 ** 9)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _fast_jit(fn, *args):
    """``fn(*args)`` compiled without XLA's backend passes: on graphs this
    small they cost more than they save (the values agree to the last
    bits)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _batch(fam, seed=2, n=8):
    name = "synthetic-lm" if fam == "gpt2" else "synthetic-seq2seq"
    return next(jax_data.load_data_from_args(
        "train", batch_size=n, dataset=name, seq_len=L, vocab_size=V,
        seed=seed))


def _groups(seed=0):
    """One stage's MoE groups, the JAX layout: G = 2 of nd = 1 dense
    layer and one MoE block, random f32 weights."""
    gen = np.random.default_rng(seed)
    f = lambda *s: gen.standard_normal(s).astype(np.float32) * 0.2  # noqa
    G, dh = 2, D // H
    per = {"ln1_scale": lambda *p: 1 + f(*p, D), "ln1_bias": lambda *p:
           f(*p, D), "qkv": lambda *p: f(*p, D, 3, H, dh), "out":
           lambda *p: f(*p, H, dh, D), "ln2_scale": lambda *p: 1 + f(*p, D),
           "ln2_bias": lambda *p: f(*p, D)}
    lp = {f"dense_{k}": mk(G, 1) for k, mk in per.items()}
    lp["dense_wi"], lp["dense_wo"] = f(G, 1, D, 4 * D), f(G, 1, 4 * D, D)
    lp.update({f"moe_{k}": mk(G) for k, mk in per.items()})
    lp["moe_router"] = f(G, D, EXPERTS)
    lp["moe_wi"] = f(G, EXPERTS, D, 4 * D)
    lp["moe_wo"] = f(G, EXPERTS, 4 * D, D)
    return lp


@pytest.mark.parametrize("remat", [False, True])
def test_moe_stage_apply_matches_jax(remat):
    """The group loop, its raw per-group sums and its gradients against
    the JAX ``moe_stage_apply`` (remat checkpoints each dense layer and
    each MoE block on both sides)."""
    lp = _groups()
    gen = np.random.default_rng(1)
    x = gen.standard_normal((2, L, D)).astype(np.float32)
    mask = np.ones((2, L), np.int32)
    mask[1, 12:] = 0
    w = gen.standard_normal(x.shape).astype(np.float32)

    def jax_loss(lp_, x_):
        out, (F, P, n) = jpl.moe_stage_apply(
            lp_, x_, jnp.asarray(mask), num_heads=H, dtype=jnp.float32,
            causal=True, attention_impl="xla", remat=remat, moe_top_k=2,
            capacity_factor=1.25, moe_no_drop=False)
        return jnp.sum(out * w) + jnp.sum(P * P), (out, F, P, n)

    (_, (want, F, P, n)), (g_lp, g_x) = _fast_jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True), lp, jnp.asarray(x))
    tlp = {k: v.requires_grad_() for k, v in _t(lp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, stats = pl.moe_stage_apply(
        tlp, tx, torch.from_numpy(mask), dtype=torch.float32, causal=True,
        attention_impl="xla", remat=remat, top_k=2, capacity_factor=1.25)
    tP = torch.stack([s[1] for s in stats])
    ((out * torch.from_numpy(w)).sum() + (tP * tP).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(torch.stack([s[0] for s in stats]).numpy(),
                                  np.asarray(F))
    np.testing.assert_allclose(tP.detach().numpy(), np.asarray(P),
                               rtol=2e-5)
    assert all(float(s[2]) == float(n) for s in stats)
    for got, ref, what in [(tx.grad, g_x, "x")] + [
            (tlp[k].grad, g_lp[k], k) for k in lp]:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max(),
                                   err_msg=what)


@pytest.fixture(scope="module", params=sorted(CFGS))
def moe_pair(request):
    """One family's JAX stacked MoE workload, named-block weights
    (``convert.init_params``, the JAX initializers' draws) and the same
    weights in the port's stacked layout."""
    fam = request.param
    sd = init_params(CFGS[fam], 1)
    return {"fam": fam, "scan_wl": jax_create(**CFGS[fam], scan_layers=True),
            "named": params_to_flax(sd), "sd": sd,
            "stacked": stack_blocks(sd)}


def _port(fam, scan, sd):
    m = create_model_from_config(**CFGS[fam], scan_layers=scan,
                                 device="cpu")
    m.load_state_dict(sd)
    return m


def test_stack_blocks_is_the_jax_transplant(moe_pair):
    """``stack_blocks`` of the named MoE tree is the JAX transplant test's
    (dense blocks 0, 2 -> ``dense_*[:, None]``, MoE blocks 1, 3 ->
    ``moe_*``), with the JAX ``MoEScanBlocks`` tree's structure; the JAX
    stacked tree round-trips through the port's stacked model bitwise,
    and named <-> stacked round-trips bitwise."""
    pn = moe_pair["named"]["params"]
    dense = [pn["backbone"][f"block_{i}"] for i in (0, 2)]
    moe = [pn["backbone"][f"block_{i}"] for i in (1, 3)]
    want = {}
    for name, (a, b) in (("ln1_scale", ("ln1", "scale")),
                         ("ln1_bias", ("ln1", "bias")),
                         ("qkv", ("attn", "qkv")), ("out", ("attn", "out")),
                         ("ln2_scale", ("ln2", "scale")),
                         ("ln2_bias", ("ln2", "bias"))):
        want[f"dense_{name}"] = np.stack([d[a][b] for d in dense])[:, None]
        want[f"moe_{name}"] = np.stack([m[a][b] for m in moe])
    for name in ("wi", "wo"):
        want[f"dense_{name}"] = np.stack([d["mlp"][name]
                                          for d in dense])[:, None]
        want[f"moe_{name}"] = np.stack([m["moe"][name] for m in moe])
    want["moe_router"] = np.stack([m["moe"]["router"] for m in moe])
    got = moe_pair["stacked"]
    blocks = {k[len("backbone.blocks."):]: v for k, v in got.items()
              if k.startswith("backbone.blocks.")}
    assert set(blocks) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(blocks[k].numpy(), v, err_msg=k)
    ref = jax.tree_util.tree_structure(meta.unbox(jax.eval_shape(
        moe_pair["scan_wl"].init_params, jax.random.PRNGKey(2))))
    tree = params_to_flax(got)
    assert jax.tree_util.tree_structure(tree) == ref
    m = _port(moe_pair["fam"], True, got)
    for k, v in m.state_dict().items():
        assert torch.equal(v, got[k]), k
    back = unstack_blocks(got)
    assert set(back) == set(moe_pair["sd"])
    for k, v in back.items():
        assert torch.equal(v, moe_pair["sd"][k]), k


def _draws(key, sched, n=8):
    """The draws the JAX DiffuSeq loss takes from ``key``."""
    rng_t, rng_noise = jax.random.split(key)
    return {"t": torch.from_numpy(np.array(sched.sample_t(rng_t, n))),
            "noise": torch.from_numpy(np.array(
                jax.random.normal(rng_noise, (n, L, E), jnp.float32)))}


def test_moe_scan_blocks_match_jax_and_the_named_model(moe_pair):
    """The stacked MoE model on the transplanted weights: its losses and
    ``moe_aux`` bitwise the named-block model's, against the JAX
    ``MoEScanBlocks`` at rtol 1e-5, and its gradients against
    ``jax.grad`` of the JAX stacked loss at the MoE gradient test's bar
    (rtol 5e-4, atol 1e-6)."""
    fam = moe_pair["fam"]
    batch = _batch(fam)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    stacked = _port(fam, True, moe_pair["stacked"])
    named = _port(fam, False, moe_pair["sd"])
    wl = moe_pair["scan_wl"]
    key = jax.random.PRNGKey(9)
    draws = _draws(key, wl.schedule) if fam == "diffuseq" else None
    got = compute_losses(stacked, tb, draws)
    with torch.no_grad():
        other = compute_losses(named, tb, draws)
    for k in other:
        assert torch.equal(got[k].detach(), other[k]), k
    got["loss"].backward()
    params = jax.tree_util.tree_map(jnp.asarray,
                                    params_to_flax(moe_pair["stacked"]))

    def jax_loss(p):
        d = wl.compute_losses(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, key)
        return d["loss"], d

    (_, ref), grads = _fast_jit(jax.value_and_grad(jax_loss, has_aux=True),
                                params)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    want = params_from_flax(_np(grads))
    for name, p in stacked.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=5e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("src_scan", [True, False])
def test_moe_checkpoint_loads_across_block_layouts(tmp_path, src_scan):
    """A stacked MoE loop's save resumes in a named-block loop and the
    reverse: the restored state is the saved one, bitwise, and the next
    step's loss equals the uninterrupted run's."""
    fam = "gpt2"
    sd = init_params(dict(CFGS[fam], scan_layers=src_scan), 0)
    run = str(tmp_path / "run")

    def loop(scan, state=None):
        return TrainLoop(model=create_model_from_config(
            **CFGS[fam], scan_layers=scan, device="cpu"), data=None,
            init_params=state, fused_update="false", checkpoint_dir=run,
            seed=3, **{**LOOP, "gradient_clipping": -1.0})

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
    opt = torch.load(f"{run}/opt_000002.pt", weights_only=True)
    for k, v in b.state_dict_of(b.mu).items():
        assert torch.equal(v, convert(opt["mu"])[k]), k
    assert float(b.run_step(_batch(fam, 2))["loss"]) == want


def test_run_sample_on_a_stacked_moe_run_dir(tmp_path):
    """``run.sample`` on a stacked MoE GPT-2 run dir decodes by the full
    recompute (``gpt2_decode``: MoE groups keep no cache) token for token
    as the named-block run dir through the paged engine; the stacked
    model refuses a cache with the JAX message."""
    outs = {}
    for scan in (True, False):
        cfg = dict(CFGS["gpt2"], scan_layers=scan)
        run = str(tmp_path / f"run{int(scan)}")
        sd = init_params(dict(cfg, scan_layers=False), 0)
        save_run(run, cfg, stack_blocks(sd) if scan else sd, step=3)
        outs[scan] = sample_mod.main([
            "--checkpoint_path", run, "--device", "cpu", "--batch_size",
            "4", "--num_batches", "2", "--out", str(tmp_path / f"p{scan}")])
        outs[scan]["rows"] = (tmp_path / f"p{scan}").read_text()
    assert outs[True] == outs[False]
    assert outs[True]["step"] == 3
    model, _targs, _step = sample_mod.load_run(str(tmp_path / "run1"),
                                               device="cpu")
    assert isinstance(model.backbone.blocks, pl.MoEScanBlocks)
    ids = torch.zeros(2, L, dtype=torch.int64)
    with pytest.raises(ValueError, match="no KV-cache decode path"):
        model(ids, kv_cache=[pl.DenseKV() for _ in range(LAYERS)])
    assert torch.equal(gpt2_decode(model, ids, 8),
                       gpt2_decode(model, ids, 8, use_cache=False))
