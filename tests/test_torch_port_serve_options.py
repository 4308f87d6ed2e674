"""The single-replica server's options in the port, on the CPU, against the
JAX package: the prefix cache (``PrefixCache`` state op for op, the cache's
serving properties, a prefix-cache server against the JAX XLA-arm server),
the traffic generator, ``--serve_quant int8``, the sanitizer's report, the
device-keyed sampler, and ``run.serve --device cpu`` with each option. The
``cuda`` tests at the end hold the graph-replayed engine against the eager
one on the card (run there by ``scripts/run_torch_cuda_tests.py``)."""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.serving import \
    DecodeServer as JaxDecodeServer  # noqa: E402
from distributed_pipeline_tpu.serving import paged_kv as jax_paged  # noqa
from distributed_pipeline_tpu.serving import traffic as jax_traffic  # noqa
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    init_params, params_from_flax)
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.ops import flash_decode as fd  # noqa
from distributed_pipeline_tpu_torch.run import serve as serve_mod  # noqa
from distributed_pipeline_tpu_torch.serving import paged_kv  # noqa: E402
from distributed_pipeline_tpu_torch.serving import traffic  # noqa: E402
from distributed_pipeline_tpu_torch.models.sampling import (  # noqa: E402
    _hash32, keyed_gumbel)
from distributed_pipeline_tpu_torch.serving.quantize import (  # noqa: E402
    QuantizationError, quantize_state_dict)
from distributed_pipeline_tpu_torch.serving.scheduler import \
    DecodeServer  # noqa: E402
from distributed_pipeline_tpu_torch.utils.checkpoint import \
    save_run  # noqa: E402

CFG = dict(model_family="gpt2", vocab_size=64, seq_len=32, hidden_size=32,
           num_layers=2, num_heads=2, dtype="float32")
KW = dict(decode_slots=2, page_size=4, max_prompt_len=12, max_len=32,
          decode_span=2, seed=0)
# a near-tie of the JAX logits may flip a greedy pick between the packages
# (tests/test_torch_port_serve.py, GAP_BAR): below it the streams continue
# from the JAX pick
GAP_BAR = 1e-4


@pytest.fixture(scope="module")
def jax_and_port():
    wl = jax_create(**CFG)
    params = jax.tree_util.tree_map(
        np.asarray, meta.unbox(wl.init_params(jax.random.PRNGKey(4))))
    model = create_model_from_config(**CFG, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return wl, params, model


def _top2_gap(wl, params, ids) -> float:
    import jax.numpy as jnp
    logits = np.asarray(wl.model.apply(
        params, jnp.asarray(ids, jnp.int32)[None],
        jnp.ones((1, len(ids)), jnp.int32)))[0, -1]
    top = np.sort(logits.astype(np.float64))[-2:]
    return float(top[1] - top[0])


def _same_or_near_tie(wl, params, prompt, jax_toks, port_toks) -> None:
    """Equal streams, or equal up to a first divergence at a near-tie of
    the JAX logits."""
    assert len(jax_toks) == len(port_toks)
    if jax_toks == port_toks:
        return
    i = next(i for i, (a, b) in enumerate(zip(jax_toks, port_toks))
             if a != b)
    ctx = np.concatenate([prompt, np.asarray(jax_toks[:i], np.int32)])
    assert _top2_gap(wl, params, ctx) < GAP_BAR, \
        f"token {i} differs from the JAX server at a clear decision"


def _shared_prefix_prompts(n=6, shared=8, length=11, seed=3):
    rng = np.random.default_rng(seed)
    head = rng.integers(4, 64, (shared,)).astype(np.int32)
    return [np.concatenate([head, rng.integers(4, 64, (length - shared,))
                            .astype(np.int32)]) for _ in range(n)]


# ---------------------------------------------------------- PrefixCache

_OPS = st.lists(st.tuples(st.sampled_from(["admit", "finish", "evict"]),
                          st.integers(0, 5), st.integers(1, 12)),
                 min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(_OPS)
def test_prefix_cache_state_equals_jax_op_for_op(ops):
    """Admissions (acquire, alloc, evict_for under pressure, publish, the
    scheduler's path), completions (release, then free) and evictions over
    the same PageManager geometry: every return value, the pool's free
    count and ``stats()`` equal the JAX class's after every operation."""
    rng = np.random.default_rng(0)
    heads = [rng.integers(0, 50, (8,)).astype(np.int32) for _ in range(3)]
    prompts = [np.concatenate([heads[i % 3][:4 + 4 * (i % 2)],
                               np.full(3 + i, i, np.int32)])
               for i in range(6)]
    sides = []
    for mod in (jax_paged, paged_kv):
        mgr = mod.PageManager(14, 4)
        sides.append((mgr, mod.PrefixCache(mgr, max_entries=6), []))

    def admit(mgr, cache, prompt, budget):
        shared, covered = cache.acquire(prompt)
        need = mgr.pages_for(len(prompt) + budget) - len(shared)
        fresh = mgr.alloc(need) if need > 0 else np.zeros((0,), np.int32)
        evicted = 0
        if fresh is None:
            evicted = cache.evict_for(need)
            fresh = mgr.alloc(need)
        if fresh is None:
            back = cache.release(prompt[:covered],
                                 np.asarray(shared, np.int32))
            if back.size:
                mgr.free(back)
            return (shared, covered, evicted, None), None
        pages = np.concatenate([np.asarray(shared, np.int32), fresh])
        cache.publish(prompt, pages, n_acquired=len(shared))
        return (shared, covered, evicted, pages.tolist()), pages

    for op, k, n in ops:
        results = []
        for mgr, cache, live in sides:
            if op == "admit":
                out, pages = admit(mgr, cache, prompts[k], n)
                if pages is not None:
                    live.append((prompts[k], pages))
            elif op == "finish" and live:
                prompt, pages = live.pop(k % len(live))
                back = cache.release(prompt, pages)
                if back.size:
                    mgr.free(back)
                out = sorted(back.tolist())
            else:
                out = cache.evict_for(n)
            results.append((out, mgr.free_pages, cache.stats(),
                            cache.resident_pages))
        assert results[0] == results[1]


def test_prefix_cache_unit_refcounts():
    """The JAX unit test on the port's class: acquire refs, release frees
    only the private tail, eviction orphans slot-ref'd pages, and they come
    back with the last slot ref."""
    mgr = paged_kv.PageManager(num_pages=9, page_size=4)
    cache = paged_kv.PrefixCache(mgr)
    prompt = np.arange(10, dtype=np.int32)
    assert cache.acquire(prompt) == ([], 0)
    pages = mgr.alloc(4)
    cache.publish(prompt, pages)
    shared, covered = cache.acquire(prompt)
    assert covered == 8 and shared == [int(p) for p in pages[:2]]
    tail = cache.release(prompt, pages)
    assert tail.tolist() == [int(p) for p in pages[2:]]
    mgr.free(tail)
    free_before = mgr.free_pages
    assert cache.evict_for(mgr.capacity + 1) == 0
    assert mgr.free_pages == free_before
    assert cache.stats()["prefix_entries"] == 0
    back = cache.release(prompt, np.asarray(shared, np.int32))
    assert sorted(back.tolist()) == sorted(int(p) for p in pages[:2])
    mgr.free(back)
    assert mgr.free_pages == mgr.capacity


def test_prefix_cache_no_deadlock_under_shared_prefix_churn():
    """40 requests over one shared 8-token head through a 17-page pool and
    2 slots: every admission succeeds (eviction frees cold entries while
    the hot head stays pinned), nothing leaks."""
    mgr = paged_kv.PageManager(num_pages=17, page_size=4)
    cache = paged_kv.PrefixCache(mgr)
    head = np.arange(100, 108, dtype=np.int32)
    live = []
    for i in range(40):
        prompt = np.concatenate([head, np.arange(i, i + 4, dtype=np.int32)])
        shared, _ = cache.acquire(prompt)
        need = 5 - len(shared)
        fresh = mgr.alloc(need)
        if fresh is None:
            cache.evict_for(need)
            fresh = mgr.alloc(need)
        assert fresh is not None, f"admission {i} deadlocked"
        pages = np.concatenate([np.asarray(shared, np.int32), fresh])
        cache.publish(prompt, pages, n_acquired=len(shared))
        live.append((prompt, pages))
        if len(live) == 2:
            back = cache.release(*live.pop(0))
            if back.size:
                mgr.free(back)
    for prompt, pages in live:
        back = cache.release(prompt, pages)
        if back.size:
            mgr.free(back)
    assert mgr.free_pages + cache.resident_pages == mgr.capacity
    assert cache.stats()["prefix_hits"] >= 38


@pytest.mark.parametrize("kv_quant", ["fp", "int8"])
def test_prefix_cache_bit_identical_to_cold_prefill(jax_and_port, kv_quant):
    """A warm hit (the prompt's full pages reused) decodes exactly as a
    cold prefill, and so does a prompt that shares only its first page;
    the cache holds pages, it does not leak them."""
    _, _, model = jax_and_port
    kw = dict(KW, kv_quant=kv_quant, device="cpu")
    prompt = np.random.default_rng(0).integers(4, 64, (11,)).astype(np.int32)
    div = prompt.copy()
    div[5] = (div[5] + 1) % 64

    def cold(p):
        srv = DecodeServer(model, **kw)
        req = srv.submit(p, max_new_tokens=6)
        srv.drain()
        return req.tokens

    warm = DecodeServer(model, prefix_cache=True, **kw)
    got = []
    for p in (prompt, prompt, div):
        req = warm.submit(p, max_new_tokens=6)
        warm.drain()
        got.append(req.tokens)
    assert got == [cold(prompt), cold(prompt), cold(div)]
    st_ = warm.prefix_stats()
    assert st_["prefix_hits"] >= 2 and st_["prefix_pages_reused"] >= 3
    assert warm.mgr.free_pages + st_["prefix_resident_pages"] \
        == warm.mgr.capacity


def test_prefix_cache_refcount_blocks_early_free(jax_and_port):
    """The publisher finishes while its sharer still decodes, and a third
    prompt needs eviction to fit a tight pool: the sharer's pages survive
    (its slot refs) and every stream equals its cold run."""
    _, _, model = jax_and_port
    kw = dict(decode_slots=2, page_size=4, max_prompt_len=8, max_len=32,
              seed=0, device="cpu")
    prompt = np.random.default_rng(1).integers(4, 64, (8,)).astype(np.int32)
    other = np.asarray([9, 13, 17, 21, 25, 29, 5, 7], np.int32)

    def cold(p, n):
        srv = DecodeServer(model, **kw)
        req = srv.submit(p, max_new_tokens=n)
        srv.drain()
        return req.tokens

    tight = DecodeServer(model, max_pages=6, prefix_cache=True, **kw)
    a = tight.submit(prompt, max_new_tokens=2)
    b = tight.submit(prompt, max_new_tokens=6)
    tight.step()
    c = tight.submit(other, max_new_tokens=6)
    tight.drain()
    assert a.tokens == cold(prompt, 2)
    assert b.tokens == cold(prompt, 6), "the sharer's pages were stolen"
    assert c.tokens == cold(other, 6)
    st_ = tight.prefix_stats()
    assert st_["prefix_evicted_entries"] >= 1
    assert tight.mgr.free_pages + st_["prefix_resident_pages"] \
        == tight.mgr.capacity


def test_prefix_cache_server_equals_jax_server(jax_and_port):
    """Six prompts sharing an 8-token head (two full pages) on two slots:
    the port's prefix-cache server gives the JAX XLA-arm prefix-cache
    server's tokens (near-tie rule), its ``prefix_stats()`` equal JAX's,
    and the pool is whole after the drain."""
    wl, params, model = jax_and_port
    prompts = _shared_prefix_prompts()
    budgets = [5, 7, 4, 6, 3, 8]
    outs, stats = [], []
    for srv in (JaxDecodeServer(wl, params, decode_impl="xla",
                                prefix_cache=True, **KW),
                DecodeServer(model, prefix_cache=True, device="cpu", **KW)):
        reqs = [srv.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        srv.drain()
        outs.append([r.tokens for r in reqs])
        stats.append(srv.prefix_stats())
        assert srv.mgr.free_pages + stats[-1]["prefix_resident_pages"] \
            == srv.mgr.capacity
    assert stats[0] == stats[1] and stats[1]["prefix_hits"] >= 4
    for p, j, t in zip(prompts, *outs):
        _same_or_near_tie(wl, params, p, j, t)


# ------------------------------------------------------------- traffic

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_traffic_bitwise_equal_to_jax(process, seed):
    kw = dict(burst_every_s=0.5, burst_size=3, diurnal_period_s=4.0,
              diurnal_floor=0.3)
    ours = traffic.TrafficGenerator(process, 5.0, seed, **kw)
    ref = jax_traffic.TrafficGenerator(process, 5.0, seed, **kw)
    np.testing.assert_array_equal(ours.schedule(40), ref.schedule(40))
    a = ours.requests(12, vocab_size=64, prompt_len=10, max_new_tokens=4,
                      prompt_len_jitter=3, shared_prefix_len=6)
    b = ref.requests(12, vocab_size=64, prompt_len=10, max_new_tokens=4,
                     prompt_len_jitter=3, shared_prefix_len=6)
    for x, y in zip(a, b):
        assert x.t == y.t and x.max_new_tokens == y.max_new_tokens
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert x.prompt.dtype == y.prompt.dtype
    assert ours.describe() == ref.describe()
    assert traffic.make_generator("steps", 5.0, seed) is None


# ---------------------------------------------------------- quantization

def test_quantized_weights_bitwise_equal_to_jax(jax_and_port):
    from distributed_pipeline_tpu.serving.quantize import quantize_params
    _, params, _ = jax_and_port
    ref = params_from_flax(jax.tree_util.tree_map(
        np.asarray, quantize_params(params)))
    got = quantize_state_dict(params_from_flax(params))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        assert torch.equal(got[k], ref[k]), k
    some = ref["backbone.block_0.attn.qkv"]
    assert not torch.equal(some, params_from_flax(params)[
        "backbone.block_0.attn.qkv"])   # the round-trip changed it


def test_quantize_guard_raises_as_jax_does():
    from distributed_pipeline_tpu.serving.quantize import (
        QuantizationError as JaxQuantizationError, quantize_leaf)
    bad = np.ones((4, 3), np.float32)
    bad[1, 2] = np.nan
    with pytest.raises(JaxQuantizationError, match="non-finite"):
        quantize_leaf(bad, 0.02)
    with pytest.raises(QuantizationError, match="non-finite"):
        quantize_state_dict({"w": torch.from_numpy(bad)})
    x = np.random.default_rng(0).standard_normal((8, 5)).astype(np.float32)
    with pytest.raises(JaxQuantizationError, match="rel err"):
        quantize_leaf(x, 1e-6)
    with pytest.raises(QuantizationError, match="rel err"):
        quantize_state_dict({"w": torch.from_numpy(x)}, max_rel_err=1e-6)
    ints = {"i": torch.arange(5)}
    assert quantize_state_dict(ints)["i"] is ints["i"]


def test_serve_quant_server_equals_jax_server(jax_and_port):
    """A server over int8-round-tripped weights gives the JAX server's
    tokens on the JAX package's quantized params (near-tie rule)."""
    from distributed_pipeline_tpu.serving.quantize import quantize_params
    wl, params, _ = jax_and_port
    qparams = jax.tree_util.tree_map(np.asarray, quantize_params(params))
    model = create_model_from_config(**CFG, device="cpu")
    model.load_state_dict(quantize_state_dict(params_from_flax(params)))
    prompts = _shared_prefix_prompts(n=4, seed=9)
    outs = []
    for srv in (JaxDecodeServer(wl, qparams, decode_impl="xla", **KW),
                DecodeServer(model, device="cpu", **KW)):
        reqs = [srv.submit(p, max_new_tokens=6) for p in prompts]
        srv.drain()
        outs.append([r.tokens for r in reqs])
    for p, j, t in zip(prompts, *outs):
        _same_or_near_tie(wl, qparams, p, j, t)


# ------------------------------------------------------------- sampling

def test_keyed_gumbel_is_a_function_of_seed_slot_position():
    """The noise of a row depends on (seed, slot, position) only: the same
    key gives the same row in any batch, at any row index; another slot,
    position or seed gives another row."""
    vh = _hash32(torch.arange(64))
    a = keyed_gumbel(5, torch.tensor([0, 1, 2]), torch.tensor([7, 7, 9]), vh)
    b = keyed_gumbel(5, torch.tensor([2, 0]), torch.tensor([9, 7]), vh)
    assert torch.equal(a[0], b[1]) and torch.equal(a[2], b[0])
    assert not torch.equal(a[0], a[1])
    c = keyed_gumbel(6, torch.tensor([0]), torch.tensor([7]), vh)
    assert not torch.equal(a[0], c[0])
    assert bool(torch.isfinite(a).all())
    # the keys are exact integers: the same on every device and call
    assert _hash32(123456789) == int(_hash32(torch.tensor(123456789)))


def test_sampled_picks_repeat(jax_and_port):
    """temperature > 0: two servers with the same seed give the same
    tokens; the noise is not drawn from any global generator."""
    _, _, model = jax_and_port
    p = _shared_prefix_prompts(n=2)

    def run():
        srv = DecodeServer(model, temperature=0.9, top_k=16, device="cpu",
                           **KW)
        reqs = [srv.submit(x, max_new_tokens=8) for x in p]
        srv.drain()
        return [r.tokens for r in reqs]

    a = run()
    torch.manual_seed(123)
    np.random.seed(5)
    assert run() == a


# ------------------------------------------------------------- sanitizer

def test_sanitize_report_records_a_trip_and_jax_reads_it(jax_and_port,
                                                         tmp_path):
    """A sync refused inside a dispatch (here its error, raised through the
    engine's test hook: the CPU has no guard) is recorded as a
    ``transfer_guard`` violation at the port's frame and re-raised; the
    report is written in the JAX schema that the JAX reader accepts."""
    from distributed_pipeline_tpu.analysis.cli import _load_sanitize_reports
    _, _, model = jax_and_port
    srv = DecodeServer(model, sanitize=True, device="cpu", **KW)

    def trip(phase):
        raise RuntimeError("called a synchronizing CUDA operation")

    srv.engine._dispatch_hook = trip
    srv.submit(np.arange(4, 10, dtype=np.int32), max_new_tokens=3)
    with pytest.raises(RuntimeError, match="synchronizing"):
        srv.step()
    path = srv.write_sanitize_report(str(tmp_path))
    [(read_path, report)] = _load_sanitize_reports(str(tmp_path))
    assert read_path == path and report["version"] == 1
    [v] = report["violations"]
    assert v["kind"] == "transfer_guard" and v["func"] == "trip"
    assert v["path"].endswith("test_torch_port_serve_options.py")


@pytest.fixture
def run_dir(tmp_path):
    cfg = dict(CFG, model_size="base")
    sd = init_params(dict(vocab_size=64, seq_len=32, hidden_size=32,
                          num_layers=2, num_heads=2), seed=0)
    save_run(str(tmp_path / "run"), cfg, sd, step=7)
    return str(tmp_path / "run")


ARGV = ["--device", "cpu", "--decode_slots", "2", "--page_size", "4",
        "--max_prompt_len", "12", "--synthetic_requests", "5",
        "--synthetic_prompt_len", "10", "--max_new_tokens", "4",
        "--decode_span", "2"]


def test_run_serve_sanitize_cpu(run_dir):
    """``--sanitize true`` on the CPU: the report beside the checkpoint
    reads in the JAX reader with no violation, and ``recompile_count`` is
    0. There is no CUDA graph on the CPU, so no capture at all:
    ``xla_compiles_total`` and ``compile_time_s`` are 0 too."""
    from distributed_pipeline_tpu.analysis.cli import _load_sanitize_reports
    out = serve_mod.main(["--checkpoint_path", run_dir, *ARGV,
                          "--sanitize", "true"])
    assert out["recompile_count"] == 0 and out["xla_compiles_total"] == 0
    assert out["compile_time_s"] == 0.0 and out["decode_tokens"] == 20
    [(path, report)] = _load_sanitize_reports(run_dir)
    assert path == os.path.join(run_dir, "sanitize_report.json")
    assert report == {"version": 1, "violations": []}


@pytest.mark.parametrize("extra,check", [
    (["--prefix_cache", "true", "--shared_prefix_len", "8"],
     lambda r: r["prefix_hits"] >= 3 and r["prefix_misses"] >= 1),
    (["--traffic", "poisson", "--rate_rps", "400"],
     lambda r: r["traffic"] == "poisson"),
    (["--traffic", "bursty", "--burst_every_s", "0.02", "--burst_size", "2"],
     lambda r: r["traffic"] == "bursty"),
    (["--traffic", "diurnal", "--rate_rps", "400", "--diurnal_period_s",
      "0.05", "--diurnal_floor", "0.5"], lambda r: r["traffic"] == "diurnal"),
    (["--serve_quant", "int8"], lambda r: r["serve_quant"] == "int8"),
    (["--cost_ledger", "true"],
     lambda r: set(r["ledger"]) == {"serve_prefill", "serve_decode"}),
], ids=["prefix_cache", "poisson", "bursty", "diurnal", "serve_quant",
        "cost_ledger"])
def test_run_serve_cpu_with_option(run_dir, extra, check):
    out = serve_mod.main(["--checkpoint_path", run_dir, *ARGV, *extra])
    assert out["requests"] == 5 and out["decode_tokens"] == 20
    assert check(out), out


def test_run_serve_trace_prints_the_notice(run_dir, capsys):
    out = serve_mod.main(["--checkpoint_path", run_dir, *ARGV,
                          "--trace", "true"])
    assert out["decode_tokens"] == 20
    assert "--trace instruments fleet mode" in capsys.readouterr().err


def test_run_serve_wall_clock_traffic_matches_step_streams(run_dir):
    """The same prompts under a wall-clock process and under the step
    cadence give the same greedy streams (arrival order changes slots, not
    tokens)."""
    outs = []
    for traffic_args in (["--traffic", "poisson", "--rate_rps", "300"],
                         ["--shared_prefix_len", "4"]):
        path = os.path.join(os.path.dirname(run_dir),
                            f"out_{len(outs)}.jsonl")
        serve_mod.main(["--checkpoint_path", run_dir, *ARGV, "--out", path,
                        "--shared_prefix_len", "4", *traffic_args])
        with open(path) as f:
            outs.append([json.loads(line) for line in f])
    assert [r["prompt"] for r in outs[0]] == [r["prompt"] for r in outs[1]]
    assert [r["tokens"] for r in outs[0]] == [r["tokens"] for r in outs[1]]


def test_cpu_engine_is_eager(jax_and_port):
    """CPU tensors always run eagerly: no graph, no capture time, and the
    sanitizer's guard is not armed (there is no host-device boundary)."""
    _, _, model = jax_and_port
    srv = DecodeServer(model, sanitize=True, cuda_graphs=True, device="cpu",
                       **KW)
    srv.submit(np.arange(4, 11, dtype=np.int32), max_new_tokens=5)
    srv.drain()
    eng = srv.engine
    assert not eng.cuda_graphs and not eng.guard
    assert eng.executables() == {} and eng.captures == {}
    assert eng.dispatches == {"prefill": 1, "decode": 2}
    assert srv.compile_time_s == 0.0 and srv.recompile_count == 0


def test_launch_counters_round_trip():
    before = fd.launch_counters()
    delta = {"decode_fp": 3, "decode_int8": 0, "span_fp": 1,
             "span_int8": 2, "seam": 1}
    fd.add_launches(delta, times=2)
    after = fd.launch_counters()
    assert {k: after[k] - before[k] for k in after} == \
        {k: 2 * v for k, v in delta.items()}
    fd.add_launches(delta, times=-2)
    assert fd.launch_counters() == before


# ------------------------------------------------------------ on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the graph engine captures CUDA graphs")
    return torch.device("cuda")


def _card_model(dtype="bfloat16"):
    cfg = dict(CFG, vocab_size=256, seq_len=128, hidden_size=128,
               num_heads=2, dtype=dtype)
    model = create_model_from_config(**cfg, device="cuda")
    model.load_state_dict(init_params(cfg, seed=1))
    return model


def _serve_on_card(model, prompts, budget=12, **kw):
    fd.reset_launch_count()
    srv = DecodeServer(model, decode_slots=4, page_size=16,
                       max_prompt_len=64, decode_span=3, device="cuda", **kw)
    reqs = [srv.submit(p, max_new_tokens=budget) for p in prompts]
    srv.drain()
    torch.cuda.synchronize()
    return srv, [r.tokens for r in reqs], fd.launch_counters()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant,spec", [("fp", 0), ("int8", 0),
                                           ("fp", 4)],
                         ids=["fp", "int8", "spec4"])
def test_graph_replay_equals_eager_on_card(kv_quant, spec):
    """The graph engine's streams equal the eager engine's token for token,
    its launches are counted through the replays (equal to the eager
    run's), and each phase was captured once."""
    _cuda()
    model = _card_model()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(4, 256, (int(n),)).astype(np.int32)
               for n in (40, 7, 63, 20, 33, 12, 50, 9)]
    kw = dict(kv_quant=kv_quant, spec_tokens=spec)
    gsrv, gtoks, glaunch = _serve_on_card(model, prompts, **kw)
    esrv, etoks, elaunch = _serve_on_card(model, prompts,
                                          cuda_graphs=False, **kw)
    assert gtoks == etoks
    assert glaunch == elaunch and sum(glaunch.values()) > 0
    assert esrv.engine.executables() == {}
    phases = {"prefill", "verify"} if spec else {"prefill", "decode"}
    assert set(gsrv.engine.executables()) == phases
    assert all(n == 1 for n in gsrv.engine.captures.values())
    assert gsrv.compile_time_s > 0 and esrv.compile_time_s == 0


@pytest.mark.cuda
def test_sanitized_graph_server_on_card():
    """Under sanitize: captures happen only before the first fetched token
    (no steady recapture, no violation), and a sync injected into a
    dispatch through the test hook raises and is recorded."""
    _cuda()
    model = _card_model()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 256, (30,)).astype(np.int32)
               for _ in range(6)]
    srv = DecodeServer(model, decode_slots=4, page_size=16,
                       max_prompt_len=64, decode_span=2, sanitize=True,
                       device="cuda")
    for p in prompts:
        srv.submit(p, max_new_tokens=10)
    srv.drain()
    assert srv.stop_sanitizer() == 2   # prefill and decode, once each
    assert srv._recompiles_at_first_token == 2
    assert srv.sanitize_report.violations == []
    srv.engine._dispatch_hook = lambda phase: srv.engine.tokens.cpu()
    srv.submit(prompts[0], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="synchronizing"):
        srv.step()
    [v] = srv.sanitize_report.violations
    assert v["kind"] == "transfer_guard"
    assert torch.cuda.get_sync_debug_mode() == 0
