"""The port's speculative decoding on the CPU, against the JAX package's.

Mirrors tests/test_spec_decode.py on a tiny GPT-2 (vocab 64, hidden 32, 2
layers, 2 heads, seq_len 16, f32; 2 slots, page 4):

* greedy spec streams equal the port's non-spec streams and the JAX XLA-arm
  server's, with ngram and model drafts, over fp and int8 pools; sampled
  (temperature, top-k) spec streams equal the port's sampled non-spec
  streams (the picks are keyed per (slot, position));
* rejection bookkeeping at exact positions, EOS inside an accepted prefix,
  no slot or page leaks;
* the span writers: ``write_span_kv`` bitwise the sequential token writes
  and the JAX writer, overshoot clamped (never wrapped), ``write_span_kv_q8``
  bitwise the JAX writer, within its page scale, cold pages untouched;
* ``torch_paged_span_decode``: each link bitwise the single-token plain
  output at its position, and within f32 rounding of the JAX
  ``xla_paged_span_decode`` (another library's summation order: rtol 1e-5,
  atol 1e-6);
* ``ngram_propose`` bitwise the JAX function; the settings; the span seam's
  dispatch, and its kernel arm on the card (``cuda`` marker).
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.ops import flash_decode as jfd  # noqa: E402
from distributed_pipeline_tpu.serving import \
    DecodeServer as JaxDecodeServer  # noqa: E402
from distributed_pipeline_tpu.serving import paged_kv as jpkv  # noqa: E402
from distributed_pipeline_tpu.serving import spec as jspec  # noqa: E402
from distributed_pipeline_tpu_torch.config.serve import (  # noqa: E402
    DEFERRED, parse_settings)
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    init_params, params_from_flax)
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.ops import flash_decode as fd  # noqa: E402
from distributed_pipeline_tpu_torch.run import serve as serve_mod  # noqa: E402
from distributed_pipeline_tpu_torch.serving.paged_kv import (  # noqa: E402
    TRASH_PAGE, dequant_gathered, gather_kv, write_prompt_kv_q8,
    write_span_kv, write_span_kv_q8, write_token_kv)
from distributed_pipeline_tpu_torch.serving.scheduler import \
    DecodeServer  # noqa: E402
from distributed_pipeline_tpu_torch.serving.spec import (  # noqa: E402
    DRAFT_KINDS, ngram_propose, truncated_draft)
from distributed_pipeline_tpu_torch.utils.checkpoint import \
    save_run  # noqa: E402

VOCAB, SEQ = 64, 16
CFG = dict(model_family="gpt2", vocab_size=VOCAB, seq_len=SEQ,
           hidden_size=32, num_layers=2, num_heads=2, dtype="float32")
SERVE = dict(decode_slots=2, page_size=4, max_prompt_len=8, max_len=SEQ,
             seed=0)


@pytest.fixture(scope="module")
def jax_and_port():
    wl = jax_create(**CFG)
    params = jax.tree_util.tree_map(
        np.asarray, meta.unbox(wl.init_params(jax.random.PRNGKey(3))))
    model = create_model_from_config(**CFG, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return wl, params, model


def mixed_workload(n=10, seed=7):
    """Mixed prompts and budgets, as tests/test_spec_decode.py: slots churn
    through several admissions, so rollback interleaves with refill, and
    the longest requests reach the position table's end."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(4, VOCAB, (1 + i % 6,)).astype(np.int32)
               for i in range(n)]
    budgets = [2 + i % 7 for i in range(n)]
    return prompts, budgets


def serve(server, eos_id=None):
    """Run the mixed workload to completion; every slot and page must come
    back, every block-table row be trash again."""
    prompts, budgets = mixed_workload()
    reqs = [server.submit(p, b, eos_id=eos_id)
            for p, b in zip(prompts, budgets)]
    server.drain()
    assert server.free_slots == SERVE["decode_slots"]
    assert server.mgr.free_pages == server.mgr.capacity
    assert np.all(server.block_tables == TRASH_PAGE)
    return [list(r.tokens) for r in reqs]


_BASE = {}


def base(jax_and_port, side: str, kv_quant: str):
    """The non-speculative greedy streams: the JAX server's XLA arm, or
    the port's own, per pool (computed once)."""
    key = (side, kv_quant)
    if key not in _BASE:
        wl, params, model = jax_and_port
        if side == "jax":
            srv = JaxDecodeServer(wl, params, decode_impl="xla",
                                  kv_quant=kv_quant, **SERVE)
        else:
            srv = DecodeServer(model, device="cpu", kv_quant=kv_quant,
                               **SERVE)
        _BASE[key] = serve(srv)
    return _BASE[key]


@pytest.mark.parametrize("draft,kv_quant,k", [
    ("ngram", "fp", 1), ("ngram", "fp", 2), ("ngram", "int8", 2),
    ("model", "fp", 2), ("model", "int8", 3)])
def test_spec_greedy_token_identical(jax_and_port, draft, kv_quant, k):
    """Greedy speculative streams are the non-speculative streams of the
    port and of the JAX XLA-arm server, token for token."""
    _, _, model = jax_and_port
    srv = DecodeServer(model, device="cpu", kv_quant=kv_quant,
                       spec_tokens=k, spec_draft=draft, draft_layers=1,
                       **SERVE)
    got = serve(srv)
    assert got == base(jax_and_port, "port", kv_quant)
    assert got == base(jax_and_port, "jax", kv_quant)
    assert srv.spec_rounds == srv.decode_steps > 0
    assert srv.draft_proposed > 0 and srv.draft_proposed % k == 0
    assert 0.0 <= srv.accept_rate <= 1.0


def serve_in_pairs(server):
    """The mixed workload two requests at a time, drained in between, so
    request 2i takes slot 0 and 2i + 1 slot 1 on any path (with churn the
    slot a request gets depends on which request finished first, and a
    sampled pick is keyed by its slot)."""
    prompts, budgets = mixed_workload()
    out = []
    for i in range(0, len(prompts), 2):
        reqs = [server.submit(p, b) for p, b in zip(prompts[i:i + 2],
                                                     budgets[i:i + 2])]
        server.drain()
        out += [list(r.tokens) for r in reqs]
    assert server.mgr.free_pages == server.mgr.capacity
    return out


@pytest.mark.parametrize("draft,kv_quant", [("ngram", "fp"),
                                            ("model", "int8")])
def test_spec_sampled_token_identical(jax_and_port, draft, kv_quant):
    """With temperature and top-k the spec stream is the sampled
    non-spec stream: every pick is keyed per (slot, position), so what
    proposed a token never reaches the accepted stream."""
    _, _, model = jax_and_port
    kw = dict(temperature=0.8, top_k=8, kv_quant=kv_quant, **SERVE)
    ref = serve_in_pairs(DecodeServer(model, device="cpu", **kw))
    got = serve_in_pairs(DecodeServer(model, device="cpu", spec_tokens=3,
                                      spec_draft=draft, draft_layers=1,
                                      **kw))
    assert got == ref
    assert ref != base(jax_and_port, "port", kv_quant)  # really sampled


@pytest.mark.parametrize("k", [3, 5])
def test_spec_rejection_bookkeeping_exact_positions(jax_and_port, k):
    """After every round each live slot sits exactly at prompt + kept - 1
    with one generated count a kept token, whatever the rejections; each
    request ends with exactly its budget, and at K=5 some drafts miss."""
    _, _, model = jax_and_port
    srv = DecodeServer(model, device="cpu", spec_tokens=k, **SERVE)
    prompts, budgets = mixed_workload()
    reqs = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    while srv.busy:
        if not srv.step():
            break
        for st in srv.slots:
            if st is not None and st.req.tokens:
                assert st.generated == len(st.req.tokens)
                assert st.position == st.req.prompt_len + st.generated - 1
    srv.drain()
    got = [list(r.tokens) for r in reqs]
    assert [len(t) for t in got] == budgets
    assert got == base(jax_and_port, "port", "fp")
    assert srv.mgr.free_pages == srv.mgr.capacity
    if k == 5:
        assert srv.accept_rate < 1.0


def test_spec_eos_honored_inside_accepted_prefix(jax_and_port):
    """An eos id inside an accepted chain ends the request right there,
    as the sequential stream does."""
    _, _, model = jax_and_port
    eos = next(t[1] for t in base(jax_and_port, "port", "fp")
               if len(t) >= 3)
    ref = serve(DecodeServer(model, device="cpu", **SERVE), eos_id=eos)
    got = serve(DecodeServer(model, device="cpu", spec_tokens=3, **SERVE),
                eos_id=eos)
    assert got == ref
    assert any(eos in t for t in got)
    for toks in got:
        if eos in toks:
            assert toks.index(eos) == len(toks) - 1


# ----------------------------------------------------------- span writers

def test_write_span_kv_matches_sequential_writes_and_jax():
    """Without overshoot a span scatter is bitwise the L single-token
    scatters it replaces, and bitwise the JAX ``write_span_kv``."""
    rng = np.random.default_rng(2)
    B, H, L, Dh, ps = 3, 2, 4, 8, 4
    pool = rng.standard_normal((1 + 3 * B, ps, H, Dh)).astype(np.float32)
    table = (1 + np.arange(3 * B).reshape(B, 3)).astype(np.int32)
    kv = rng.standard_normal((B, H, L, Dh)).astype(np.float32)
    start = np.asarray([0, 3, 7], np.int32)
    span = write_span_kv(torch.from_numpy(pool.copy()),
                         torch.from_numpy(table), torch.from_numpy(kv),
                         torch.from_numpy(start))
    seq = torch.from_numpy(pool.copy())
    for j in range(L):
        write_token_kv(seq, torch.from_numpy(table),
                       torch.from_numpy(kv[:, :, j]),
                       torch.from_numpy(start + j))
    assert torch.equal(span, seq)
    ref = jpkv.write_span_kv(jnp.asarray(pool), jnp.asarray(table),
                             jnp.asarray(kv), jnp.asarray(start))
    np.testing.assert_array_equal(span.numpy(), np.asarray(ref))


def test_write_span_kv_overshoot_clamps_not_wraps():
    """Positions past the reservation clamp to its LAST cell, where the
    last link wins; page 2's offset 0 (the wrap target) and every other
    cell keep their bits. Bitwise the JAX writer."""
    rng = np.random.default_rng(3)
    H, Dh, ps = 2, 4, 4
    pool = rng.standard_normal((3, ps, H, Dh)).astype(np.float32)
    table = np.asarray([[1, 2]], np.int32)               # addressable: 8
    kv = rng.standard_normal((1, H, 3, Dh)).astype(np.float32)
    out = write_span_kv(torch.from_numpy(pool.copy()),
                        torch.from_numpy(table), torch.from_numpy(kv),
                        torch.tensor([7], dtype=torch.int32)).numpy()
    ref = pool.copy()
    ref[2, 3] = kv[0, :, 2]          # positions 7, 8, 9 -> cell 7
    np.testing.assert_array_equal(out, ref)
    jout = jpkv.write_span_kv(jnp.asarray(pool), jnp.asarray(table),
                              jnp.asarray(kv), jnp.asarray([7]))
    np.testing.assert_array_equal(out, np.asarray(jout))


def _q8_state(rng, B, H, Dh, ps):
    P = 1 + 2 * B
    pool = torch.zeros((P, ps, H, Dh), dtype=torch.int8)
    scales = torch.zeros((P,), dtype=torch.float32)
    table = torch.from_numpy((1 + np.arange(2 * B).reshape(B, 2))
                             .astype(np.int32))
    warm = torch.from_numpy(rng.standard_normal((B, H, ps, Dh))
                            .astype(np.float32))
    write_prompt_kv_q8(pool, scales, table, warm,
                       torch.ones((B, ps), dtype=torch.int32))
    return pool, scales, table


@pytest.mark.parametrize("starts,amp", [([4, 5], 4.0), ([2, 3], 0.5),
                                        ([6, 7], 3.0)])
def test_write_span_kv_q8_bitwise_jax_bounded_cold_pages(starts, amp):
    """The int8 span writer is bitwise the JAX one (spans inside a page,
    straddling a page edge, and overshooting the table), grows scales
    only, keeps every dequantized link within half its page's scale, and
    leaves pages it does not touch bitwise alone."""
    rng = np.random.default_rng(4)
    B, H, L, Dh, ps = 2, 2, 3, 8, 4
    pool, scales, table = _q8_state(rng, B, H, Dh, ps)
    kv = (amp * rng.standard_normal((B, H, L, Dh))).astype(np.float32)
    start = np.asarray(starts, np.int32)
    jp, js = jpkv.write_span_kv_q8(jnp.asarray(pool.numpy()),
                                   jnp.asarray(scales.numpy()),
                                   jnp.asarray(table.numpy()),
                                   jnp.asarray(kv), jnp.asarray(start))
    old_pool, old_scales = pool.clone(), scales.clone()
    touched = {int(table[b, min(s + j, 2 * ps - 1) // ps])
               for b, s in enumerate(starts) for j in range(L)}
    write_span_kv_q8(pool, scales, table, torch.from_numpy(kv),
                     torch.from_numpy(start))
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    assert torch.all(scales >= old_scales)
    for page in set(range(1, pool.shape[0])) - touched:
        assert torch.equal(pool[page], old_pool[page])
    dense = dequant_gathered(gather_kv(pool, table), scales, table, ps,
                             torch.float32).numpy()
    sc = scales.numpy()[table.numpy()]
    for b in range(B):
        for j in range(L):
            # overshoot clamps to the last cell, where the last link lands
            cell = min(starts[b] + j, 2 * ps - 1)
            err = np.max(np.abs(dense[b, :, cell] - kv[b, :, j]))
            if cell < 2 * ps - 1 or j == L - 1:
                assert err <= sc[b, cell // ps] / 2 + 1e-6


# -------------------------------------------------------- span attention

def _span_case(rng, quantized: bool):
    B, H, L, Dh, ps, n = 3, 2, 4, 16, 4, 4
    P = 1 + n * B
    table = (1 + np.arange(n * B).reshape(B, n)).astype(np.int32)
    q = rng.standard_normal((B, H, L, Dh)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3], [5, 6, 7, 8], [12, 13, 14, 15]],
                     np.int32)
    if quantized:
        k = rng.integers(-127, 128, (P, ps, H, Dh)).astype(np.int8)
        v = rng.integers(-127, 128, (P, ps, H, Dh)).astype(np.int8)
        sk = rng.uniform(0.002, 0.02, (P,)).astype(np.float32)
        sv = rng.uniform(0.002, 0.02, (P,)).astype(np.float32)
        return q, k, v, table, pos, sk, sv
    k = rng.standard_normal((P, ps, H, Dh)).astype(np.float32)
    v = rng.standard_normal((P, ps, H, Dh)).astype(np.float32)
    k[TRASH_PAGE], v[TRASH_PAGE] = 37.0, -53.0
    return q, k, v, table, pos


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_span_decode_links_bitwise_single_token_and_jax(quantized):
    case = _span_case(np.random.default_rng(6), quantized)
    t = [torch.from_numpy(a) for a in case]
    scales = t[5:] or [None, None]
    got = fd.torch_paged_span_decode(*t[:5], *scales)
    for j in range(case[0].shape[2]):
        one = fd.torch_paged_decode(t[0][:, :, j], *t[1:4], t[4][:, j],
                                    *scales)
        assert torch.equal(got[:, :, j], one), j
    ref = jfd.xla_paged_span_decode(*map(jnp.asarray, case[:5]),
                                    *[jnp.asarray(s) if s is not None
                                      else None for s in case[5:]])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_span_seam_dispatch_on_the_cpu():
    """``auto`` and ``torch`` take the plain twin for CPU tensors (no
    kernel launch counted), ``cuda`` raises on them, an unknown arm is
    refused."""
    case = _span_case(np.random.default_rng(7), False)
    t = [torch.from_numpy(a) for a in case]
    fd.reset_launch_count()
    ref = fd.torch_paged_span_decode(*t)
    for impl in ("auto", "torch"):
        assert torch.equal(fd.paged_span_attention(*t, impl=impl), ref)
    assert fd.launch_count() == fd.span_launch_count() == 0
    assert fd.span_kernel_launch_count() == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        fd.paged_span_attention(*t, impl="cuda")
    with pytest.raises(ValueError, match="auto|cuda|torch"):
        fd.paged_span_attention(*t, impl="pallas")


def test_decode_plan_sizes_the_pseudo_slot_grid():
    """The kernel's plan at the serve phase's span: 32 slots x 5 links =
    160 pseudo-slots over 64-page reservations (H=12, Dh=64, page 16, bf16
    and int8 pools, an H100's 132 SMs and 227 KB): one head group, 16-page
    chunks in 4 splits that cover the reservation, two stages in shared
    memory."""
    for kv_bytes in (2, 1):
        plan = fd.decode_plan(160, 12, 64, 16, 64, kv_bytes, 132, 232448)
        assert (plan.group_heads, plan.groups, plan.stages,
                plan.pages_per_chunk, plan.max_splits) == (12, 1, 2, 16, 4)
        assert plan.pages_per_chunk * plan.max_splits >= 64
        assert plan.smem_bytes <= 232448


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_cuda_span_kernel_matches_plain_twin(cuda_device, quantized):
    """The seam's kernel arm for bf16 q (the span kernel, flash_span)
    against the plain twin evaluated in f32 from the same inputs, one
    launch counted on the seam's and the span kernel's counters and none
    on the decode kernel's; within one bf16 rounding of the output and of
    P (8e-3 rel and abs, the decode kernel's bar)."""
    case = list(_span_case(np.random.default_rng(8), quantized))
    for i in range(3):          # q and the pools to Dh 64, a kernel width
        case[i] = np.concatenate([case[i]] * 4, axis=-1)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
         for a in case]
    q = t[0].to(torch.bfloat16)
    pools = t[1:3] if quantized else [x.to(torch.bfloat16) for x in t[1:3]]
    fd.reset_launch_count()
    got = fd.paged_span_attention(q, *pools, t[3], t[4], impl="cuda",
                                  scales_k=(t[5:] or [None])[0],
                                  scales_v=(t[6:] or [None])[0])
    torch.cuda.synchronize()
    assert fd.span_kernel_launch_count() == fd.span_launch_count() == 1
    assert fd.launch_count() == 0
    ref = fd.torch_paged_span_decode(
        q.float(), *[p.float() if p.dtype == torch.bfloat16 else p
                     for p in pools], t[3], t[4], *t[5:])
    torch.testing.assert_close(got.float(), ref, rtol=8e-3, atol=8e-3)


@pytest.mark.cuda
def test_cuda_spec_server_matches_cpu_streams(cuda_device):
    """At f32 compute a greedy spec server on the card (span kernel)
    gives the CPU non-spec streams (seeded port weights: no JAX here, so
    the test runs where the card is)."""
    cfg = {**CFG, "hidden_size": 128}          # Dh 64, a kernel width
    model = create_model_from_config(**cfg, device="cpu")
    model.load_state_dict(init_params(cfg, seed=3))
    gpu = create_model_from_config(**cfg, device=cuda_device)
    gpu.load_state_dict(model.state_dict())
    srv = DecodeServer(gpu, device=cuda_device, spec_tokens=2,
                       **{**SERVE, "page_size": 16})
    fd.reset_launch_count()
    got = serve(srv)
    cpu = serve(DecodeServer(model, device="cpu",
                             **{**SERVE, "page_size": 16}))
    assert got == cpu and fd.span_launch_count() > 0


# ------------------------------------------------------- drafts, settings

@pytest.mark.parametrize("seed", range(6))
def test_ngram_propose_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 5 + 3 * seed, (1 + 7 * seed,)).astype(np.int32)
    for k in (1, 3, 5):
        np.testing.assert_array_equal(ngram_propose(hist, k),
                                      jspec.ngram_propose(hist, k))
    np.testing.assert_array_equal(
        ngram_propose(np.asarray([5, 6, 7, 8, 2, 3, 5, 6], np.int32), 3),
        [7, 8, 2])
    assert DRAFT_KINDS == jspec.DRAFT_KINDS


def test_truncated_draft_shares_the_target_tensors(jax_and_port):
    _, _, model = jax_and_port
    draft = truncated_draft(model, 1)
    own = {id(p) for p in model.parameters()}
    assert draft.num_layers == 1
    assert all(id(p) in own for p in draft.parameters())
    assert len(list(draft.parameters())) < len(list(model.parameters()))
    for bad in (0, 2):
        with pytest.raises(ValueError, match="draft_layers"):
            truncated_draft(model, bad)


def test_spec_settings_parse_and_validate(capsys):
    s = parse_settings(["--checkpoint_path", "x", "--spec_tokens", "4",
                        "--spec_draft", "model", "--draft_layers", "3"])
    assert (s.spec_tokens, s.spec_draft, s.draft_layers) == (4, "model", 3)
    d = parse_settings(["--checkpoint_path", "x"])
    assert (d.spec_tokens, d.spec_draft, d.draft_layers) == (0, "ngram", 2)
    assert "spec_tokens" not in DEFERRED
    for argv in (["--spec_draft", "eagle"], ["--spec_tokens", "-1"]):
        with pytest.raises(SystemExit) as e:
            parse_settings(["--checkpoint_path", "x", *argv])
        assert e.value.code == 2
    with pytest.raises(ValueError, match="spec_draft"):
        DecodeServer(create_model_from_config(**CFG, device="cpu"),
                     device="cpu", spec_tokens=2, spec_draft="eagle")


def test_run_serve_spec_summary(tmp_path, jax_and_port):
    """``run.serve --spec_tokens 2`` on the CPU: the summary carries the
    spec keys, and the tokens are the non-spec run's."""
    _, _, model = jax_and_port
    run = str(tmp_path / "run")
    save_run(run, CFG, model.state_dict(), step=1)
    argv = ["--checkpoint_path", run, "--device", "cpu", "--decode_slots",
            "2", "--page_size", "4", "--max_prompt_len", "8",
            "--synthetic_requests", "3", "--max_new_tokens", "6"]
    outs = []
    for extra in ([], ["--spec_tokens", "2"]):
        out = tmp_path / f"out{len(extra)}.jsonl"
        result = serve_mod.main(argv + extra + ["--out", str(out)])
        outs.append([json.loads(line)["tokens"]
                     for line in out.read_text().splitlines()])
        assert result["decode_tokens"] == 18
    assert outs[0] == outs[1]
    assert result["spec_tokens"] == 2 and result["spec_rounds"] > 0
    assert 0.0 <= result["accept_rate"] <= 1.0
    assert result["accepted_tokens_per_s"] == \
        result["decode_tokens_per_s_per_chip"]
    assert result["span_kernel_launches"] == 0          # plain twin on CPU
