"""The port's disaggregated prefill/decode serving on the CPU: the page
transfer (``DecodeEngine.extract_pages`` rows against the JAX engine's,
``ingest_pages`` + ``DecodeServer.submit_prefilled`` against the colocated
server), ``serve_disagg_inprocess`` token-identical to the port's
colocated server and held against the JAX dense greedy decoder (each
token the JAX dense forward's argmax after the same prefix, or within
1e-4 of its max: the near-tie rule of the port's other decode tests), the
StageLink frames (the port's link reads
frames the JAX link wrote), and ``run.serve --replicas 1 --disagg 1
--device cpu`` against the colocated streams. The ``cuda`` case
(``ingest_pages`` into a graph-captured pool) runs on the card through
``scripts/run_torch_cuda_tests.py -k disagg``."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.mpmd import link as jax_link  # noqa: E402
from distributed_pipeline_tpu.serving.engine import \
    DecodeEngine as JaxDecodeEngine  # noqa: E402
from distributed_pipeline_tpu_torch.convert import \
    params_from_flax  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.mpmd import link  # noqa: E402
from distributed_pipeline_tpu_torch.mpmd.disagg import (  # noqa: E402
    PrefillClient, pack_kv_frame, serve_disagg_inprocess, unpack_kv_frame)
from distributed_pipeline_tpu_torch.run import serve as serve_mod  # noqa
from distributed_pipeline_tpu_torch.serving.scheduler import \
    DecodeServer  # noqa: E402
from distributed_pipeline_tpu_torch.utils.checkpoint import \
    save_run  # noqa: E402

CFG = dict(model_family="gpt2", vocab_size=128, seq_len=64, hidden_size=64,
           num_layers=2, num_heads=2, dtype="float32")
KW = dict(page_size=8, max_prompt_len=32, max_len=64)


@pytest.fixture(scope="module")
def models():
    wl = jax_create(**CFG)
    params = jax.tree_util.tree_map(
        np.asarray, meta.unbox(wl.init_params(jax.random.PRNGKey(6))))
    model = create_model_from_config(**CFG, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return wl, params, model


def _pairs(n=6):
    rng = np.random.default_rng(11)
    return [(rng.integers(4, 128, (int(k),)).astype(np.int32), int(m))
            for k, m in zip((3, 17, 1, 9, 30, 6)[:n], (5, 3, 8, 2, 6, 4))]


def _colocated(model, pairs, slots=2):
    srv = DecodeServer(model, decode_slots=slots, device="cpu", **KW)
    reqs = [srv.submit(p, m) for p, m in pairs]
    srv.drain()
    return [list(r.tokens) for r in reqs]


def test_extract_pages_rows_match_jax(models):
    """One prompt prefilled on a 1-slot engine each side: the extracted
    rows carry the JAX engine's leaf keys, shapes and dtypes; layer 0's
    rows (one projection of the embeddings) match the JAX rows within
    atol 1e-6, layer 1's (after a block of f32 matmuls whose summation
    order differs between XLA and PyTorch: up to ~8 ulps at |x| ~ 3)
    within rtol 2e-5 + atol 1e-6, the decode tests' f32 bar; and rows
    the JAX engine extracts, ingested by the port's engine, extract
    bitwise unchanged."""
    wl, params, model = models
    prompt = _pairs()[1][0]                          # 17 tokens, 3 pages
    n_pages = -(-KW["max_prompt_len"] // KW["page_size"]) + 1
    jeng = JaxDecodeEngine(wl, params, decode_slots=1, max_pages=n_pages,
                           prefill_batch=1, **KW)
    pre = PrefillClient(model, **KW)
    pages = np.asarray([1, 2, 3], np.int32)
    ids = np.zeros((1, KW["max_prompt_len"]), np.int32)
    ids[0, :len(prompt)] = prompt
    table = np.zeros((1, jeng.pages_per_slot), np.int32)
    table[0, :3] = pages
    args = (ids, np.asarray([len(prompt)], np.int32),
            np.asarray([0], np.int32), table)
    jeng.prefill(*args)
    pre.engine.prefill(*args)
    want = jeng.extract_pages(pages)
    got = pre.engine.extract_pages(pages)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape
        assert got[key].dtype == want[key].dtype
        rtol = 0.0 if "block_0" in key else 2e-5
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=1e-6)
    other = np.asarray([3, 1, 2], np.int32)
    pre.engine.ingest_pages(other, want)
    back = pre.engine.extract_pages(other)
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_ingest_then_submit_prefilled_continues_colocated(models):
    """A prompt prefilled by a PrefillClient, packed and unpacked in the
    wire format, ingested into a decode server with another request
    already in flight, continues exactly as the colocated server does;
    a payload whose keys or row shapes differ is refused with nothing
    written, and a full server returns None (backpressure)."""
    _, _, model = models
    pairs = _pairs()
    ref = _colocated(model, pairs[:2])
    srv = DecodeServer(model, decode_slots=2, device="cpu", **KW)
    first = srv.submit(*pairs[0])
    srv.step()
    pre = PrefillClient(model, **KW)
    out = pre.prefill(pairs[1][0])
    frame = unpack_kv_frame(*pack_kv_frame(7, pairs[1][0], pairs[1][1],
                                           out, src=0))
    assert frame["id"] == 7 and frame["first_token"] == ref[1][0]
    bad = dict(frame["kv"])
    key = sorted(bad)[0]
    bad[key] = bad[key][:, :-1]
    pools = [t.clone() for entry in srv.engine.kv_cache for t in entry]
    with pytest.raises(ValueError, match="do not fit"):
        srv.submit_prefilled(frame["prompt"], frame["max_new_tokens"],
                             first_token=frame["first_token"], kv_pages=bad)
    with pytest.raises(ValueError, match="pool-leaf mismatch"):
        srv.engine.ingest_pages(np.asarray([1, 2, 3]),
                                {"x": frame["kv"][key]})
    assert all(torch.equal(a, b) for a, b in zip(
        pools, [t for entry in srv.engine.kv_cache for t in entry]))
    req = srv.submit_prefilled(frame["prompt"], frame["max_new_tokens"],
                               first_token=frame["first_token"],
                               kv_pages=frame["kv"])
    assert srv.submit_prefilled(frame["prompt"], 2,
                                first_token=frame["first_token"],
                                kv_pages=frame["kv"]) is None  # no slot
    srv.drain()
    assert [first.tokens, req.tokens] == ref
    assert srv.mgr.free_pages == srv.mgr.capacity


def _jax_dense_picks(wl, params, pairs, streams):
    """Per request, the JAX dense forward over its prompt and ``streams``'
    tokens (one causal forward): at each generated position, the argmax
    and the top logit's lead over the stream's token."""
    fwd = jax.jit(lambda p, x: wl.model.apply(p, x, jnp.ones_like(x)))
    out = []
    for (prompt, _), toks in zip(pairs, streams):
        row = np.zeros((1, CFG["seq_len"]), np.int32)
        seq = list(map(int, prompt)) + list(toks)
        row[0, :len(seq)] = seq
        logits = np.asarray(fwd(params, jnp.asarray(row)))[0].astype(
            np.float64)
        at = range(len(prompt) - 1, len(seq) - 1)
        out.append([(int(np.argmax(logits[i])),
                     float(logits[i].max() - logits[i][seq[i + 1]]))
                    for i in at])
    return out


@pytest.mark.parametrize("slots", [2, 1])
def test_serve_disagg_inprocess_matches_jax_and_colocated(models, slots,
                                                         tmp_path):
    """Both roles in one process over a MemStageLink: token-identical to
    the port's colocated server, including under admission backpressure
    (one slot for six requests), and every token the JAX dense greedy
    decoder's pick after the same prefix (or a near-tie: the JAX top
    logit within 1e-4 of the token's). The JAX serving loop is not the
    reference here: under a loaded test run it moved by a 0.0118 top-2
    gap where the port did not (ROADMAP C.10)."""
    wl, params, model = models
    pairs = _pairs()
    got = serve_disagg_inprocess(model, pairs, decode_slots=slots,
                                 device="cpu", **KW)
    port = [list(map(int, g["tokens"])) for g in got]
    picks = _jax_dense_picks(wl, params, pairs, port)
    streams = {"port_disagg": port,
               "jax_dense_picks": [[a for a, _ in p] for p in picks],
               "port_colocated": _colocated(model, pairs)}
    if len(set(map(json.dumps, streams.values()))) > 1:
        # the three stream sets, for telling which side moved
        dump = tmp_path / f"disagg_streams_slots{slots}.json"
        dump.write_text(json.dumps(streams))
        print(f"stream sets differ; written to {dump}: "
              f"{json.dumps(streams)}")
    assert [g["id"] for g in got] == list(range(len(pairs)))
    assert streams["port_disagg"] == streams["port_colocated"]
    for rid, (toks, p) in enumerate(zip(port, picks)):
        assert len(toks) == pairs[rid][1]
        for j, (tok, (best, lead)) in enumerate(zip(toks, p)):
            assert tok == best or lead < 1e-4, (
                f"request {rid} token {j}: {tok}, the JAX dense pick is "
                f"{best} by {lead}")
    assert [g["prompt_len"] for g in got] == [len(p) for p, _ in pairs]


def test_file_stage_link_frames_round_trip(tmp_path):
    """A KV frame (f32 and int16 rows, int32 prompt, metadata) written by
    the port's FileStageLink — and one written by the JAX package's —
    comes back from the port's link with its dtypes, shapes, values and
    metadata, in order; a send past capacity blocks, then times out (or
    returns False when interrupted)."""
    rng = np.random.default_rng(0)
    arrays = {"prompt": np.arange(5, dtype=np.int32),
              "kv:a": rng.standard_normal((3, 8, 2, 16)).astype(np.float32),
              "kv:b": rng.integers(-2 ** 15, 2 ** 15, (3, 4),
                                   dtype=np.int16)}
    for tx_mod in (link, jax_link):
        path = str(tmp_path / tx_mod.__name__)
        tx = tx_mod.FileStageLink(path, capacity=2)
        rx = link.FileStageLink(path, capacity=2)
        assert tx.send(arrays, {"op": "kv", "id": 1})
        assert tx.send(arrays, {"op": "kv", "id": 2})
        with pytest.raises(TimeoutError, match="capacity 2"):
            tx.send(arrays, {"op": "kv", "id": 3}, timeout_s=0.05)
        assert not tx.send(arrays, {"op": "kv", "id": 3},
                           interrupt=lambda: True)
        for want_id in (1, 2):
            out, meta_ = rx.recv(timeout_s=5.0)
            assert meta_["id"] == want_id and meta_["op"] == "kv"
            for k, v in arrays.items():
                assert out[k].dtype == v.dtype
                np.testing.assert_array_equal(out[k], v)
        assert rx.recv(timeout_s=0.0) is None and rx.pending() == 0
    flat = link.flatten_tree({"a": {"b": np.arange(3)}, "c": np.ones(2)})
    assert set(flat) == {"a/b", "c"}
    np.testing.assert_array_equal(link.unflatten_tree(flat)["a"]["b"],
                                  np.arange(3))


def test_run_serve_disagg_equals_colocated(models, tmp_path):
    """``run.serve --replicas 1 --disagg 1 --device cpu``: one prefill
    worker and one decode worker (each a supervised process) serve every
    request, and the streams equal the colocated single-replica run's;
    the decode worker's sidecar books its admissions. The JAX package's
    refusals of ``--disagg`` combinations hold."""
    _, _, model = models
    run = str(tmp_path / "run")
    save_run(run, CFG, model.state_dict(), 1)
    base = ["--checkpoint_path", run, "--device", "cpu", "--decode_slots",
            "2", "--page_size", "8", "--max_prompt_len", "32",
            "--max_new_tokens", "6", "--synthetic_requests", "6",
            "--traffic", "poisson", "--rate_rps", "200"]
    single = str(tmp_path / "single.jsonl")
    serve_mod.main(base + ["--out", single])
    out = str(tmp_path / "disagg.jsonl")
    fleet_dir = str(tmp_path / "fleet")
    summary = serve_mod.main(base + [
        "--replicas", "1", "--disagg", "1", "--fleet_dir", fleet_dir,
        "--out", out, "--fleet_deadline_s", "60"])
    assert summary["completed"] == 6 and summary["dropped"] == 0
    assert summary["replica_rcs"] == [0] and summary["decode_rcs"] == [0]
    with open(single) as f:
        want = [json.loads(line) for line in f]
    with open(out) as f:
        got = [json.loads(line) for line in f]
    assert [g["prompt"] for g in got] == [w["prompt"] for w in want]
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    dec = os.path.join(fleet_dir, "decode", "replica_0")
    with open(os.path.join(dec, "serving_attempt000.json")) as f:
        car = json.load(f)
    assert car["admitted"] == 6 and car["completed"] == 6
    for extra, msg in ((["--disagg", "2"], "exactly one"),
                       (["--disagg", "1", "--autoscale", "true"],
                        "autoscale"),
                       (["--disagg", "1", "--serve_transport", "socket"],
                        "socket"),
                       (["--disagg", "1", "--swap_after_requests", "3"],
                        "mutually exclusive")):
        with pytest.raises(SystemExit, match=msg):
            serve_mod.main(base + ["--replicas", "1", "--fleet_dir",
                                   str(tmp_path / "refused")] + extra)


@pytest.mark.cuda
def test_ingest_pages_into_graph_captured_pool_on_card():
    """On the card: a decode server whose decode phase is already a
    captured CUDA graph admits transferred requests (``ingest_pages``
    writes the captured pool tensors in place) and its streams equal the
    colocated graph server's, with the decode kernel launched and the
    plain version never called."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the graph engine captures CUDA graphs")
    from distributed_pipeline_tpu_torch.convert import init_params
    from distributed_pipeline_tpu_torch.ops import flash_decode as fd
    cfg = dict(CFG, vocab_size=256, seq_len=128, hidden_size=128,
               dtype="bfloat16")
    model = create_model_from_config(**cfg, device="cuda")
    model.load_state_dict(init_params(cfg, seed=4))
    kw = dict(page_size=16, max_prompt_len=64, max_len=128)
    rng = np.random.default_rng(4)
    pairs = [(rng.integers(4, 256, (int(k),)).astype(np.int32), 12)
             for k in (40, 7, 63, 20, 33, 12)]
    srv = DecodeServer(model, decode_slots=4, decode_span=3, device="cuda",
                       **kw)
    reqs = [srv.submit(p, m) for p, m in pairs]
    srv.drain()
    ref = [r.tokens for r in reqs]
    ptrs = [t.data_ptr() for entry in srv.engine.kv_cache for t in entry]
    assert "decode" in srv.engine.executables()
    fd.reset_launch_count()
    got = serve_disagg_inprocess(model, pairs, server=srv, **kw)
    assert [g["tokens"] for g in got] == ref
    assert fd.launch_count() > 0 and fd.plain_call_count() == 0
    assert ptrs == [t.data_ptr() for entry in srv.engine.kv_cache
                    for t in entry]
    assert all(n == 1 for n in srv.engine.captures.values())
