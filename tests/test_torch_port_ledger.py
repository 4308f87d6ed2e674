"""The port's cost ledger (``obs/ledger.py``, ``DecodeServer.cost_ledger``)
against the JAX package's on the CPU: the attribution arithmetic and the
ledger file, the rows' keys and their occupancy and prompt-padding
counters on the same workload, and the census's FLOPs against a count by
hand (JAX's XLA figure is printed beside it, not compared: XLA counts its
own fused program)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.obs import ledger as jax_ledger  # noqa: E402
from distributed_pipeline_tpu.serving import \
    DecodeServer as JaxDecodeServer  # noqa: E402
from distributed_pipeline_tpu_torch.convert import \
    params_from_flax  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.obs import ledger  # noqa: E402
from distributed_pipeline_tpu_torch.serving.scheduler import \
    DecodeServer  # noqa: E402

CFG = dict(model_family="gpt2", vocab_size=64, seq_len=32, hidden_size=32,
           num_layers=2, num_heads=2, dtype="float32")
KW = dict(decode_slots=2, page_size=4, max_prompt_len=12, max_len=32,
          decode_span=2, seed=0)
# the JAX rows' entries that only XLA's extraction has
XLA_ONLY = {"memory", "collectives"}


@pytest.fixture(scope="module")
def jax_and_port():
    wl = jax_create(**CFG)
    params = jax.tree_util.tree_map(
        np.asarray, meta.unbox(wl.init_params(jax.random.PRNGKey(4))))
    model = create_model_from_config(**CFG, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return wl, params, model


def _workload():
    rng = np.random.default_rng(8)
    return [(rng.integers(4, 64, (int(n),)).astype(np.int32), int(b))
            for n, b in ((3, 5), (11, 7), (6, 4), (9, 6), (2, 3))]


def _served(srv):
    for prompt, budget in _workload():
        srv.submit(prompt, max_new_tokens=budget)
    srv.drain()
    return srv


@pytest.mark.parametrize("seed", range(4))
def test_attribution_equals_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(tokens_per_s=float(rng.uniform(1, 5e4)),
              flops_per_token=float(rng.uniform(1e5, 1e9)),
              peak_flops=float(rng.choice([1e11, 989e12])),
              n_devices=int(rng.integers(1, 4)),
              steps_per_s=float(rng.choice([0.0, rng.uniform(1, 200)])),
              collective_bytes_per_step=float(rng.uniform(0, 1e8)),
              bytes_accessed=float(rng.uniform(0, 1e10)),
              host_stall_s_per_step=float(rng.uniform(0, 1e-2)),
              device_kind="cpu",
              padding_waste_frac=float(rng.uniform(-0.1, 1.1)))
    got = ledger.roofline_attribution(**kw)
    assert got == jax_ledger.roofline_attribution(**kw)
    assert abs(ledger.gap_sum_identity(got) - 1.0) <= 1e-12
    assert ledger.gap_sum_identity(got) == jax_ledger.gap_sum_identity(got)
    assert ledger.attribution_columns(got) == \
        jax_ledger.attribution_columns(got)


def test_card_rates_and_ledger_file(tmp_path):
    """The H100 row: memory rate from utils/perf.CARDS, NVLink 900 GB/s;
    the ledger file round-trips and the JAX reader reads it."""
    from distributed_pipeline_tpu_torch.utils.perf import CARDS
    bw = ledger.device_bandwidths("NVIDIA H100 80GB HBM3")
    assert bw == {"hbm_bytes_per_s": CARDS["H100 80GB HBM3"][0],
                  "ici_bytes_per_s": 9.0e11}
    assert ledger.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert ledger.device_bandwidths("cpu") == \
        jax_ledger.device_bandwidths("cpu")
    rows = {"serve_decode": {"program": "serve_decode", "mfu": 0.25}}
    path = ledger.write_ledger(str(tmp_path), rows, t=3.0, extra={"x": 1})
    assert path == jax_ledger.ledger_path(str(tmp_path))
    assert ledger.read_ledger(str(tmp_path)) == \
        jax_ledger.read_ledger(str(tmp_path)) == \
        {"t": 3.0, "programs": rows, "x": 1}
    assert ledger.read_ledger(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("spec", [0, 2], ids=["decode", "spec2"])
def test_rows_keys_and_counters_equal_jax(jax_and_port, spec):
    """Same workload through both servers: the same rows, each with the
    JAX row's keys (less XLA's ``memory``/``collectives``), the same
    occupancy and prompt-padding counters and padding-waste terms, and a
    decode row whose gap terms sum to 1."""
    wl, params, model = jax_and_port
    kw = dict(KW, spec_tokens=spec)
    jsrv = _served(JaxDecodeServer(wl, params, decode_impl="xla", **kw))
    psrv = _served(DecodeServer(model, census=True, device="cpu", **kw))
    for name in ("prompt_tokens_prefilled", "prefill_token_slots",
                 "slot_steps_active", "slot_steps_total", "decode_steps",
                 "prefill_steps", "spec_rounds"):
        assert getattr(psrv, name) == getattr(jsrv, name), name
    jrows = jsrv.cost_ledger(wall_s=2.0)
    prows = psrv.cost_ledger(wall_s=2.0)
    assert set(prows) == set(jrows)
    for name, jrow in jrows.items():
        prow = prows[name]
        assert set(prow) == set(jrow) - XLA_ONLY, name
        assert prow["padding_waste_frac"] == jrow["padding_waste_frac"]
        print(f"{name}: port census {prow['flops_per_execution']:.0f} "
              f"FLOPs, {prow['bytes_accessed']:.0f} B; JAX XLA "
              f"{jrow.get('flops_per_execution', 0.0):.0f} FLOPs, "
              f"{jrow.get('bytes_accessed', 0.0):.0f} B")
    if spec:
        # as in the JAX server: a phase that never ran (here decode) has
        # no row, so the spec run's attribution waits for a decode row
        assert set(prows) == {"serve_prefill", "serve_verify"}
        return
    d = prows["serve_decode"]
    assert d["n_params"] == jrows["serve_decode"]["n_params"]
    assert d["flops_per_token"] == jrows["serve_decode"]["flops_per_token"]
    assert abs(ledger.gap_sum_identity(d) - 1.0) <= 1e-9
    assert 0.0 < d["mfu"] < 1.0


def test_census_flops_equal_a_count_by_hand(jax_and_port):
    """One prefill and one decode dispatch at the test config, counted by
    hand from the model's products: per token 2 x (QKV 3D^2 + out D^2 +
    MLP 8D^2) a layer + 2 x D x V for the head; attention 4 x D a key a
    layer (prefill: the dense [Lp, Lp] square)."""
    _, _, model = jax_and_port
    srv = DecodeServer(model, census=True, device="cpu", **KW)
    prompts = [np.arange(4, 9, dtype=np.int32),
               np.arange(4, 13, dtype=np.int32)]
    for p in prompts:
        srv.submit(p, max_new_tokens=10)
    srv.step()   # one prefill of both, one decode dispatch of span 2
    D, L, V = 32, 2, 64
    per_token = 2 * (3 * D * D + D * D + 8 * D * D) * L + 2 * D * V
    bp, lp = srv.engine.prefill_batch, 12
    prefill = bp * lp * per_token + 4 * D * L * bp * lp * lp
    keys = sum((n + i) + 1 for n in (5, 9) for i in range(2))
    decode = 2 * 2 * per_token + 4 * D * L * keys
    assert srv.census.cost("prefill")["flops_per_execution"] == prefill
    assert srv.census.cost("decode")["flops_per_execution"] == decode
    assert srv.census.cost("verify") == {"flops_per_execution": 0.0,
                                         "bytes_accessed": 0.0}
    # bytes: the f32 weights once a forward, the kernels' own counts
    weights = (12 * D * D * L + D * V) * 4
    assert srv.census.cost("prefill")["bytes_accessed"] == \
        weights + bp * lp * V * 4 + 2 * bp * lp * D * 4 * L
    srv.drain()


def test_cost_ledger_needs_the_census(jax_and_port):
    """The census costs host time a dispatch, so it is armed only for the
    ledger (``census=True``, run.serve's ``--cost_ledger``); a server
    without it refuses ``cost_ledger()`` instead of giving zero bytes."""
    _, _, model = jax_and_port
    srv = _served(DecodeServer(model, device="cpu", **KW))
    assert srv.census is None
    with pytest.raises(RuntimeError, match="census=True"):
        srv.cost_ledger(wall_s=1.0)
