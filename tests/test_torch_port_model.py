"""The port's GPT-2 model against the JAX package's, on the CPU.

Same weights (the flax tree through ``convert.params_from_flax``), same
numpy inputs, both sides' outputs compared as numpy arrays: the weight
bridge round trip, the full causal forward, the paged serving path (prefill
then single-token decode steps, JAX with ``decode_impl="xla"``) and bf16.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    init_params, params_from_flax, params_to_flax)
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402

V, L, D, H, LAYERS, PS = 64, 32, 32, 2, 2, 4


def _cfg(dtype="float32"):
    return dict(model_family="gpt2", vocab_size=V, seq_len=L, hidden_size=D,
                num_layers=LAYERS, num_heads=H, dtype=dtype)


def _pair(dtype="float32", seed=0):
    """(JAX workload, numpy flax params, port model with the same weights)."""
    wl = jax_create(**_cfg(dtype))
    params = jax.tree_util.tree_map(
        np.asarray, meta.unbox(wl.init_params(jax.random.PRNGKey(seed))))
    model = create_model_from_config(**_cfg(dtype), device="cpu")
    model.load_state_dict(params_from_flax(params))
    return wl, params, model.eval()


def _ids(seed=0, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (b, L)).astype(np.int32)
    pad = np.ones((b, L), np.int32)
    pad[1, 20:] = 0
    return ids, pad


def test_params_flax_round_trip_is_exact():
    _, params, model = _pair()
    back = params_to_flax(params_from_flax(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the port's own parameter names are the flax paths, one for one
    assert set(model.state_dict()) == set(params_from_flax(params))


def test_init_params_matches_flax_shapes_and_scales():
    """numpy init_params: every flax leaf, same shape, the initializers'
    standard deviations (0.02 embeddings, fan_in**-0.5 kernels)."""
    _, params, _ = _pair()
    ours = init_params(dict(vocab_size=V, seq_len=L, hidden_size=D,
                            num_layers=LAYERS, num_heads=H), seed=1)
    ref = params_from_flax(params)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    big = init_params(dict(vocab_size=512, seq_len=256, hidden_size=256,
                           num_layers=1, num_heads=4), seed=2)
    assert abs(float(big["word_emb.embedding"].std()) - 0.02) < 1e-3
    assert abs(float(big["backbone.block_0.mlp.wo"].std())
               - 1024 ** -0.5) < 1e-3
    assert torch.equal(big["backbone.ln_f.scale"], torch.ones(256))


def test_full_forward_logits_match_f32():
    wl, params, model = _pair()
    ids, pad = _ids()
    ref = np.asarray(wl.model.apply(params, ids, pad))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_full_forward_logits_match_bf16():
    """bf16 compute over f32 params on both sides: the two frameworks round
    at different places, so logits (|logit| < 0.5 here) agree within a few
    bf16 ulps (ulp 2**-9 at 0.25..0.5): atol 8e-3."""
    wl, params, model = _pair("bfloat16")
    ids, pad = _ids(1)
    ref = np.asarray(wl.model.apply(params, ids, pad).astype(jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(ids),
                    torch.from_numpy(pad)).float().numpy()
    assert np.abs(ref).max() < 0.5
    np.testing.assert_allclose(got, ref, rtol=0, atol=8e-3)


def test_paged_prefill_and_decode_match_jax_xla_arm():
    """Paged prefill (pool writes + dense causal attention) then 4
    single-token decode steps through the decode seam, slots at different
    depths, against the JAX paged path with decode_impl="xla"."""
    wl, params, model = _pair()
    B, Lp, n = 3, 12, L // PS
    P = 1 + B * n
    rng = np.random.default_rng(3)
    ids = rng.integers(0, V, (B, Lp)).astype(np.int32)
    lens = np.asarray([12, 5, 9], np.int32)
    pad = (np.arange(Lp)[None] < lens[:, None]).astype(np.int32)
    bt = (1 + np.arange(B * n)).reshape(B, n).astype(np.int32)
    dm = wl.model.clone(decode=True, paged_pages=P, page_size=PS,
                        decode_impl="xla")
    ref, mv = dm.apply(params, ids, pad, block_table=bt, mutable=["cache"])
    cache = mv["cache"]
    dh = D // H
    kv = [(torch.zeros(P, PS, H, dh), torch.zeros(P, PS, H, dh))
          for _ in range(LAYERS)]
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(pad),
                    block_table=torch.from_numpy(bt), kv_cache=kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    ref_last = np.asarray(ref)[np.arange(B), lens - 1]
    tok = ref_last.argmax(-1).astype(np.int32)
    pos = lens.copy()
    for _ in range(4):
        ref, mv = dm.apply({**params, "cache": cache}, tok[:, None], None,
                           cache_index=pos, block_table=bt,
                           mutable=["cache"])
        cache = mv["cache"]
        with torch.no_grad():
            got = model(torch.from_numpy(tok[:, None]), None,
                        cache_index=torch.from_numpy(pos),
                        block_table=torch.from_numpy(bt), kv_cache=kv,
                        decode_impl="torch")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        tok = np.asarray(ref)[:, 0].argmax(-1).astype(np.int32)
        pos = pos + 1
    # the pools hold the same K/V as the JAX cache
    jk = np.asarray(cache["backbone"]["block_1"]["attn"]["pages_k"])
    np.testing.assert_allclose(kv[1][0][1:].numpy(), jk[1:], rtol=1e-5,
                               atol=1e-6)


def test_create_model_from_config_families():
    with pytest.raises(NotImplementedError, match="A.7"):
        create_model_from_config(model_family="diffuseq", device="cpu")
    with pytest.raises(ValueError, match="unknown model family"):
        create_model_from_config(model_family="bert", device="cpu")
    m = create_model_from_config(model_family="gpt2", model_size="medium",
                                 vocab_size=16, seq_len=8, num_layers=1,
                                 device="meta")
    assert (m.hidden_size, m.num_layers, m.num_heads) == (1024, 1, 16)
