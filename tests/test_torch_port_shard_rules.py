"""The port's mesh layout and partition rules against the JAX package's, on
the CPU (no process group):

* ``resolve_axis_sizes`` over a grid of sizes, its errors included;
* the rank layout: rank r's group along each axis is the JAX mesh's
  devices along it (``make_mesh`` over the 8 host devices
  ``tests/conftest.py`` gives), and ``batch_spec`` is the JAX rule;
* ``match_partition_rules``, ``fix_spec`` and ``zero1_spec`` over the
  flax trees of tiny GPT-2, DiffuSeq and MoE models at the axis sizes
  (dp, fsdp) in {(2, 1), (1, 2), (2, 2), (4, 2)}, leaf for leaf, with the
  three invariants' errors;
* the rules' JSON round trip, ``parse_partition_rules`` and
  ``load_partition_artifact`` over an inline string, ``@file``, a bare
  path and an artifact object, with the same errors;
* ``apply_tuned_layout`` over the JAX test's cases;
* the ``ShardLayout``: the cut leaves are those whose fixed spec names
  fsdp, each fsdp rank's pieces and the replicated leaves rebuild the full
  layout, and ZeRO-1's owned ranges tile the padded buffer.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from flax.core import meta  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.parallel import \
    make_mesh as jax_make_mesh  # noqa: E402
from distributed_pipeline_tpu.parallel import mesh as jax_mesh  # noqa: E402
from distributed_pipeline_tpu.parallel import \
    partition as jpt  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import \
    mesh as pmesh  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import \
    partition as pt  # noqa: E402

MODELS = {
    "gpt2": dict(model_family="gpt2"),
    "diffuseq": dict(model_family="diffuseq"),
    "gpt2-moe": dict(model_family="gpt2", moe_experts=4, moe_every=2),
    "diffuseq-moe": dict(model_family="diffuseq", moe_experts=4,
                         moe_top_k=2),
}
SIZES = [(2, 1), (1, 2), (2, 2), (4, 2)]


def _tiny(**kw):
    return dict(vocab_size=64, seq_len=16, hidden_size=32, num_layers=2,
                num_heads=2, diffusion_steps=50, dtype="float32", **kw)


def _jax_flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {jpt.tree_path_name(p): x for p, x in leaves}


# ----------------------------------------------------------------- mesh

@pytest.mark.parametrize("kw,n", [
    (dict(dp=-1), 8), (dict(dp=2, fsdp=4), 8), (dict(dp=-1, fsdp=2), 8),
    (dict(dp=2, fsdp=-1, sequence=2), 8), (dict(dp=1, fsdp=2), 2),
    (dict(dp=-1, sequence=2, tensor=2), 8), (dict(dp=-1, expert=4), 8),
    (dict(dp=3), 8), (dict(dp=-1, fsdp=3), 8), (dict(dp=-1, fsdp=-1), 8),
    (dict(dp=2, fsdp=2), 8), (dict(dp=1), 2), (dict(dp=-1, pipe=2), 4)])
def test_resolve_axis_sizes_matches_jax(kw, n):
    """The same sizes, or the same error, as the JAX function."""
    try:
        want = jax_mesh.resolve_axis_sizes(n_devices=n, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.resolve_axis_sizes(n_devices=n, **kw)
        assert str(got.value) == str(e)
        return
    assert pmesh.resolve_axis_sizes(n_devices=n, **kw) == want


@pytest.mark.parametrize("kw", [dict(dp=8), dict(dp=2, fsdp=4),
                                dict(dp=4, fsdp=2), dict(dp=2, fsdp=2,
                                                         sequence=2),
                                dict(dp=1, fsdp=2, sequence=4)])
def test_rank_layout_is_the_jax_mesh(kw):
    """Rank r's group along each axis is the JAX mesh's device ids along
    it (row-major), ``rows()`` reads the shard ``batch_spec`` names, and
    ``batch_spec`` is the JAX rule."""
    jm = jax_make_mesh(**kw)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    sizes = tuple(jm.devices.shape)
    assert sizes == pmesh.resolve_axis_sizes(n_devices=8, **kw)
    for r in range(8):
        at = tuple(int(i) for i in np.argwhere(ids == r)[0])
        coords = pmesh.rank_coords(r, sizes)
        assert tuple(coords[a] for a in pmesh.AXES) == at
        for ax_i, axis in enumerate(pmesh.AXES):
            index = list(at)
            index[ax_i] = slice(None)
            assert pmesh.axis_ranks(r, sizes, axis) == tuple(
                int(x) for x in ids[tuple(index)])
        m = pmesh.RankMesh(sizes, r, coords, {})
        rows_index, rows = m.rows()
        assert rows == sizes[0] * sizes[1] * sizes[4]
        # ranks that differ only on the sequence/tensor/pipe axes read the
        # same rows
        twin = [q for q in range(8)
                if all(pmesh.rank_coords(q, sizes)[a] == coords[a]
                       for a in ("data", "fsdp", "expert"))]
        assert all(pmesh.RankMesh(sizes, q, pmesh.rank_coords(q, sizes),
                                  {}).rows()[0] == rows_index for q in twin)
        for seq in (False, True):
            assert pmesh.batch_spec(m, seq) == tuple(
                jax_mesh.batch_spec(jm, seq))


# ------------------------------------------------------- rule matching

@pytest.mark.parametrize("dp,fsdp", SIZES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_partition_rules_match_jax_leaf_for_leaf(name, dp, fsdp):
    """``match_partition_rules`` over the port's parameter names (as JAX
    paths) gives the JAX specs over the flax tree; ``fix_spec`` and
    ``zero1_spec`` at the mesh's sizes give the JAX ones, leaf for leaf;
    the ``ShardLayout`` cuts exactly the leaves whose fixed spec names
    fsdp."""
    cfg = _tiny(**MODELS[name])
    wl = jax_create(**cfg)
    abstract = meta.unbox(jax.eval_shape(wl.init_params,
                                         jax.random.PRNGKey(0)))
    rules = jpt.rules_for_workload(wl)
    want = _jax_flat(jpt.match_partition_rules(rules, abstract))
    shapes = {jpt.tree_path_name(p): tuple(x.shape) for p, x in
              jax.tree_util.tree_flatten_with_path(abstract)[0]}
    model = create_model_from_config(**cfg, device="cpu")
    ours = {pt.param_path(n): tuple(p.shape)
            for n, p in model.named_parameters()}
    assert ours == shapes
    port_rules = pt.rules_for_workload(model)
    assert port_rules == tuple((pat, tuple(s)) for pat, s in rules)
    got = pt.match_partition_rules(port_rules, ours)
    assert set(got) == set(want)
    mesh = jax_make_mesh(dp=dp, fsdp=fsdp,
                         devices=jax.devices()[:dp * fsdp])
    sizes = dict(mesh.shape)
    for path, spec in want.items():
        assert got[path] == tuple(spec), path
        shape = shapes[path]
        assert pt.fix_spec(sizes, got[path], shape) == tuple(
            jpt.fix_spec(mesh, spec, shape)), path
        assert pt.zero1_spec(sizes, got[path], shape) == tuple(
            jpt.zero1_spec(mesh, spec, shape)), path
    layout = pt.ShardLayout([(n, tuple(p.shape))
                             for n, p in model.named_parameters()],
                            sizes=sizes, rules=port_rules)
    cut = {n for n, p in model.named_parameters()
           if "fsdp" in str(jpt.fix_spec(mesh, want[pt.param_path(n)],
                                         tuple(p.shape)))}
    assert set(layout.cut) == cut
    assert bool(cut) == (fsdp > 1)


def test_match_rules_invariants_and_errors_match_jax():
    """Scalars never partition, a shadowed rule loses, and a table
    without a catch-all or with an overlong spec raises the JAX errors."""
    tree = {"params": {"attn": {"qkv": np.zeros((8, 4)),
                                "scale": np.zeros(())},
                       "one": np.zeros((1,))}}
    rules = ((r"attn/qkv$", ("data", None)), (r"attn/", ("fsdp",)),
             (r".*", ()))
    jrules = tuple((pat, P(*spec)) for pat, spec in rules)
    want = _jax_flat(jpt.match_partition_rules(jrules, tree))
    got = pt.match_partition_rules(rules, tree)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["params/attn/scale"] == () and got["params/one"] == ()
    for bad, jbad, leaf in (((r"nomatch", ("data",)),),
                            ((r"nomatch", P("data")),), (4, 4)), \
            (((r".*", ("data", None)),), ((r".*", P("data", None)),),
             (4,)):
        with pytest.raises(ValueError) as e:
            jpt.match_partition_rules(jbad, {"w": np.zeros(leaf)})
        with pytest.raises(ValueError) as g:
            pt.match_partition_rules(bad, {"w": np.zeros(leaf)})
        assert str(g.value).split("—")[0] == str(e.value).split("—")[0]


# -------------------------------------------------------- wire format

RAW = '[["attn/qkv$", ["fsdp", null, ["tensor", "data"]]], [".*", []]]'


@pytest.mark.parametrize("form", ["inline", "at_file", "bare_path",
                                  "artifact", "empty", "bad_pairs",
                                  "bad_object"])
def test_rules_wire_format_matches_jax(tmp_path, form):
    """``parse_partition_rules`` and ``load_partition_artifact`` read the
    same inputs to the same rules (and artifact fields), or raise the same
    errors; ``rules_to_json`` round-trips."""
    f = tmp_path / "rules.json"
    art = {"partition_rules": json.loads(RAW),
           "mesh": {"data": 2, "fsdp": 4}, "shard_optimizer": True}
    text = {"inline": RAW, "empty": "", "bad_pairs": '[["only-a-regex"]]',
            "bad_object": '{"rules": []}'}.get(form)
    if form in ("at_file", "bare_path"):
        f.write_text(RAW)
        text = ("@" if form == "at_file" else "") + str(f)
    elif form == "artifact":
        f.write_text(json.dumps(art))
        text = "@" + str(f)
    for fn in ("parse_partition_rules", "load_partition_artifact"):
        try:
            want = getattr(jpt, fn)(text)
        except ValueError as e:
            with pytest.raises(ValueError) as g:
                getattr(pt, fn)(text)
            assert str(g.value) == str(e)
            continue
        got = getattr(pt, fn)(text)
        if want is None:
            assert got is None
            continue
        if fn == "load_partition_artifact":
            assert (got["mesh"], got["shard_optimizer"]) == (
                want["mesh"], want["shard_optimizer"])
            got, want = got["rules"], want["rules"]
        assert got == tuple((pat, tuple(s)) for pat, s in want)
        assert pt.rules_to_json(got) == jpt.rules_to_json(want)
        assert pt.rules_from_json(pt.rules_to_json(got)) == got


# ----------------------------------------------------- tuned layout

def _jax_apply(kw, art, n):
    from distributed_pipeline_tpu.config.train import \
        TrainSettings as JaxSettings
    from distributed_pipeline_tpu.run.train import apply_tuned_layout
    from distributed_pipeline_tpu.utils import logger
    with logger.scoped_configure(format_strs=[]):
        return apply_tuned_layout(JaxSettings(**kw), art, n_devices=n)


@pytest.mark.parametrize("kw,n", [({}, 8), ({}, 4),
                                  (dict(batch_size=4, microbatch=4), 8),
                                  (dict(dp=8), 8),
                                  (dict(shard_optimizer=True), 8)])
def test_apply_tuned_layout_matches_jax(monkeypatch, kw, n):
    """The JAX test's cases: a default mesh takes the recommendation when
    it fits the device count and the microbatch; ZeRO-1 follows the
    default gate alone; explicit mesh flags win. A tensor recommendation
    is logged and not applied in the port (ROADMAP A.8g)."""
    from distributed_pipeline_tpu_torch.config.train import TrainSettings
    from distributed_pipeline_tpu_torch.run.train import (
        apply_tuned_layout, mesh_flags_default)
    monkeypatch.setenv("WORLD_SIZE", str(n if "dp" not in kw else kw["dp"]))
    art = {"rules": None, "mesh": {"data": 2, "fsdp": 4, "tensor": 1},
           "shard_optimizer": True}
    want = _jax_apply(kw, art, n)
    args = TrainSettings(**kw)
    assert mesh_flags_default(args) == (kw.get("dp", -1) == -1)
    logs = []
    got = apply_tuned_layout(args, art, n_devices=n, log=logs.append)
    assert (got.dp, got.fsdp, got.shard_optimizer) == (
        want.dp, want.fsdp, want.shard_optimizer)
    assert logs
    tensor = {**art, "mesh": {"data": 2, "fsdp": 2, "tensor": 2}}
    logs = []
    kept = apply_tuned_layout(TrainSettings(), tensor, n_devices=8,
                              log=logs.append)
    assert (kept.dp, kept.fsdp) == (-1, 1) and kept.shard_optimizer
    assert any("ROADMAP A.8g" in line for line in logs)


# ----------------------------------------------------------- the layout

@pytest.mark.parametrize("dp,fsdp,zero1", [(1, 2, False), (2, 2, True),
                                           (4, 1, True), (2, 4, False),
                                           (3, 2, True)])
@pytest.mark.parametrize("name", ["gpt2", "diffuseq-moe"])
def test_shard_layout_cuts_and_rebuilds_the_full_layout(name, dp, fsdp,
                                                        zero1):
    """Every fsdp rank's buffer (``local_from_full``) holds its pieces and
    the replicated leaves; gathering them (``gather_full`` over a
    simulated group) rebuilds the full layout bitwise; the owned ranges of
    the data ranks tile the padded buffer; ``name_at_local`` names each
    element's leaf."""
    model = create_model_from_config(**_tiny(**MODELS[name]), device="cpu")
    leaves = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    rules = pt.rules_for_workload(model)
    sizes = {"data": dp, "fsdp": fsdp}
    gen = torch.Generator().manual_seed(0)
    state = {n: torch.randn(s, generator=gen) for n, s in leaves}
    layouts = [[pt.ShardLayout(leaves, sizes=sizes, rules=rules,
                               fsdp_index=f, data_index=d,
                               shard_optimizer=zero1) for d in range(dp)]
               for f in range(fsdp)]
    first = layouts[0][0]
    assert first.zero1 == (zero1 and dp > 1)
    assert first.m_pad % (dp if first.zero1 else 1) == 0
    locals_ = []
    for f in range(fsdp):
        buf = torch.zeros(first.m_pad)
        layouts[f][0].local_from_full(state, buf)
        locals_.append(buf)
        owned = sorted((L.lo, L.hi) for L in layouts[f])
        if first.zero1:
            assert owned[0][0] == 0 and owned[-1][1] == first.m_pad
            assert all(a[1] == b[0] for a, b in zip(owned, owned[1:]))
        else:  # every data rank updates all of its buffer
            assert set(owned) == {(0, first.m)}
        for i in range(0, first.m, 97):
            got = layouts[f][0].name_at_local(i)
            assert got in state
    assert sum(u.piece for u in first.units) * fsdp == sum(
        u.size for u in first.units)

    def fake_gather(out, inp, group):
        del group
        u = next(u for u in first.units
                 if u.piece == inp.numel()
                 and inp.data_ptr() == locals_[0][u.local_off:].data_ptr())
        out.copy_(torch.cat([b[u.local_off:u.local_off + u.piece]
                             for b in locals_]))

    full = first.gather_full(locals_[0], torch.empty(first.n),
                             all_gather=fake_gather)
    want = torch.cat([state[n].reshape(-1) for n, _ in leaves])
    assert torch.equal(full, want)
