"""Regex-rule partition engine and the sharded-state layout: the port of
``distributed_pipeline_tpu/parallel/partition.py``.

A model family ships a rule table: ordered ``(regex, spec)`` pairs matched
against each parameter's path (the first match wins). A spec is a tuple of
entries, one a dimension: ``None`` (replicated), an axis name, or a tuple
of axis names; the JAX package's ``PartitionSpec`` with the same entries.
The port names a parameter by its flax path with dots (``convert.py``), so
its JAX path is :func:`param_path`: ``"params/" + name.replace(".", "/")``.

The pure functions are the JAX ones, over a dict of axis sizes where the
JAX functions read ``mesh.shape``:

* :func:`match_partition_rules` keeps three invariants: scalars (ndim 0
  or one element) never partition, every leaf must match a rule (tables
  end with the catch-all ``(r".*", ())``), and a spec longer than its
  leaf's rank raises;
* :func:`fix_spec` pads a spec to the leaf's rank and drops the axes whose
  size a dimension does not divide; :func:`zero1_spec` adds the data axis
  for the weight-update state (ZeRO-1);
* ``MOE_RULES``, ``DIFFUSEQ_RULES`` and ``GPT2_RULES`` verbatim;
  :func:`rules_for_workload`, the JSON wire format
  (:func:`rules_from_json` / :func:`rules_to_json`),
  :func:`parse_partition_rules` and :func:`load_partition_artifact` (the
  tuner artifact's rules, mesh and ``shard_optimizer``).

``resolve_shardings`` and ``make_shard_and_gather_fns`` become
:class:`ShardLayout`: which leaf the rule table cuts over ``fsdp`` (after
``fix_spec`` at the run's sizes), where each leaf lives in this rank's flat
buffer, the contiguous range of it this rank updates under ZeRO-1, and the
cut (:meth:`ShardLayout.local_from_full`) and gather
(:meth:`ShardLayout.gather_full`) between that buffer and the full flat
layout. How a leaf is cut is the port's own (ROADMAP C.17): the cut leaves
of one unit (a block, or the rest of the model) are concatenated in
parameter order and the concatenation is cut into ``fsdp`` contiguous
ranges, where the JAX layout cuts each leaf along one dimension. A unit
gathered is then one contiguous buffer that every cut leaf is a view of.

Under a pipe axis S > 1 the stacked rules (``pipe`` on dim 0 of every
``blocks/...`` weight) give a rank its stage: those leaves hold only the
rows of the layers the rank owns (``models/pipeline.stage_layers``: a
contiguous L/S, or under the interleaved schedule the V slices of
virtual stages ``j*S + s``), first in its flat buffer, so the stage slice
is one contiguous range; the rest stays whole. With ``fsdp`` F > 1 too,
the stage's leaves the rules cut over fsdp (the embed dims: ``qkv``,
``out``, ``wi``, ``wo``) form the **stage unit** (:class:`StageUnit`):
each stage row's cut weights, concatenated, padded to a multiple of F and
cut into F contiguous pieces, so a row gathered is one all-gather (the
JAX per-layer gather under remat) and the whole stage is one all-gather
of the rank's row pieces; the stage's other leaves (the LayerNorms) stay
whole rows. ``gather_full`` gathers the stage unit over the fsdp group,
all-gathers the stage slices over the pipe group and puts each rank's
rows back at their layers (the interleaved order undone).
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

__all__ = [
    "Rules", "Spec", "param_path", "tree_path_name", "flatten_tree",
    "match_partition_rules", "fix_spec", "zero1_spec", "spec_axes",
    "parse_partition_rules", "rules_from_json", "rules_to_json",
    "load_partition_artifact", "rules_for_workload", "MOE_RULES",
    "DIFFUSEQ_RULES", "GPT2_RULES", "Unit", "StageUnit", "ShardLayout",
    "unit_of",
]

# a spec: one entry a dimension (None, an axis name, or a tuple of names)
Spec = Tuple[Any, ...]
# an ordered rule table: the first regex (re.search) matching a leaf's
# '/'-joined path wins
Rules = Tuple[Tuple[str, Spec], ...]


def param_path(name: str) -> str:
    """A port parameter name -> its JAX tree path:
    ``backbone.block_0.attn.qkv`` -> ``params/backbone/block_0/attn/qkv``."""
    return "params/" + name.replace(".", "/")


def tree_path_name(path: Sequence[Any]) -> str:
    """A key path -> '/'-joined name (JAX key objects name their part by
    ``key``, ``idx`` or ``name``; plain keys by ``str``)."""
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


def flatten_tree(tree: Mapping[str, Any], prefix: Tuple[Any, ...] = ()
                 ) -> Dict[str, Any]:
    """Nested mappings -> ``{'/'-joined path: leaf}`` in insertion order
    (a flat mapping comes back as it is)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[tree_path_name(prefix + (k,))] = v
    return out


def _shape_of(leaf: Any) -> Tuple[int, ...]:
    if isinstance(leaf, (tuple, list)):
        return tuple(int(d) for d in leaf)
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def match_partition_rules(rules: Sequence[Tuple[str, Spec]],
                          tree: Mapping[str, Any]) -> Dict[str, Spec]:
    """``{path: spec}`` for ``tree`` (nested mappings, or a flat mapping of
    paths, whose leaves carry a ``.shape`` or are shape tuples) according
    to ``rules``.

    Scalar leaves (ndim 0 or one element) are never partitioned. Every
    other leaf must match some rule: a table without an explicit catch-all
    ``(r".*", ())`` raises on the first uncovered path instead of
    silently replicating it."""
    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def spec_for(name: str, leaf: Any) -> Spec:
        shape = _shape_of(leaf)
        if len(shape) == 0 or math.prod(shape) == 1:
            return ()  # scalars never partition
        for pat, spec in compiled:
            if pat.search(name):
                if len(spec) > len(shape):
                    raise ValueError(
                        f"partition rule {pat.pattern!r} has "
                        f"{len(spec)} entries but {name!r} has rank "
                        f"{len(shape)} (shape {shape})")
                return spec
        raise ValueError(
            f"no partition rule matched {name!r} — rule tables must end "
            f"with an explicit catch-all (r'.*', ()) so replication is "
            f"declared, not accidental")

    return {name: spec_for(name, leaf)
            for name, leaf in flatten_tree(tree).items()}


def spec_axes(entry: Any) -> Tuple[str, ...]:
    """A spec entry's axis names (``()`` for None)."""
    if isinstance(entry, tuple):
        return entry
    return (entry,) if entry else ()


def _axes_size(sizes: Mapping[str, int], entry: Any) -> int:
    return math.prod(int(sizes[a]) for a in spec_axes(entry))


def fix_spec(sizes: Mapping[str, int], spec: Spec, shape: Sequence[int]
             ) -> Spec:
    """Pad the spec to the leaf's rank and drop the entries whose axes'
    size does not divide their dimension, or is 1 (replicated instead)."""
    shape = tuple(shape)
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(ax if _axes_size(sizes, ax) > 1
                 and dim % _axes_size(sizes, ax) == 0 else None
                 for dim, ax in zip(shape, entries))


def zero1_spec(sizes: Mapping[str, int], spec: Spec, shape: Sequence[int],
               axis: str = "data") -> Spec:
    """Extend a (materialized) param spec so the leaf is additionally
    sharded across ``axis``: the ZeRO-1 layout for weight-update state.

    Placement: the first dim the axis divides, an unsharded dim first,
    else an already-sharded dim whose per-shard size still divides.
    Leaves nothing divides stay as they are."""
    shape = tuple(shape)
    dp = int(sizes[axis])
    fixed = fix_spec(sizes, spec, shape)
    if dp <= 1 or not shape:
        return fixed
    used = {a for e in fixed for a in spec_axes(e)}
    if axis in used:
        # the param layout already uses the axis
        return fixed
    entries = list(fixed)
    for d, ax in enumerate(entries):
        if ax is None and shape[d] % dp == 0:
            entries[d] = axis
            return tuple(entries)
    for d, ax in enumerate(entries):
        if ax is None:
            continue
        if shape[d] % (_axes_size(sizes, ax) * dp) == 0:
            entries[d] = spec_axes(ax) + (axis,)
            return tuple(entries)
    return tuple(entries)


# ------------------------------------------------------- per-model tables
#
# The JAX package's tables (its layout legend: fsdp = ZeRO-3-style
# parameter sharding, tensor = Megatron pairing, expert = the MoE
# expert-weight leading dim, pipe = stacked layers under scan_layers).

MOE_RULES: Rules = (
    (r"moe/router$", ("fsdp", None)),
    (r"moe/wi$", ("expert", "fsdp", "tensor")),
    (r"moe/wo$", ("expert", "tensor", "fsdp")),
    (r"blocks/moe_router$", ("pipe", "fsdp", None)),
    (r"blocks/moe_wi$", ("pipe", "expert", "fsdp", "tensor")),
    (r"blocks/moe_wo$", ("pipe", "expert", "tensor", "fsdp")),
)

_BACKBONE_RULES: Rules = (
    (r"attn/qkv$", ("fsdp", None, "tensor", None)),
    (r"attn/out$", ("tensor", None, "fsdp")),
    (r"mlp/wi$", ("fsdp", "tensor")),
    (r"mlp/wo$", ("tensor", "fsdp")),
    (r"blocks/dense_qkv$", ("pipe", None, "fsdp", None, "tensor", None)),
    (r"blocks/dense_out$", ("pipe", None, "tensor", None, "fsdp")),
    (r"blocks/dense_wi$", ("pipe", None, "fsdp", "tensor")),
    (r"blocks/dense_wo$", ("pipe", None, "tensor", "fsdp")),
    (r"blocks/dense_ln\d_(scale|bias)$", ("pipe", None, None)),
    (r"blocks/(moe_)?qkv$", ("pipe", "fsdp", None, "tensor", None)),
    (r"blocks/(moe_)?out$", ("pipe", "tensor", None, "fsdp")),
    (r"blocks/(moe_)?wi$", ("pipe", "fsdp", "tensor")),
    (r"blocks/(moe_)?wo$", ("pipe", "tensor", "fsdp")),
    (r"blocks/(moe_)?ln\d_(scale|bias)$", ("pipe", None)),
)

# the embedding table shards over vocab only (tensor + fsdp)
_EMBED_RULE = (r"word_emb/embedding$", (("tensor", "fsdp"), None))

DIFFUSEQ_RULES: Rules = MOE_RULES + _BACKBONE_RULES + (
    _EMBED_RULE,
    (r"(^|/)pos_emb$", (None, "fsdp")),
    (r"in_proj/kernel$", (None, "fsdp")),
    (r"out_proj/kernel$", ("fsdp", None)),
    # LN scales/biases, Dense biases, the time-embedding MLP: replicated
    (r".*", ()),
)

GPT2_RULES: Rules = MOE_RULES + _BACKBONE_RULES + (
    _EMBED_RULE,
    # pos_emb replicated (it adds directly into the activation)
    (r".*", ()),
)

_FAMILY_RULES: Dict[str, Rules] = {
    "diffuseq": DIFFUSEQ_RULES,
    "gpt2": GPT2_RULES,
}


def rules_for_workload(workload: Any) -> Optional[Rules]:
    """The rule table a workload declares (``workload.partition_rules``),
    else its family's built-in table, else None."""
    declared = getattr(workload, "partition_rules", None)
    if declared:
        return tuple(declared)
    return _FAMILY_RULES.get(getattr(workload, "family", ""))


def rules_from_json(raw: Any) -> Rules:
    """Wire-format rule list -> Rules: an ordered list of ``[regex, spec]``
    pairs where ``spec`` is a list of entries: ``null`` (replicate the
    dim), a mesh-axis name, or a list of axis names."""
    rules = []
    for entry in raw:
        if not (isinstance(entry, list) and len(entry) == 2
                and isinstance(entry[0], str) and isinstance(entry[1], list)):
            raise ValueError(
                f"partition rule entries must be [regex, [spec...]] pairs, "
                f"got {entry!r}")
        pat, spec = entry
        rules.append((pat, tuple(tuple(e) if isinstance(e, list) else e
                                 for e in spec)))
    return tuple(rules)


def rules_to_json(rules: Rules) -> list:
    """Rules -> the wire format :func:`rules_from_json` reads (round-trips
    exactly)."""
    return [[pat, [list(e) if isinstance(e, tuple) else e
                   for e in tuple(spec)]] for pat, spec in rules]


def _read_rules_body(text: str) -> str:
    """``--partition_rules`` input: inline JSON, ``@/path.json``, or a bare
    file path."""
    body = text.strip()
    if body.startswith("@"):
        with open(body[1:]) as f:
            return f.read()
    if not body.startswith(("[", "{")):
        with open(body) as f:
            return f.read()
    return body


def _artifact_rules(raw: Any) -> Any:
    if isinstance(raw, dict) and "partition_rules" not in raw:
        raise ValueError(
            "a --partition_rules JSON object must carry the rule "
            "list under 'partition_rules' (the tuner artifact shape)")
    return raw["partition_rules"] if isinstance(raw, dict) else raw


def parse_partition_rules(text: str) -> Optional[Rules]:
    """``--partition_rules``: inline JSON, ``@/path.json`` or a bare file
    path, holding the ordered ``[regex, spec]`` pair list, e.g.
    ``[["attn/qkv$", ["fsdp", null, "tensor", null]], [".*", []]]``, or a
    tuner artifact object whose rules ride its ``partition_rules`` key.
    None for empty input."""
    if not text:
        return None
    return rules_from_json(_artifact_rules(json.loads(_read_rules_body(text))))


def load_partition_artifact(text: str) -> Optional[Dict[str, Any]]:
    """The whole ``--partition_rules`` payload with the tuner's layout
    recommendations: ``{"rules", "mesh" (dict or None), "shard_optimizer"
    (bool or None)}``; a plain rule list gives mesh and shard_optimizer
    None, empty input None."""
    if not text:
        return None
    raw = json.loads(_read_rules_body(text))
    rules = rules_from_json(_artifact_rules(raw))
    if not isinstance(raw, dict):
        return {"rules": rules, "mesh": None, "shard_optimizer": None}
    mesh = raw.get("mesh")
    return {"rules": rules,
            "mesh": dict(mesh) if isinstance(mesh, dict) else None,
            "shard_optimizer": (bool(raw["shard_optimizer"])
                                if raw.get("shard_optimizer") is not None
                                else None)}


# ----------------------------------------------------- the sharded layout

def unit_of(name: str) -> str:
    """A parameter's FSDP unit: its block (``backbone.block_i``), or ``""``
    for the rest of the model (embeddings, projections, ``ln_f``)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "backbone" and \
            parts[1].startswith("block_"):
        return ".".join(parts[:2])
    return ""


@dataclasses.dataclass
class Unit:
    """One FSDP unit's cut leaves: their offsets in the gathered unit
    (``offsets``), its padded length ``size`` (a multiple of fsdp), the
    ``piece`` each fsdp rank holds and where that piece starts in the
    rank's flat buffer (``local_off``)."""

    key: str
    leaves: List[str]
    offsets: Dict[str, int]
    size: int
    piece: int
    local_off: int


@dataclasses.dataclass
class StageUnit:
    """A pipe stage's fsdp-cut leaves: ``rows`` stage rows, each row's cut
    weights at ``offsets`` in a row of ``size`` elements (padded to a
    multiple of fsdp), the ``piece`` of each row an fsdp rank holds, the
    rank's row pieces one after another from ``local_off``. Gathered, the
    stage is ``[rows, size]`` and each cut leaf a view of its columns."""

    leaves: List[str]
    offsets: Dict[str, int]
    row: Dict[str, int]
    size: int
    piece: int
    rows: int
    local_off: int

    @property
    def local_end(self) -> int:
        return self.local_off + self.rows * self.piece


class ShardLayout:
    """Which leaf is cut, over which group, and where each lives.

    ``leaves`` is the model's ``(name, shape)`` list in parameter order;
    ``full`` maps each name to ``(offset, numel, shape)`` in the full flat
    layout (the order of ``leaves``, ``n`` elements in all: checkpoints
    and the unsharded trainer use it). With ``fsdp`` F > 1 a leaf whose
    fixed spec (``fix_spec(match_partition_rules(rules))`` at ``sizes``)
    names ``fsdp`` is cut: this rank's flat buffer holds, for each unit in
    turn, its piece of the unit's cut leaves, then every replicated leaf
    whole (``local``: name -> ``(offset, numel, shape)`` for those), ``m``
    elements in all. With F = 1 that buffer is the full layout. Under
    ZeRO-1 (``shard_optimizer`` with a data axis D > 1) the buffer is
    padded to ``m_pad``, a multiple of D, and this rank updates
    ``[lo, hi)``, its data index's D-th; else it updates all of it.

    With a pipe axis S > 1 the leaves whose fixed spec puts ``pipe`` on
    dim 0 (``staged``) hold this rank's rows, the layers ``stage_layers``
    (``pipe_index`` s, ``pipe_virtual`` V), in ``[0, staged_end)`` of its
    buffer: the uncut ones whole in ``[0, stage_uncut_end)``, then the
    stage unit's row pieces (``stage_unit``, with fsdp). ``stage_whole``
    maps each staged leaf to ``(offset, numel, shape)`` in a stage slice
    with every leaf's rows whole, ``stage_n`` elements."""

    def __init__(self, leaves: Sequence[Tuple[str, Sequence[int]]], *,
                 sizes: Mapping[str, int], rules: Optional[Rules] = None,
                 fsdp_index: int = 0, data_index: int = 0,
                 shard_optimizer: bool = False,
                 unit_key: Callable[[str], str] = unit_of,
                 pipe_index: int = 0, pipe_virtual: int = 1) -> None:
        self.sizes = {a: int(sizes.get(a, 1)) for a in
                      ("data", "fsdp", "sequence", "tensor", "expert",
                       "pipe")}
        F, D = self.sizes["fsdp"], self.sizes["data"]
        self.full: Dict[str, Tuple[int, int, Tuple[int, ...]]] = {}
        off = 0
        for name, shape in leaves:
            n = math.prod(shape)
            self.full[name] = (off, n, tuple(shape))
            off += n
        self.n = off
        self.specs: Dict[str, Spec] = {}
        if rules is not None:
            matched = match_partition_rules(
                rules, {param_path(k): v[2] for k, v in self.full.items()})
            self.specs = {k: fix_spec(self.sizes, matched[param_path(k)],
                                      v[2]) for k, v in self.full.items()}
        self.cut = [k for k in self.full
                    if F > 1 and "fsdp" in {a for e in self.specs.get(k, ())
                                            for a in spec_axes(e)}]
        cut = set(self.cut)
        S = self.sizes["pipe"]
        self.staged = [k for k in self.full if S > 1
                       and self.specs.get(k, (None,))[:1] == ("pipe",)]
        self.pipe_index, self.pipe_virtual = pipe_index, pipe_virtual
        self.stage_layers: Tuple[int, ...] = ()
        self.stage_unit: Optional[StageUnit] = None
        self.stage_whole: Dict[str, Tuple[int, int, Tuple[int, ...]]] = {}
        self.stage_n = 0
        local_off = 0
        self.local: Dict[str, Tuple[int, int, Tuple[int, ...]]] = {}
        if self.staged:
            from ..models.pipeline import stage_layers
            depth = {self.full[k][2][0] for k in self.staged}
            if len(depth) != 1:
                raise ValueError(f"stacked leaves of unequal depths "
                                 f"{sorted(depth)}")
            self.stage_layers = stage_layers(depth.pop(), S, pipe_index,
                                             pipe_virtual)
            rows = len(self.stage_layers)
            for name in self.staged:
                shape = (rows,) + self.full[name][2][1:]
                n = math.prod(shape)
                self.stage_whole[name] = (self.stage_n, n, shape)
                self.stage_n += n
                if name not in cut:
                    self.local[name] = (local_off, n, shape)
                    local_off += n
            stage_cut = [k for k in self.staged if k in cut]
            if stage_cut:
                offsets, row, size = {}, {}, 0
                for k in stage_cut:
                    offsets[k], row[k] = size, self.stage_whole[k][1] // rows
                    size += row[k]
                size = -(-size // F) * F
                self.stage_unit = StageUnit(stage_cut, offsets, row, size,
                                            size // F, rows, local_off)
                local_off = self.stage_unit.local_end
        self.stage_uncut_end = (self.stage_unit.local_off if self.stage_unit
                                else local_off)
        self.staged_end = local_off
        staged = set(self.staged)
        keys: List[str] = [""]
        for name in self.full:
            if unit_key(name) not in keys:
                keys.append(unit_key(name))
        self.units: List[Unit] = []
        for key in keys:
            names = [k for k in self.full if k in cut and k not in staged
                     and unit_key(k) == key]
            if not names:
                continue
            offsets, size = {}, 0
            for k in names:
                offsets[k] = size
                size += self.full[k][1]
            size = -(-size // F) * F
            self.units.append(Unit(key, names, offsets, size, size // F,
                                   local_off))
            local_off += size // F
        self.pieces = local_off
        for name, (_o, n, shape) in self.full.items():
            if name not in cut and name not in staged:
                self.local[name] = (local_off, n, shape)
                local_off += n
        self.m = local_off
        self.fsdp_index = fsdp_index
        self.data_index = data_index
        self.zero1 = bool(shard_optimizer) and D > 1
        self.m_pad = -(-self.m // D) * D if self.zero1 else self.m
        own = self.m_pad // D if self.zero1 else self.m
        self.lo = data_index * own if self.zero1 else 0
        self.hi = self.lo + own

    @property
    def sharded(self) -> bool:
        """True when this rank holds less than the whole state."""
        return bool(self.units) or self.zero1 or bool(self.staged)

    def stage_unit_rows(self, local: Any, all_gather: Callable,
                        group: Any = None) -> Any:
        """The stage unit gathered, ``[rows, size]``: one all-gather of
        every fsdp rank's row pieces (in ``local``, this rank's flat
        buffer) over ``group``, rank-major, turned row-major."""
        u = self.stage_unit
        F = self.sizes["fsdp"]
        pieces = local.new_empty(F * u.rows * u.piece)
        all_gather(pieces, local[u.local_off:u.local_end], group)
        return pieces.view(F, u.rows, u.piece).transpose(0, 1).reshape(
            u.rows, u.size)

    def layers_of(self, pipe_index: int) -> Tuple[int, ...]:
        """The layers pipe rank ``pipe_index`` holds, in its rows' order."""
        from ..models.pipeline import stage_layers
        depth = self.full[self.staged[0]][2][0]
        return stage_layers(depth, self.sizes["pipe"], pipe_index,
                            self.pipe_virtual)

    @property
    def own(self) -> int:
        return self.hi - self.lo

    def local_from_full(self, state: Mapping[str, Any], out: Any) -> None:
        """Fill this rank's flat buffer ``out`` (``m`` or more elements; the
        padding is left as it is) from a full state dict: each replicated
        leaf whole, and this fsdp index's piece of each unit's cut
        leaves."""
        f = self.fsdp_index
        staged = set(self.staged)
        for name, (off, n, _shape) in self.local.items():
            leaf = state[name]
            if name in staged:
                leaf = leaf[list(self.stage_layers)]
            out[off:off + n].copy_(leaf.reshape(-1))
        su = self.stage_unit
        if su is not None:
            lo, hi = f * su.piece, (f + 1) * su.piece
            for i, layer in enumerate(self.stage_layers):
                base = su.local_off + i * su.piece - lo
                for name in su.leaves:
                    a = su.offsets[name]
                    b = a + su.row[name]
                    s, e = max(a, lo), min(b, hi)
                    if s < e:
                        out[base + s:base + e].copy_(
                            state[name][layer].reshape(-1)[s - a:e - a])
        for u in self.units:
            lo, hi = f * u.piece, (f + 1) * u.piece
            for name in u.leaves:
                a = u.offsets[name]
                b = a + self.full[name][1]
                s, e = max(a, lo), min(b, hi)
                if s < e:
                    out[u.local_off + s - lo:u.local_off + e - lo].copy_(
                        state[name].reshape(-1)[s - a:e - a])

    def gather_full(self, local: Any, out: Any, fsdp_group: Any = None,
                    all_gather: Optional[Callable] = None,
                    pipe_group: Any = None) -> Any:
        """The full flat layout (``n`` elements) into ``out`` from every
        fsdp rank's flat buffer ``local`` (whole over the data axis):
        replicated leaves copied, each unit's pieces all-gathered over
        ``fsdp_group`` (a collective every fsdp rank calls, unit by unit
        in order), the stage slices all-gathered over ``pipe_group`` and
        put back at their layers. ``all_gather(out, inp, group)`` defaults
        to ``dist.all_gather``."""
        if all_gather is None:
            from .dist import all_gather
        staged = set(self.staged)
        for name, (off, n, _shape) in self.local.items():
            if name in staged:
                continue
            out[self.full[name][0]:self.full[name][0] + n].copy_(
                local[off:off + n])
        if self.staged:
            S, W = self.sizes["pipe"], self.stage_n
            su = self.stage_unit
            if su is None:
                whole = local[:self.staged_end]
            else:
                whole = local.new_empty(W)
                for name in self.staged:
                    wo, n, shape = self.stage_whole[name]
                    if name in self.local:
                        off = self.local[name][0]
                        whole[wo:wo + n].copy_(local[off:off + n])
                gathered = self.stage_unit_rows(local, all_gather,
                                                fsdp_group)
                for name in su.leaves:
                    wo, n, _shape = self.stage_whole[name]
                    a = su.offsets[name]
                    whole[wo:wo + n].view(su.rows, -1).copy_(
                        gathered[:, a:a + su.row[name]])
                del gathered
            slices = local.new_empty(S * W)
            all_gather(slices, whole, pipe_group)
            for p in range(S):
                rows = list(self.layers_of(p))
                for name in self.staged:
                    wo, n, shape = self.stage_whole[name]
                    o, N, full_shape = self.full[name]
                    out[o:o + N].view(full_shape)[rows] = \
                        slices[p * W + wo:p * W + wo + n].view(shape)
            del slices, whole
        for u in self.units:
            unit = local.new_empty(u.size)
            all_gather(unit, local[u.local_off:u.local_off + u.piece],
                       fsdp_group)
            for name in u.leaves:
                a, n = u.offsets[name], self.full[name][1]
                o = self.full[name][0]
                out[o:o + n].copy_(unit[a:a + n])
            del unit
        return out

    def real_elements(self, lo: int, hi: int) -> int:
        """The elements of ``[lo, hi)`` of this rank's flat buffer that
        hold a parameter's value (the units' and the stage unit's padding,
        and the ZeRO-1 padding past ``m``, excluded)."""
        pads = []   # (start, end) of each padded stretch in the buffer
        f = self.fsdp_index
        su = self.stage_unit
        if su is not None:
            real = sum(su.row.values())
            for i in range(su.rows):
                start = su.local_off + i * su.piece
                keep = min(max(real - f * su.piece, 0), su.piece)
                pads.append((start + keep, start + su.piece))
        for u in self.units:
            real = sum(self.full[k][1] for k in u.leaves)
            keep = min(max(real - f * u.piece, 0), u.piece)
            pads.append((u.local_off + keep, u.local_off + u.piece))
        pads.append((self.m, self.m_pad))
        return max(hi - lo, 0) - sum(max(min(b, hi) - max(a, lo), 0)
                                     for a, b in pads)

    def name_at_local(self, i: int) -> str:
        """The leaf that element ``i`` of this rank's flat buffer belongs
        to (``"<padding>"`` past the leaves)."""
        su = self.stage_unit
        if su is not None and su.local_off <= i < su.local_end:
            pos = self.fsdp_index * su.piece + (i - su.local_off) % su.piece
            for name in su.leaves:
                if su.offsets[name] <= pos < su.offsets[name] + su.row[name]:
                    return name
            return "<padding>"
        for u in self.units:
            if u.local_off <= i < u.local_off + u.piece:
                pos = self.fsdp_index * u.piece + i - u.local_off
                for name in u.leaves:
                    a = u.offsets[name]
                    if a <= pos < a + self.full[name][1]:
                        return name
                return "<padding>"
        for name, (off, n, _shape) in self.local.items():
            if off <= i < off + n:
                return name
        return "<padding>"

    def describe(self) -> Dict[str, Any]:
        """The layout's sizes, for the launch log and the sidecar."""
        return {"n": self.n, "local": self.m, "local_padded": self.m_pad,
                "owned": self.own, "cut_leaves": len(self.cut),
                "units": len(self.units),
                "largest_unit": max((u.size for u in self.units), default=0),
                "staged_leaves": len(self.staged),
                "stage_elements": self.staged_end,
                "stage_unit_elements": (self.stage_unit.size * self.stage_unit.rows
                                    if self.stage_unit else 0),
                "pipe_layers": list(self.stage_layers)}
