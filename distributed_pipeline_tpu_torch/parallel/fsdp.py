"""The ``--fsdp`` units: the port of the JAX trainer's fsdp axis
(``distributed_pipeline_tpu/utils/trainer.py:452-491``), over the flat
buffers of ``utils/trainer.py``.

A :class:`~.partition.ShardLayout` says which leaves the rule table cuts
over ``fsdp`` and groups them in units: one a block, and one for the rest
of the model. Each fsdp rank holds its piece of every unit's cut leaves in
its flat parameter buffer. :class:`FsdpUnits` gives each unit two buffers
of its whole (padded) length, the gathered parameters and their
gradients, that the unit's cut parameters and their ``.grad`` are views
of, and whose storage is resized to 0 whenever the unit is not in use:

* a block is gathered (one all-gather of the pieces over the fsdp group)
  by a forward pre-hook and freed by the forward hook; the hook registered
  on its output gathers it again when the output's gradient arrives, just
  before the block's backward, and the post-accumulate-grad hooks of its
  cut parameters free it once the last of them has its gradient. Autograd
  keeps what the forward saved as views of the unit's storage; the gather
  refills that storage (through ``.data``, so no version counter moves)
  before anything reads it, as FSDP's flat parameters do. A block that
  runs again in the backward (``--remat``) finds itself gathered and
  leaves it so;
* the rest unit (the embeddings, the projections, ``ln_f``) is gathered
  by :meth:`FsdpUnits.rest` around a microbatch's whole forward and
  backward: GPT-2's tied ``word_emb`` is read at the input and in the
  head, and DiffuSeq reads it outside ``forward`` (``embed``, ``logits``),
  so the unit stays whole for both uses and its gradient is reduced once,
  after both;
* a unit's gradient buffer is allocated (zeroed) before its backward, and
  after every microbatch's backward :meth:`FsdpUnits.after_backward`
  scales each unit's gradient by ``1 / microbatches``, reduce-scatters it
  over the fsdp group into the rank's piece of the flat gradient buffer
  and frees it, unit by unit in layout order (the collectives never
  depend on the order in which autograd finished the units). The
  gradients of one microbatch are whole only for its backward; reducing
  each microbatch sums in another f32 order than the data-parallel run,
  which sums the microbatches on each rank first.

Under a pipe axis the stage's cut leaves are one more unit, the
**stage unit** (``ShardLayout.stage_unit``: a row of cut weights a stage
layer), placed as the JAX ``stage_apply`` places its gathers:

* without ``remat`` :meth:`FsdpUnits.stage` gathers the whole stage slice
  (one all-gather of the rank's row pieces) around a microbatch's
  schedule and holds it across its ticks, so the 1F1B B slot's recompute
  gathers nothing again; the stacked parameters are views of its columns
  and their gradients of a gradient buffer of the same layout, which
  ``after_backward`` reduce-scatters with the other units;
* with ``remat`` nothing is held: :meth:`FsdpUnits.gather_row` (the
  stacked blocks' ``gather``) gathers one row inside its layer's
  checkpointed body (so the backward gathers it
  again), and that gather's backward reduce-scatters the row's gradient
  straight into the rank's piece (the all-gather's transpose), so at most
  a layer's weights and their gradient are whole at once.

:meth:`FsdpUnits.pinned` points every parameter into one full flat buffer
(the gathered weights, or an EMA copy) and turns the hooks off, for the
eval callbacks and ``TrainLoop.ema_weights``. ``gathered_bytes`` counts
every byte the all-gathers have put together.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Any, Dict, Iterator, Optional

import torch

from . import dist
from .partition import ShardLayout

__all__ = ["FsdpUnits"]


def _free(buf: torch.Tensor) -> None:
    buf.untyped_storage().resize_(0)


def _alloc(buf: torch.Tensor) -> bool:
    """Give ``buf`` its storage back; True when it had none."""
    storage = buf.untyped_storage()
    nbytes = buf.numel() * buf.element_size()
    if storage.nbytes() == nbytes:
        return False
    storage.resize_(nbytes)
    return True


class _LayerGather(torch.autograd.Function):
    """One stage row's cut weights whole: the forward all-gathers the fsdp
    ranks' pieces of the row; the backward reduce-scatters the row's
    gradient (times ``scale``) into this rank's piece of the flat
    gradient. ``anchor`` (a 0-d leaf) ties the op into the graph."""

    @staticmethod
    def forward(ctx, anchor, units, row):
        ctx.units, ctx.row = units, row
        return units.gather_row(row)

    @staticmethod
    def backward(ctx, grad):
        ctx.units.scatter_row(ctx.row, grad)
        return None, None, None


class _StageGather:
    """``PipelinedBlocks.gather`` under fsdp with remat: a stage row's cut
    weights by name, through :class:`_LayerGather`; ``active`` is false
    while the parameters are pinned whole."""

    def __init__(self, units: "FsdpUnits") -> None:
        self.units = units
        self.names = {n.rsplit(".", 1)[1]: n
                      for n in units.layout.stage_unit.leaves}

    @property
    def active(self) -> bool:
        return not self.units.pinned

    def __call__(self, row: int) -> Dict[str, torch.Tensor]:
        units = self.units
        su = units.layout.stage_unit
        whole = (_LayerGather.apply(units.anchor, units, row)
                 if torch.is_grad_enabled() else units.gather_row(row))
        return {short: whole[su.offsets[name]:su.offsets[name]
                             + su.row[name]].view(
                                 units.layout.full[name][2][1:])
                for short, name in self.names.items()}


class FsdpUnits:
    """The gathered-unit buffers and hooks of ``model`` over ``layout``:
    ``params`` and ``grads`` are the rank's flat buffers (the pieces at
    each unit's ``local_off``), ``group`` the fsdp process group, and the
    two timers time the all-gathers and the reduce-scatters."""

    def __init__(self, model: torch.nn.Module, layout: ShardLayout,
                 params: torch.Tensor, grads: torch.Tensor, group: Any,
                 gather_time: Any, scatter_time: Any) -> None:
        self.layout = layout
        self.params = params
        self.grads = grads
        self.group = group
        self.gather_time = gather_time
        self.scatter_time = scatter_time
        self.device = params.device
        self.units = {u.key: u for u in layout.units}
        self.bufs: Dict[str, torch.Tensor] = {}
        self.gbufs: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, str] = {}       # free | fwd | bwd | rest
        self.pending: Dict[str, int] = {}
        self.pinned = False
        self.gathers = 0
        self.gathered_bytes = 0
        self.scale = 1.0
        named = dict(model.named_parameters())
        self._named = named
        self.remat_stage = False
        su = layout.stage_unit
        if su is not None:
            blocks = model.get_submodule("backbone.blocks")
            self.remat_stage = bool(blocks.remat)
            # the gathered stage [rows, size] and its gradient; each cut
            # stacked leaf a view of its columns
            self.sbuf = torch.empty((su.rows, su.size), dtype=params.dtype,
                                    device=self.device)
            self.sgbuf = torch.zeros((su.rows, su.size),
                                     dtype=params.dtype, device=self.device)
            for name in su.leaves:
                p, a = named[name], su.offsets[name]
                shape = (su.rows,) + tuple(p.shape[1:])
                p.data = self.sbuf[:, a:a + su.row[name]].view(shape)
                p.grad = self.sgbuf[:, a:a + su.row[name]].view(shape)
            _free(self.sbuf)
            _free(self.sgbuf)
            # a stacked leaf and its gradient are column views of the
            # [rows, size] buffers (not dense): autograd still accumulates
            # in place, and says so once a process
            warnings.filterwarnings(
                "ignore", message="grad and param do not obey the gradient "
                                  "layout contract")
            if self.remat_stage:
                self.anchor = torch.zeros((), device=self.device,
                                          requires_grad=True)
                blocks.gather = _StageGather(self)
        for u in layout.units:
            buf = torch.empty(u.size, dtype=params.dtype, device=self.device)
            gbuf = torch.zeros(u.size, dtype=params.dtype,
                               device=self.device)
            for name in u.leaves:
                p = named[name]
                a, n, shape = u.offsets[name], p.numel(), tuple(p.shape)
                p.data = buf[a:a + n].view(shape)
                p.grad = gbuf[a:a + n].view(shape)
                if u.key:
                    p.register_post_accumulate_grad_hook(
                        functools.partial(self._accumulated, u.key))
            _free(buf)
            _free(gbuf)
            self.bufs[u.key], self.gbufs[u.key] = buf, gbuf
            self.state[u.key] = "free"
            if u.key:
                module = model.get_submodule(u.key)
                module.register_forward_pre_hook(
                    functools.partial(self._pre_forward, u.key))
                module.register_forward_hook(
                    functools.partial(self._post_forward, u.key))

    @property
    def largest_unit_bytes(self) -> int:
        """Bytes of the largest gathered unit (the stage unit whole, or one
        row of it under remat)."""
        su = self.layout.stage_unit
        stage = 0 if su is None else su.size * (1 if self.remat_stage
                                                 else su.rows)
        return max([u.size for u in self.units.values()] + [stage]) * 4

    # ------------------------------------------------------- the buffers

    def gather(self, key: str) -> None:
        """Refill unit ``key``'s parameters: one all-gather of the fsdp
        ranks' pieces into its storage."""
        u, buf = self.units[key], self.bufs[key]
        _alloc(buf)
        with self.gather_time.measure(self.device):
            dist.all_gather(buf.data, self.params[
                u.local_off:u.local_off + u.piece], self.group)
        self.gathers += 1
        self.gathered_bytes += buf.numel() * buf.element_size()

    # ------------------------------------------------------ the stage unit

    def _all_gather(self, out, inp, group):
        with self.gather_time.measure(self.device):
            dist.all_gather(out, inp, group)
        self.gathers += 1
        self.gathered_bytes += out.numel() * out.element_size()

    def gather_row(self, row: int) -> torch.Tensor:
        """Stage row ``row``'s cut weights whole (``size`` elements): one
        all-gather of its pieces."""
        su = self.layout.stage_unit
        out = torch.empty(su.size, dtype=self.params.dtype,
                          device=self.device)
        off = su.local_off + row * su.piece
        self._all_gather(out, self.params[off:off + su.piece], self.group)
        return out

    def scatter_row(self, row: int, grad: torch.Tensor) -> None:
        """Row ``row``'s gradient times ``scale`` (the trainer's
        1/microbatches, set before the backward that calls this),
        reduce-scattered into this rank's piece of the flat gradient
        (added to it)."""
        su = self.layout.stage_unit
        piece = torch.empty(su.piece, dtype=grad.dtype, device=self.device)
        with self.scatter_time.measure(self.device):
            dist.reduce_scatter(piece, (grad * self.scale).contiguous(),
                                self.group)
        off = su.local_off + row * su.piece
        self.grads[off:off + su.piece].add_(piece)

    @contextlib.contextmanager
    def stage(self, grads: bool = True) -> Iterator[None]:
        """The stage unit gathered (with a zeroed gradient buffer when
        ``grads``) for one microbatch's schedule, without remat; with it
        the rows gather inside their layers and this does nothing."""
        if (self.layout.stage_unit is None or self.remat_stage
                or self.pinned):
            yield
            return
        _alloc(self.sbuf)
        self.sbuf.data.copy_(self.layout.stage_unit_rows(
            self.params, self._all_gather, self.group))
        if grads and _alloc(self.sgbuf):
            self.sgbuf.data.zero_()
        try:
            yield
        finally:
            _free(self.sbuf)

    def _scatter_stage(self, scale: float) -> None:
        """The stage unit's gradient times ``scale``, reduce-scattered into
        the rank's row pieces, and its buffer freed."""
        su = self.layout.stage_unit
        if su is None or self.sgbuf.untyped_storage().nbytes() == 0:
            return
        F = self.layout.sizes["fsdp"]
        # rank-major [F, rows, piece]: fsdp rank f's pieces of every row
        send = (self.sgbuf.data * scale).view(
            su.rows, F, su.piece).transpose(0, 1).contiguous()
        out = torch.empty(su.rows * su.piece, dtype=send.dtype,
                          device=self.device)
        with self.scatter_time.measure(self.device):
            dist.reduce_scatter(out, send.view(-1), self.group)
        self.grads[su.local_off:su.local_end].add_(out)
        _free(self.sgbuf)

    def free(self, key: str) -> None:
        _free(self.bufs[key])
        self.state[key] = "free"

    def _grad_buffer(self, key: str) -> None:
        gbuf = self.gbufs[key]
        if _alloc(gbuf):
            gbuf.data.zero_()

    # ------------------------------------------------------------- hooks

    def _pre_forward(self, key: str, _module, _args) -> None:
        if self.pinned or self.state[key] != "free":
            return  # gathered already: a block recomputed in the backward
        self.gather(key)
        self.state[key] = "fwd"

    def _post_forward(self, key: str, _module, _args, output) -> None:
        if self.pinned or self.state[key] != "fwd":
            return
        self.free(key)
        out = output[0] if isinstance(output, tuple) else output
        if isinstance(out, torch.Tensor) and out.requires_grad:
            out.register_hook(functools.partial(self._pre_backward, key))

    def _pre_backward(self, key: str, _grad) -> None:
        if self.pinned:
            return
        if self.state[key] == "free":
            self.gather(key)
        self.state[key] = "bwd"
        self._grad_buffer(key)
        self.pending[key] = len(self.units[key].leaves)

    def _accumulated(self, key: str, _param) -> None:
        if self.pinned or self.state[key] != "bwd":
            return
        self.pending[key] -= 1
        if self.pending[key] == 0:
            self.free(key)

    # ----------------------------------------------------- the trainer's

    @contextlib.contextmanager
    def rest(self, grads: bool = True) -> Iterator[None]:
        """The rest unit gathered (with a zeroed gradient buffer when
        ``grads``) for one microbatch's forward and backward."""
        if "" not in self.units or self.pinned:
            yield
            return
        self.gather("")
        self.state[""] = "rest"
        if grads:
            self._grad_buffer("")
        try:
            yield
        finally:
            self.free("")

    def after_backward(self, scale: float) -> None:
        """After a microbatch's backward: free any unit still gathered,
        then, unit by unit in layout order, scale its gradient by
        ``scale``, reduce-scatter it into this rank's piece of ``grads``
        (added to what earlier microbatches left there) and free it."""
        for key in self.units:
            if self.state[key] != "free":
                self.free(key)
        self._scatter_stage(scale)
        piece: Optional[torch.Tensor] = None
        for key, u in self.units.items():
            gbuf = self.gbufs[key]
            if gbuf.untyped_storage().nbytes() == 0:
                continue  # no backward reached the unit
            gbuf.data.mul_(scale)
            if piece is None or piece.numel() < u.piece:
                piece = torch.empty(u.piece, dtype=gbuf.dtype,
                                    device=self.device)
            out = piece[:u.piece]
            with self.scatter_time.measure(self.device):
                dist.reduce_scatter(out, gbuf.data, self.group)
            self.grads[u.local_off:u.local_off + u.piece].add_(out)
            _free(gbuf)

    @contextlib.contextmanager
    def pinned_to(self, full: torch.Tensor) -> Iterator[None]:
        """Every parameter a view of the full flat buffer ``full`` (the
        layout's full offsets) and the hooks off, inside the block; each
        parameter's previous view after it."""
        before = {name: p.data for name, p in self._named.items()}
        was = self.pinned
        self.pinned = True
        try:
            for name, p in self._named.items():
                off, n, shape = self.layout.full[name]
                p.data = full[off:off + n].view(shape)
            yield
        finally:
            for name, p in self._named.items():
                p.data = before[name]
            self.pinned = was
