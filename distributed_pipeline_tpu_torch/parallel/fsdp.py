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

:meth:`FsdpUnits.pinned` points every parameter into one full flat buffer
(the gathered weights, or an EMA copy) and turns the hooks off, for the
eval callbacks and ``TrainLoop.ema_weights``.
"""

from __future__ import annotations

import contextlib
import functools
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
        named = dict(model.named_parameters())
        self._named = named
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
        """Bytes of the largest gathered unit."""
        return max((u.size for u in self.units.values()), default=0) * 4

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
