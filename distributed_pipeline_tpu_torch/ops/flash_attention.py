"""Flash attention, forward and backward: the port of
``distributed_pipeline_tpu/ops/flash_attention.py``.

Blocked online-softmax attention on ``[B, H, L, Dh]`` whose ``[L, L]``
scores never reach device memory. Two arms compute it:

* the CUDA kernels (``ops/csrc/flash_attention.cu``), wrapped by
  :func:`flash_forward` (``(out, lse)``) and :func:`flash_backward`
  (``(dq, dk, dv)``, with an optional lse cotangent ``g_lse``); each takes
  CUDA tensors only and counts its launches.
  bf16 runs the Hopper kernels (wgmma on TMA-loaded tiles; a one-pass
  backward whose dq parts go to f32 planes, one per key tile, summed in a
  fixed order, so dq is the same bits on every run), f32 the FMA kernels;
* the plain versions :func:`torch_flash_forward` (the JAX package's
  ``_xla_forward`` line for line: f32 scores, the exact ``where`` mask,
  ``lse = m + log(max(l, 1e-20))``, zeros on fully masked rows) and
  :func:`torch_flash_backward` (the FlashAttention-2 backward from
  ``(q, k, v, o, lse, dO)``: recompute ``p = exp(s - lse)`` under the same
  mask, ``delta = rowsum(dO * O) - g_lse``, ``dv = p^T dO``,
  ``ds = p * (dO v^T - delta)``, ``dq = ds k * scale``,
  ``dk = ds^T q * scale``).

:func:`flash_attention_lse` is the ``torch.autograd.Function`` over either
arm, returning ``(out, lse [B, H, L] f32)`` as the JAX function of that
name: its forward saves ``(q, k, v, pad_mask, out, lse)`` and its backward
runs the backward of the same arm on ``(g_out, g_lse)``, as the JAX
``custom_vjp`` does. The lse cotangent is what ring attention's cross-hop
fold (``parallel/ring.py``) hands back: ``d lse_i / d s_ij = p_ij``, so it
folds into the softmax-Jacobian term, ``delta = rowsum(dO * O) - g_lse``,
and the main kernels run unchanged on that delta. No cotangent (``None``)
is zeros, and then nothing is subtracted: :func:`flash_attention`, which
returns ``out`` alone, is that case. The kernel arm computes ``delta`` in a
small kernel before the main backward (the JAX package computes it in XLA
outside its Pallas kernel). A fully masked query row gives ``out = 0`` and
a finite ``lse = NEG_INF + log(1e-20)``, which the ring's fold weighs 0.

The kernels take bf16 and f32 at Dh 64 and 128 and raise on anything else;
the plain versions take any shape.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_lse", "flash_forward",
           "flash_backward", "torch_flash_forward", "torch_flash_backward",
           "NEG_INF", "forward_launch_count", "backward_launch_count",
           "lse_backward_launch_count",
           "reset_launch_counts", "launch_counters", "add_launches",
           "plain_call_counts",
           "flash_flops", "flash_hbm_bytes",
           "dq_launch_plan", "DQ_SCRATCH_CAP"]

NEG_INF = -1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

# Launches of each kernel since the last reset: one per wrapper call;
# "lse_backward" counts the backward's calls with an lse cotangent (its
# g_lse arm) once more
_launches = {"forward": 0, "backward": 0, "lse_backward": 0}
# Calls the autograd seam routed to the plain versions since the last reset
_plain_calls = {"forward": 0, "backward": 0}
# The bf16 backward's dq planes (one f32 [B, H, L, Dh] plane per key tile)
# are capped at this many bytes: past it, the key tiles go in several
# launches whose sums chain through one more plane.
DQ_SCRATCH_CAP = 256 * 2 ** 20


def forward_launch_count() -> int:
    return _launches["forward"]


def backward_launch_count() -> int:
    return _launches["backward"]


def lse_backward_launch_count() -> int:
    """Backward launches that folded an lse cotangent into delta."""
    return _launches["lse_backward"]


def reset_launch_counts() -> None:
    """Zero the launch counts and the plain-call counts."""
    for key in _launches:
        _launches[key] = 0
    for key in _plain_calls:
        _plain_calls[key] = 0


def plain_call_counts() -> Dict[str, int]:
    """``{"forward", "backward"}``: the seam's calls of
    ``torch_flash_forward`` / ``torch_flash_backward`` since the last
    reset."""
    return dict(_plain_calls)


def launch_counters() -> Dict[str, int]:
    """Both counters (``forward``, ``backward``) as a dict: a CUDA graph
    takes a snapshot before and after its capture, and the difference is
    what one replay launches."""
    return dict(_launches)


def add_launches(delta: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`launch_counters` difference): a
    graph replay's launches, which run no Python wrapper, or
    (``times=-1``) a capture's, which launched nothing."""
    for key, n in delta.items():
        _launches[key] += times * n


# ----------------------------------------------------------- plain versions

def _masked_scores(q: torch.Tensor, k: torch.Tensor,
                   pad_mask: Optional[torch.Tensor],
                   causal: bool) -> torch.Tensor:
    """f32 scores ``[B, H, L, L]`` with ``_xla_forward``'s masking."""
    L, dh = q.shape[-2], q.shape[-1]
    s = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float()) * (dh ** -0.5)
    if pad_mask is not None:
        s = s + (1.0 - pad_mask.float())[:, None, None, :] * NEG_INF
    if causal:
        tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                    device=q.device))
        s = torch.where(tri[None, None], s,
                        torch.full((), NEG_INF, device=q.device))
    return s


def torch_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad_mask: Optional[torch.Tensor] = None,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: ``(out [B, H, L, Dh] in q's dtype, lse [B, H, L]
    f32)``, ``_xla_forward`` line for line."""
    s = _masked_scores(q, k, pad_mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m),
                    torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhlm,bhmd->bhld",
                       (p / torch.clamp(l, min=1e-20)).to(v.dtype), v)
    lse = (m + torch.log(torch.clamp(l, min=1e-20)))[..., 0]
    return out.to(q.dtype), lse


def torch_flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pad_mask: Optional[torch.Tensor], causal: bool,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor,
                         g_lse: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain FlashAttention-2 backward, in f32: ``(dq, dk, dv)`` in the
    inputs' dtypes. ``g_lse`` ([B, H, L], or None for none) is the lse
    cotangent, subtracted from delta. Masked entries (and so fully masked
    rows) give zero."""
    scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, pad_mask, causal)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=s.device))
    do, o = dout.float(), out.float()
    delta = (do * o).sum(dim=-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse.float()[..., None]
    dv = torch.einsum("bhlm,bhld->bhmd", p, do)
    dp = torch.einsum("bhld,bhmd->bhlm", do, v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhlm,bhmd->bhld", ds, k.float())
    dk = torch.einsum("bhlm,bhld->bhmd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ the kernels

def _check_kernel_args(name: str, tensors, pad_mask) -> None:
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} is the CUDA kernel and takes CUDA tensors, "
                         f"got {q.device}; the plain version is "
                         f"torch_{name}")
    if q.dim() != 4:
        raise ValueError(f"{name} takes [B, H, L, Dh], got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES or q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name} supports float32/bfloat16 at head_dim "
                         f"{_HEAD_DIMS}, got {q.dtype} at {q.shape[-1]}")
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: operands differ in shape, dtype or "
                             f"device from q {tuple(q.shape)} {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} inputs must be contiguous")
    if pad_mask is not None:
        B, _, L, _ = q.shape
        if (tuple(pad_mask.shape) != (B, L) or pad_mask.dtype != torch.int32
                or pad_mask.device != q.device
                or not pad_mask.is_contiguous()):
            raise ValueError(f"{name}: pad_mask must be a contiguous int32 "
                             f"[{B}, {L}] tensor on {q.device}")


def _stats_ok(name: str, q: torch.Tensor, *stats: torch.Tensor) -> None:
    for t in stats:
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: lse/delta must be contiguous f32 "
                             f"{tuple(q.shape[:3])} on {q.device}")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pad_mask: Optional[torch.Tensor] = None,
                  causal: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(out in q's dtype, lse [B, H, L] f32)``."""
    _check_kernel_args("flash_forward", (q, k, v), pad_mask)
    from ._build import check, load_library
    lib = load_library()
    B, H, L, Dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.dpt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad_mask is None else pad_mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, H, L, Dh, int(causal),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    check(lib, err, "flash_forward")
    _launches["forward"] += 1
    return out, lse


def dq_launch_plan(B: int, H: int, L: int, Dh: int,
                   cap: Optional[int] = None) -> Tuple[int, int, int]:
    """``(key tiles a launch, dq planes, launches)`` of the bf16 backward:
    its key tiles are 128 keys at Dh 64 and 64 at Dh 128, one f32 dq plane
    each; as many tiles go in one launch as keep the planes under ``cap``
    bytes (default ``DQ_SCRATCH_CAP``), at least one."""
    cap = DQ_SCRATCH_CAP if cap is None else cap
    n_kt = -(-L // (128 if Dh == 64 else 64))
    kt = max(1, min(n_kt, cap // (B * H * L * Dh * 4)))
    return kt, kt, -(-n_kt // kt)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pad_mask: Optional[torch.Tensor], causal: bool,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   g_lse: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels (one count per call): ``(dq, dk, dv)`` in q's
    dtype. A first kernel computes ``delta = rowsum(dO * O) - g_lse`` in
    f32 (``g_lse``: the lse cotangent, contiguous f32 [B, H, L], or None
    for none; a call with one also counts as an ``lse_backward``). bf16
    then runs the one-pass kernel, whose CTAs store their key tile's dq
    part in an f32 plane of their own (:func:`dq_launch_plan`), and a
    kernel that sums the planes in ascending key order and casts: no
    atomics, so two calls on the same inputs give the same bits. f32 runs
    the dk/dv kernel and the dq kernel."""
    _check_kernel_args("flash_backward", (q, k, v, out, dout), pad_mask)
    _stats_ok("flash_backward", q, lse,
              *(() if g_lse is None else (g_lse,)))
    from ._build import check, load_library
    lib = load_library()
    B, H, L, Dh = q.shape
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    dq_part = dq_accum = None
    kt_per_launch = 0
    if q.dtype == torch.bfloat16:
        kt_per_launch, planes, launches = dq_launch_plan(B, H, L, Dh)
        dq_part = torch.empty((planes,) + tuple(q.shape),
                              dtype=torch.float32, device=q.device)
        if launches > 1:
            dq_accum = torch.empty(q.shape, dtype=torch.float32,
                                   device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        err = lib.dpt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(pad_mask),
            dout.data_ptr(), out.data_ptr(), lse.data_ptr(), ptr(g_lse),
            delta.data_ptr(), ptr(dq_part), ptr(dq_accum),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, L, Dh,
            int(causal), _DTYPE_CODES[q.dtype], kt_per_launch,
            torch.cuda.current_stream().cuda_stream)
    check(lib, err, "flash_backward")
    _launches["backward"] += 1
    if g_lse is not None:
        _launches["lse_backward"] += 1
    return dq, dk, dv


# --------------------------------------------------------- autograd seam

class _FlashAttention(torch.autograd.Function):
    """``(out, lse)`` with the backward of the same arm on ``(g_out,
    g_lse)``; a ``None`` cotangent is zeros (the grads are not
    materialized, so an unused lse subtracts nothing)."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, causal: bool, use_kernel: bool):
        if use_kernel:
            out, lse = flash_forward(q, k, v, pad_mask, causal)
        else:
            out, lse = torch_flash_forward(q, k, v, pad_mask, causal)
            _plain_calls["forward"] += 1
        ctx.save_for_backward(q, k, v, pad_mask, out, lse)
        ctx.causal = causal
        ctx.use_kernel = use_kernel
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, g_lse):
        q, k, v, pad_mask, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        if ctx.use_kernel:
            dq, dk, dv = flash_backward(
                q, k, v, pad_mask, ctx.causal, out, lse, dout.contiguous(),
                None if g_lse is None else g_lse.float().contiguous())
        else:
            dq, dk, dv = torch_flash_backward(q, k, v, pad_mask, ctx.causal,
                                              out, lse, dout, g_lse)
            _plain_calls["backward"] += 1
        return dq, dk, dv, None, None, None


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad_mask: Optional[torch.Tensor] = None,
                        causal: bool = False, impl: str = "torch"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked attention on ``[B, H, L, Dh]`` returning ``(out, lse [B, H,
    L] f32)``, both differentiable: the lse's cotangent folds into the
    backward's delta. ``pad_mask`` is [B, L] (1 = real token).
    ``impl="cuda"`` runs the kernels (CUDA tensors only), ``impl="torch"``
    the plain versions."""
    if impl not in ("cuda", "torch"):
        raise ValueError(f"flash impl must be cuda|torch, got {impl!r}")
    use_kernel = impl == "cuda"
    if use_kernel:
        q, k, v = (t.contiguous() for t in (q, k, v))
        if pad_mask is not None:
            pad_mask = pad_mask.to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, pad_mask, causal, use_kernel)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, impl: str = "torch"
                    ) -> torch.Tensor:
    """Blocked attention on ``[B, H, L, Dh]`` with gradients: the ``out`` of
    :func:`flash_attention_lse` (its lse unused, so its backward folds no
    cotangent)."""
    return flash_attention_lse(q, k, v, pad_mask, causal, impl)[0]


def flash_flops(B: int, H: int, L: int, Dh: int, causal: bool,
                backward: bool = False) -> float:
    """Matmul flops of one call: the forward's q.k and p.v (2 * 2 B H L^2
    Dh); the backward's recomputed q.k, then p^T dO, dO.v^T, ds^T q and ds.k
    (5 * 2 B H L^2 Dh); each halved under a causal mask (only the live half
    of the score matrix is needed)."""
    per_product = 2.0 * B * H * L * L * Dh * (0.5 if causal else 1.0)
    return per_product * (5 if backward else 2)


def flash_hbm_bytes(B: int, H: int, L: int, Dh: int, dtype_bytes: int,
                    has_mask: bool, backward: bool = False,
                    g_lse: bool = False) -> int:
    """Device-memory bytes one call must move, each input read once and
    each output written once: forward q, k, v (+ mask) in, out and the f32
    lse out; backward q, k, v, out, dO, lse and delta (+ mask, + the lse
    cotangent ``g_lse``) in, dq, dk, dv out."""
    act = B * H * L * Dh * dtype_bytes
    stat = B * H * L * 4
    mask = B * L * 4 if has_mask else 0
    if backward:
        return 8 * act + (3 if g_lse else 2) * stat + mask
    return 4 * act + stat + mask
