"""Flash attention, forward and backward: the port of
``distributed_pipeline_tpu/ops/flash_attention.py``.

Blocked online-softmax attention on ``[B, H, L, Dh]`` whose ``[L, L]``
scores never reach device memory. Two arms compute it:

* the CUDA kernels (``ops/csrc/flash_attention.cu``), wrapped by
  :func:`flash_forward` (``(out, lse)``) and :func:`flash_backward`
  (``(dq, dk, dv)``); each takes CUDA tensors only and counts its launches.
  bf16 runs the Hopper kernels (wgmma on TMA-loaded tiles; a one-pass
  backward whose dq is summed by f32 atomics), f32 the FMA kernels;
* the plain versions :func:`torch_flash_forward` (the JAX package's
  ``_xla_forward`` line for line: f32 scores, the exact ``where`` mask,
  ``lse = m + log(max(l, 1e-20))``, zeros on fully masked rows) and
  :func:`torch_flash_backward` (the FlashAttention-2 backward from
  ``(q, k, v, o, lse, dO)``: recompute ``p = exp(s - lse)`` under the same
  mask, ``delta = rowsum(dO * O)``, ``dv = p^T dO``,
  ``ds = p * (dO v^T - delta)``, ``dq = ds k * scale``,
  ``dk = ds^T q * scale``).

:func:`flash_attention` is the ``torch.autograd.Function`` over either arm:
its forward saves ``(q, k, v, pad_mask, out, lse)`` and its backward runs
the backward of the same arm, as the JAX ``custom_vjp`` does. The kernel
arm computes ``delta`` in a small kernel before the main backward (the JAX
package computes it in XLA outside its Pallas kernel). ``flash_attention_lse`` and the ``g_lse``
cotangent wait for ring attention (ROADMAP A.8).

The kernels take bf16 and f32 at Dh 64 and 128 and raise on anything else;
the plain versions take any shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_forward", "flash_backward",
           "torch_flash_forward", "torch_flash_backward", "NEG_INF",
           "forward_launch_count", "backward_launch_count",
           "reset_launch_counts", "flash_flops", "flash_hbm_bytes"]

NEG_INF = -1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

# Launches of each kernel since the last reset: one per wrapper call.
_launches = {"forward": 0, "backward": 0}


def forward_launch_count() -> int:
    return _launches["forward"]


def backward_launch_count() -> int:
    return _launches["backward"]


def reset_launch_counts() -> None:
    for key in _launches:
        _launches[key] = 0


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
                         dout: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain FlashAttention-2 backward, in f32: ``(dq, dk, dv)`` in the
    inputs' dtypes. Masked entries (and so fully masked rows) give zero."""
    scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, pad_mask, causal)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=s.device))
    do, o = dout.float(), out.float()
    delta = (do * o).sum(dim=-1, keepdim=True)
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


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pad_mask: Optional[torch.Tensor], causal: bool,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels (one count per call): ``(dq, dk, dv)`` in q's
    dtype. A first kernel computes ``delta = rowsum(dO * O)`` in f32. bf16
    then runs the one-pass kernel, which sums dq in an f32 scratch buffer
    by atomics (its last bits vary from run to run) and casts it; f32 runs
    the dk/dv kernel and the dq kernel."""
    _check_kernel_args("flash_backward", (q, k, v, out, dout), pad_mask)
    _stats_ok("flash_backward", q, lse)
    from ._build import check, load_library
    lib = load_library()
    B, H, L, Dh = q.shape
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    dq_accum = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                if q.dtype == torch.bfloat16 else None)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        err = lib.dpt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad_mask is None else pad_mask.data_ptr(),
            dout.data_ptr(), out.data_ptr(), lse.data_ptr(),
            delta.data_ptr(),
            None if dq_accum is None else dq_accum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, L, Dh,
            int(causal), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    check(lib, err, "flash_backward")
    _launches["backward"] += 1
    return dq, dk, dv


# --------------------------------------------------------- autograd seam

class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad_mask, causal: bool, use_kernel: bool):
        if use_kernel:
            out, lse = flash_forward(q, k, v, pad_mask, causal)
        else:
            out, lse = torch_flash_forward(q, k, v, pad_mask, causal)
        ctx.save_for_backward(q, k, v, pad_mask, out, lse)
        ctx.causal = causal
        ctx.use_kernel = use_kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad_mask, out, lse = ctx.saved_tensors
        if ctx.use_kernel:
            dq, dk, dv = flash_backward(q, k, v, pad_mask, ctx.causal, out,
                                        lse, dout.contiguous())
        else:
            dq, dk, dv = torch_flash_backward(q, k, v, pad_mask, ctx.causal,
                                              out, lse, dout)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, impl: str = "torch"
                    ) -> torch.Tensor:
    """Blocked attention on ``[B, H, L, Dh]`` with gradients; ``pad_mask``
    is [B, L] (1 = real token). ``impl="cuda"`` runs the kernels (CUDA
    tensors only), ``impl="torch"`` the plain versions."""
    if impl not in ("cuda", "torch"):
        raise ValueError(f"flash impl must be cuda|torch, got {impl!r}")
    use_kernel = impl == "cuda"
    if use_kernel:
        q, k, v = (t.contiguous() for t in (q, k, v))
        if pad_mask is not None:
            pad_mask = pad_mask.to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, pad_mask, causal, use_kernel)


def flash_flops(B: int, H: int, L: int, Dh: int, causal: bool,
                backward: bool = False) -> float:
    """Matmul flops of one call: the forward's q.k and p.v (2 * 2 B H L^2
    Dh); the backward's recomputed q.k, then p^T dO, dO.v^T, ds^T q and ds.k
    (5 * 2 B H L^2 Dh); each halved under a causal mask (only the live half
    of the score matrix is needed)."""
    per_product = 2.0 * B * H * L * L * Dh * (0.5 if causal else 1.0)
    return per_product * (5 if backward else 2)


def flash_hbm_bytes(B: int, H: int, L: int, Dh: int, dtype_bytes: int,
                    has_mask: bool, backward: bool = False) -> int:
    """Device-memory bytes one call must move, each input read once and
    each output written once: forward q, k, v (+ mask) in, out and the f32
    lse out; backward q, k, v, out, dO, lse and delta (+ mask) in, dq, dk,
    dv out."""
    act = B * H * L * Dh * dtype_bytes
    stat = B * H * L * 4
    mask = B * L * 4 if has_mask else 0
    if backward:
        return 8 * act + 2 * stat + mask
    return 4 * act + stat + mask
