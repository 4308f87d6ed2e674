"""The port's flash attention against the JAX package's.

On the CPU the port's arm is the plain version (``torch_flash_forward`` /
``torch_flash_backward``, the ``impl="torch"`` autograd path); it is held
against the JAX Pallas kernel ``flash_attention`` in interpret mode (blocks
16/16) and the dense ``_xla_attention``, on the cases of tests/test_ops.py.
The CUDA kernels against the plain version run only where a GPU is present
(marker ``cuda``): the f32 FMA kernels, and the bf16 Hopper kernels at Dh 64
and 128, ragged lengths against their 128-row tile, causal and not, with
dead rows; ``chip_smoke.py`` runs them at the training shapes.

Tolerances: forward rtol/atol 2e-5 and gradients 1e-4, the bars the JAX
package holds its own kernel to against its dense arm (f32, another
summation order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_pipeline_tpu.ops.attention import _xla_attention  # noqa: E402
from distributed_pipeline_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention as jax_flash, flash_attention_lse as jax_flash_lse)
from distributed_pipeline_tpu_torch.ops import attention as att  # noqa: E402
from distributed_pipeline_tpu_torch.ops import flash_attention as fa  # noqa: E402


def qkv(seed, B=2, H=2, L=64, Dh=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, Dh)).astype(np.float32)
            for _ in range(3)]


def lens_mask(B, L, lens):
    return (np.arange(L)[None, :] < np.asarray(lens)[:, None]).astype(
        np.int32)


def port_out(arrays, mask, causal):
    t = [torch.from_numpy(a) for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    return fa.flash_attention(*t, m, causal, impl="torch").numpy()


def jax_args(arrays, mask):
    return [jnp.asarray(a) for a in arrays] + [
        None if mask is None else jnp.asarray(mask)]


@pytest.mark.parametrize("name,seed,shape,lens,causal", [
    ("dense", 0, (2, 2, 64, 32), None, False),
    ("causal", 0, (2, 2, 64, 32), None, True),
    ("padded", 1, (2, 2, 48, 32), [30, 30], False),
    ("padded_causal", 23, (3, 2, 96, 32), [96, 41, 7], True),
    ("ragged_odd_head", 2, (2, 2, 37, 24), None, True),
])
def test_forward_matches_jax_kernel_and_dense(name, seed, shape, lens,
                                              causal):
    arrays = qkv(seed, *shape)
    mask = None if lens is None else lens_mask(shape[0], shape[2], lens)
    got = port_out(arrays, mask, causal)
    ref_k = np.asarray(jax_flash(*jax_args(arrays, mask), causal, 16, 16))
    ref_d = np.asarray(_xla_attention(*jax_args(arrays, mask), causal))
    if lens is not None and not causal:
        # padded query rows: the dense arm averages over nothing useful
        # there; the JAX tests compare the valid rows (test_ops.py)
        valid = min(lens)
        got, ref_k, ref_d = (x[:, :, :valid] for x in (got, ref_k, ref_d))
    np.testing.assert_allclose(got, ref_k, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref_d, rtol=2e-5, atol=2e-5)


def test_lse_matches_flash_attention_lse():
    arrays = qkv(5, L=48)
    mask = lens_mask(2, 48, [48, 20])
    _, lse = fa.torch_flash_forward(*map(torch.from_numpy, arrays),
                                    torch.from_numpy(mask), True)
    _, ref = jax_flash_lse(*jax_args(arrays, mask), True, 16, 16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("lens,causal", [
    (None, True), ([96, 41, 7], False), ([96, 41, 7], True)])
def test_gradients_match_jax_kernel(lens, causal):
    arrays = qkv(23, 3, 2, 96, 32)
    mask = None if lens is None else lens_mask(3, 96, lens)
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    (fa.flash_attention(*t, m, causal, impl="torch") ** 2).sum().backward()
    jm = None if mask is None else jnp.asarray(mask)
    ref = jax.grad(
        lambda q, k, v: (jax_flash(q, k, v, jm, causal, 16, 16) ** 2).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for got, want in zip(t, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    if lens is not None:
        # masked-out keys receive zero gradient
        assert float(t[1].grad[1, :, 41:].abs().max()) == 0.0
        assert float(t[2].grad[2, :, 7:].abs().max()) == 0.0


def test_fully_masked_rows_zero_out_and_grads():
    arrays = qkv(19, 1, 1, 64, 32)
    mask = np.zeros((1, 64), np.int32)
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fa.flash_attention(*t, torch.from_numpy(mask), False, impl="torch")
    assert torch.all(out == 0)
    (out ** 2).sum().backward()
    for x in t:
        assert torch.all(x.grad == 0)
    _, lse = fa.torch_flash_forward(*map(torch.from_numpy, arrays),
                                    torch.from_numpy(mask), False)
    _, ref = jax_flash_lse(*jax_args(arrays, mask), False, 16, 16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref), rtol=2e-5)


def test_seam_routes_and_cuda_on_cpu_raises():
    arrays = qkv(7, L=32)
    q, k, v = map(torch.from_numpy, arrays)
    dense = att.dot_product_attention(q, k, v, None, True, impl="xla")
    auto = att.dot_product_attention(q, k, v, None, True, impl="auto")
    torch.testing.assert_close(auto, dense, rtol=0, atol=0)  # CPU: dense
    flash = att.dot_product_attention(q, k, v, None, True, impl="torch")
    torch.testing.assert_close(flash, dense, rtol=2e-5, atol=2e-5)
    before = (fa.forward_launch_count(), fa.backward_launch_count())
    for impl in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            att.dot_product_attention(q, k, v, None, True, impl=impl)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_forward(q, k, v)
    with pytest.raises(ValueError, match="needs a sequence group"):
        att.dot_product_attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="unknown"):
        att.dot_product_attention(q, k, v, impl="bogus")
    assert (fa.forward_launch_count(), fa.backward_launch_count()) == before


def test_flops_and_bytes_at_the_training_shape():
    """The bounds chip_smoke.py prices: 6.44 / 16.1 GFLOP and 25.4 / 50.7
    MB at B=4, H=12, L=1024, Dh=64, causal, bf16, no mask."""
    assert fa.flash_flops(4, 12, 1024, 64, True) == 6442450944.0
    assert fa.flash_flops(4, 12, 1024, 64, True, backward=True) == \
        16106127360.0
    assert fa.flash_hbm_bytes(4, 12, 1024, 64, 2, False) == 25362432
    assert fa.flash_hbm_bytes(4, 12, 1024, 64, 2, False, True) == 50724864


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal,lens", [(True, None), (True, [200, 77]),
                                         (False, [200, 0])])
def test_cuda_kernels_match_plain_version(cuda_device, causal, lens):
    """f32 kernels vs the plain version on the card: outputs and lse
    within 1e-5, gradients within 1e-4 (another summation order)."""
    arrays = qkv(31, 2, 3, 200, 64)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    mask = (None if lens is None else
            torch.from_numpy(lens_mask(2, 200, lens)).to(cuda_device))
    out, lse = fa.flash_forward(*t, mask, causal)
    ref_out, ref_lse = fa.torch_flash_forward(*t, mask, causal)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    dout = torch.randn_like(out)
    got = fa.flash_backward(*t, mask, causal, out, lse, dout)
    want = fa.torch_flash_backward(*t, mask, causal, ref_out, ref_lse, dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,L,causal,lens", [
    (64, 1024, True, None),          # the training shape's tiles
    (128, 1024, True, None),
    (64, 1, True, None),             # ragged against the 128-row tile
    (64, 65, True, [65, 30]),
    (128, 129, True, [129, 129]),
    (64, 1000, True, [1000, 1]),
    (64, 129, False, [129, 0]),      # non-causal with a dead row
    (128, 200, False, [200, 0]),
])
def test_cuda_bf16_kernels_match_plain_version(cuda_device, Dh, L, causal,
                                               lens):
    """The bf16 Hopper kernels (wgmma) vs the plain version in f32 from the
    same bf16 inputs. Forward: rtol 8e-3 and atol 1e-3 of the largest
    entry (one bf16 rounding of the output, and p rounded to bf16 before
    p.v as the JAX kernel's p.astype(v.dtype)); lse 1e-4. Gradients: a
    relative Frobenius error under 1e-2, and entrywise rtol 1e-2 and atol
    1e-2 of the largest entry, at least 1e-4 (p and ds enter their products
    as bf16 and dq's parts are summed in f32 in another order; in a row
    with few live keys ds = p (dp - delta) is a difference of nearly equal
    terms, so those roundings are large against that row's own gradient,
    and with one live key a gradient that is zero in exact arithmetic is
    f32 rounding)."""
    B, H = 2, 4
    rng = np.random.default_rng(L + Dh)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, L, Dh)).astype(
        np.float32)).to(cuda_device).to(torch.bfloat16) for _ in range(4))
    mask = (None if lens is None else
            torch.from_numpy(lens_mask(B, L, lens)).to(cuda_device))
    out, lse = fa.flash_forward(q, k, v, mask, causal)
    f = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = fa.torch_flash_forward(*f, mask, causal)
    torch.testing.assert_close(out.float(), ref_out, rtol=8e-3,
                               atol=1e-3 * float(ref_out.abs().max()))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    got = fa.flash_backward(q, k, v, mask, causal, out, lse, do)
    want = fa.torch_flash_backward(*f, mask, causal, out.float(), lse,
                                   do.float())
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        torch.testing.assert_close(a.float(), b, rtol=1e-2,
                                   atol=max(1e-2 * scale, 1e-4))
        assert float((a.float() - b).norm()) <= (
            1e-2 * float(b.norm()) + 1e-4 * b.numel() ** 0.5)
    if lens is not None and 0 in lens:
        dead = lens.index(0)
        assert torch.all(out[dead] == 0)
        assert all(torch.all(t[dead] == 0) for t in got)


def test_dq_launch_plan_caps_the_scratch():
    """The bf16 backward's dq planes: one per key tile (128 keys at Dh 64,
    64 at Dh 128), all key tiles in one launch while they fit under the
    cap, else as many launches as needed, never less than one tile a
    launch."""
    plane = 4 * 12 * 1024 * 64 * 4
    assert fa.dq_launch_plan(4, 12, 1024, 64) == (8, 8, 1)
    assert fa.dq_launch_plan(4, 12, 1024, 64, cap=3 * plane) == (3, 3, 3)
    assert fa.dq_launch_plan(4, 12, 1024, 64, cap=1) == (1, 1, 8)
    assert fa.dq_launch_plan(2, 4, 1000, 128, cap=10 ** 12) == (16, 16, 1)
    assert fa.dq_launch_plan(2, 4, 1, 64) == (1, 1, 1)
    assert 8 * plane <= fa.DQ_SCRATCH_CAP


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,causal,lens", [(64, True, None),
                                            (64, False, [1000, 601]),
                                            (128, True, [1000, 17])])
def test_cuda_bf16_backward_is_bitwise_reproducible(cuda_device, Dh, causal,
                                                    lens, monkeypatch):
    """dq's parts are summed in a fixed order: two backward calls on the
    same inputs give the same bits, and so does a call whose key tiles go
    in several launches (a small scratch cap)."""
    B, H, L = 2, 4, 1000
    rng = np.random.default_rng(Dh + L)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, L, Dh)).astype(
        np.float32)).to(cuda_device).to(torch.bfloat16) for _ in range(4))
    mask = (None if lens is None else
            torch.from_numpy(lens_mask(B, L, lens)).to(cuda_device))
    out, lse = fa.flash_forward(q, k, v, mask, causal)
    first = fa.flash_backward(q, k, v, mask, causal, out, lse, do)
    again = fa.flash_backward(q, k, v, mask, causal, out, lse, do)
    monkeypatch.setattr(fa, "DQ_SCRATCH_CAP", B * H * L * Dh * 4 * 2)
    assert fa.dq_launch_plan(B, H, L, Dh)[2] > 1
    split = fa.flash_backward(q, k, v, mask, causal, out, lse, do)
    for a, b, c in zip(first, again, split):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Dh,L,causal,lens", [
    (torch.float32, 64, 200, True, [200, 77]),
    (torch.float32, 128, 130, False, [130, 0]),
    (torch.bfloat16, 64, 512, True, None),        # GPT-2's diagonal hop
    (torch.bfloat16, 64, 512, False, None),       # and its earlier slice
    (torch.bfloat16, 128, 300, True, [300, 0]),
    (torch.bfloat16, 64, 129, False, [129, 0]),
])
def test_cuda_lse_cotangent_matches_plain_version(cuda_device, dtype, Dh, L,
                                                  causal, lens):
    """``flash_attention_lse`` on the kernels: ``(out, lse)`` and the
    backward of a random ``(g_out, g_lse)`` against the plain versions
    (the bars of the tests above for each dtype); the lse is the natural
    log the plain version writes (the bf16 kernel keeps its statistics in
    the log2 domain); a fully masked row has out 0, a finite lse below
    NEG_INF / 2 and zero gradients; the call counts one ``lse_backward``;
    and the bars cannot pass a backward that drops ``g_lse``."""
    B, H = 2, 4
    rng = np.random.default_rng(L + Dh + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, L, Dh)).astype(
        np.float32)).to(cuda_device).to(dtype) for _ in range(4))
    g_lse = torch.from_numpy(rng.standard_normal((B, H, L)).astype(
        np.float32)).to(cuda_device)
    mask = (None if lens is None else
            torch.from_numpy(lens_mask(B, L, lens)).to(cuda_device))
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    before = fa.lse_backward_launch_count()
    out, lse = fa.flash_attention_lse(*t, mask, causal, impl="cuda")
    torch.autograd.backward((out, lse), (do, g_lse))
    assert fa.lse_backward_launch_count() == before + 1
    f = [x.float() for x in (q, k, v)]
    ref_out, ref_lse = fa.torch_flash_forward(*f, mask, causal)
    want = fa.torch_flash_backward(*f, mask, causal, out.detach().float(),
                                   lse.detach(), do.float(), g_lse)
    torch.testing.assert_close(lse.detach(), ref_lse, rtol=1e-5, atol=1e-4)
    got = [x.grad for x in t]
    if dtype == torch.float32:
        torch.testing.assert_close(out.detach(), ref_out, rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(out.detach().float(), ref_out, rtol=8e-3,
                                   atol=1e-3 * float(ref_out.abs().max()))
        for a, b in zip(got, want):
            scale = float(b.abs().max())
            torch.testing.assert_close(a.float(), b, rtol=1e-2,
                                       atol=max(1e-2 * scale, 1e-4))
            assert float((a.float() - b).norm()) <= (
                1e-2 * float(b.norm()) + 1e-4 * b.numel() ** 0.5)
    dropped = fa.flash_backward(q, k, v, mask, causal, out.detach(),
                                lse.detach(), do)
    assert float((dropped[0].float() - want[0]).norm()) > \
        1e-2 * float(want[0].norm())
    if lens is not None and 0 in lens:
        dead = lens.index(0)
        assert torch.all(out[dead] == 0)
        assert torch.all(torch.isfinite(lse[dead]))
        assert float(lse[dead].max()) < fa.NEG_INF / 2
        assert all(torch.all(x[dead] == 0) for x in got)
