"""The port's paged decode attention against the JAX package's.

On the CPU the port's arm is the plain version (``torch_paged_decode``,
which the seam takes for CPU tensors); it is held against the
JAX gather path ``xla_paged_decode`` and the JAX Pallas kernel
``flash_decode`` in interpret mode, on the page geometries of
tests/test_kernels.py. The CUDA kernel against the plain version runs only
where a GPU is present (marker ``cuda``); ``chip_smoke.py`` runs it at the
serving shapes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_pipeline_tpu.ops import flash_decode as jfd  # noqa: E402
from distributed_pipeline_tpu_torch.ops import flash_decode as fd  # noqa: E402
from distributed_pipeline_tpu_torch.serving.paged_kv import (  # noqa: E402
    TRASH_PAGE, PageManager, gather_kv, write_prompt_kv, write_token_kv)


def paged_case(rng, *, slots, n_pages, page_size, n_heads, head_dim,
               positions, table=None):
    """Random pool + block tables as numpy; page 0 is the trash page and
    holds large garbage so an accidental read shows up loudly."""
    P = 1 + slots * n_pages
    k = rng.standard_normal((P, page_size, n_heads, head_dim))
    v = rng.standard_normal((P, page_size, n_heads, head_dim))
    k[TRASH_PAGE] = 37.0
    v[TRASH_PAGE] = -53.0
    if table is None:
        table = 1 + np.arange(slots * n_pages).reshape(slots, n_pages)
    q = rng.standard_normal((slots, n_heads, head_dim))
    return (q.astype(np.float32), k.astype(np.float32), v.astype(np.float32),
            np.asarray(table, np.int32), np.asarray(positions, np.int32))


def port(case, impl="torch"):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in case]
    return fd.paged_decode_attention(*args, impl=impl).numpy()


def jax_xla(case):
    return np.asarray(jfd.xla_paged_decode(*map(jnp.asarray, case)))


def jax_pallas(case):
    return np.asarray(jfd.flash_decode(*map(jnp.asarray, case)))


@pytest.mark.parametrize("page_size,n_pages,positions", [
    (4, 4, [0, 3, 7, 15]),      # one live key, exact page edge, full
    (2, 8, [1, 4, 9, 14]),      # many small pages, interior positions
    (8, 2, [2, 5, 8, 12]),      # partial first page / spilled second
])
def test_plain_matches_jax_xla_and_pallas_across_geometries(
        page_size, n_pages, positions):
    case = paged_case(np.random.default_rng(7), slots=4, n_pages=n_pages,
                      page_size=page_size, n_heads=2, head_dim=8,
                      positions=positions)
    got = port(case)
    np.testing.assert_allclose(got, jax_xla(case), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, jax_pallas(case), rtol=2e-5, atol=2e-6)
    # the seam takes the plain version for CPU tensors: same numbers
    np.testing.assert_array_equal(port(case, impl="auto"), got)


def test_plain_ignores_dead_pages_and_garbage_tails():
    """Block-table entries past the live prefix may be anything: point them
    at the trash page and poison the dead rows of each last live page — the
    output must not move."""
    ps, n = 4, 4
    q, k, v, bt, pos = paged_case(np.random.default_rng(11), slots=3,
                                  n_pages=n, page_size=ps, n_heads=2,
                                  head_dim=8, positions=[1, 5, 9])
    clean = port((q, k, v, bt, pos))
    btp, kp, vp = bt.copy(), k.copy(), v.copy()
    for b, p in enumerate(pos):
        btp[b, p // ps + 1:] = TRASH_PAGE
        last = btp[b, p // ps]
        kp[last, p % ps + 1:] = 1e4
        vp[last, p % ps + 1:] = -1e4
    np.testing.assert_array_equal(port((q, kp, vp, btp, pos)), clean)


def test_plain_shared_pages_match_jax():
    """Two slots listing the same physical page (prefix sharing)."""
    case = paged_case(np.random.default_rng(13), slots=2, n_pages=3,
                      page_size=4, n_heads=2, head_dim=8, positions=[6, 10],
                      table=[[1, 2, 3], [1, 4, 5]])
    got = port(case)
    np.testing.assert_allclose(got, jax_xla(case), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, jax_pallas(case), rtol=2e-5, atol=2e-6)


def test_no_live_key_gives_zeros():
    """pos = -1: the slot has no live key and gives zeros (not NaN, not the
    all-masked average of its pages); the other slots are unaffected. The
    JAX arms are no oracle for that row (the XLA arm averages the trash
    page, the interpreted kernel leaves the row unwritten), so they are
    compared on the live slots."""
    case = paged_case(np.random.default_rng(19), slots=3, n_pages=2,
                      page_size=4, n_heads=2, head_dim=8,
                      positions=[-1, 3, 6])
    got = port(case)
    assert np.all(got[0] == 0.0) and np.isfinite(got).all()
    np.testing.assert_allclose(got[1:], jax_xla(case)[1:], rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(got[1:], jax_pallas(case)[1:], rtol=2e-5,
                               atol=2e-6)


def test_decode_hbm_bytes_equals_jax_census():
    rng = np.random.default_rng(23)
    for _ in range(20):
        B, n, ps = rng.integers(1, 6), rng.integers(1, 6), rng.integers(1, 9)
        bt = rng.integers(0, 12, (B, n))
        pos = rng.integers(-1, n * ps + 3, (B,))
        H, dh = rng.integers(1, 4), rng.integers(1, 9)
        for kw in ({}, {"dtype_bytes": 2}):
            assert fd.decode_hbm_bytes(bt, pos, ps, H, dh, **kw) == \
                jfd.decode_hbm_bytes(bt, pos, ps, H, dh, **kw)


def test_decode_hbm_bytes_of_the_cuda_kernel():
    """``step_table=False``: the kernel's own reads — distinct live K/V
    pages, q and out per slot, each live table entry and each position
    once, and no TPU step table."""
    ps, H, dh = 4, 2, 8
    bt = np.asarray([[1, 2, 3], [1, 4, 5], [6, 7, 8]])
    pos = np.asarray([6, 9, -1])          # 2 and 3 live pages, a dead slot
    page = ps * H * dh * 2                # bf16
    want = (2 * page * 4                  # pages 1, 2, 4, 5 (1 shared)
            + 3 * 2 * H * dh * 2          # q + out, every slot
            + (2 + 3 + 0) * 4 + 3 * 4)    # live entries + positions
    assert fd.decode_hbm_bytes(bt, pos, ps, H, dh, dtype_bytes=2,
                               step_table=False) == want
    assert fd.decode_hbm_bytes(bt, pos, ps, H, dh, dtype_bytes=2) == \
        want - 5 * 4 - 3 * 4 + 9 * 7 * 4


def test_resolve_decode_impl_and_cuda_on_cpu_raises():
    assert fd.resolve_decode_impl("auto", torch.device("cpu")) == "torch"
    assert fd.resolve_decode_impl("torch", torch.device("cpu")) == "torch"
    with pytest.raises(ValueError, match="auto|cuda|torch"):
        fd.resolve_decode_impl("pallas", torch.device("cpu"))
    case = paged_case(np.random.default_rng(29), slots=2, n_pages=2,
                      page_size=4, n_heads=2, head_dim=8, positions=[1, 5])
    before = fd.launch_count()
    with pytest.raises(ValueError, match="CUDA"):
        port(case, impl="cuda")
    port(case, impl="auto")
    assert fd.launch_count() == before  # the plain version is no launch
    # the kernel's wrapper itself takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode(*[torch.from_numpy(a) for a in case])
    assert fd.launch_count() == before


def test_paged_writers_and_gather_round_trip():
    """write_prompt_kv / write_token_kv put rows where gather_kv reads them;
    padded prompt rows go to the trash page."""
    ps, n, H, dh = 4, 3, 2, 8
    pages = torch.zeros(1 + 2 * n, ps, H, dh)
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    kv = torch.randn(2, H, 6, dh)
    valid = torch.tensor([[1] * 6, [1] * 3 + [0] * 3], dtype=torch.int32)
    write_prompt_kv(pages, bt, kv, valid)
    dense = gather_kv(pages, bt)                 # [B, H, n*ps, Dh]
    torch.testing.assert_close(dense[0, :, :6], kv[0])
    torch.testing.assert_close(dense[1, :, :3], kv[1, :, :3])
    assert torch.all(dense[1, :, 3:] == 0)
    row = torch.randn(2, H, dh)
    write_token_kv(pages, bt, row, torch.tensor([6, 3], dtype=torch.int32))
    dense = gather_kv(pages, bt)
    torch.testing.assert_close(dense[0, :, 6], row[0])
    torch.testing.assert_close(dense[1, :, 3], row[1])


def test_page_manager_alloc_free():
    mgr = PageManager(5, 4)
    assert mgr.capacity == 4 and mgr.pages_for(9) == 3
    a = mgr.alloc(3)
    assert TRASH_PAGE not in a.tolist()
    assert mgr.alloc(2) is None                  # all-or-nothing
    mgr.free(a)
    assert mgr.free_pages == 4
    with pytest.raises(ValueError, match="double free"):
        mgr.free(a[:1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype):
    """Kernel vs plain version on the card: f32 within 1e-4 rel / 1e-5 abs
    (another summation order), bf16 against the plain version evaluated in
    f32 from the same bf16 inputs, within one bf16 output rounding."""
    case = paged_case(np.random.default_rng(31), slots=5, n_pages=4,
                      page_size=16, n_heads=3, head_dim=64,
                      positions=[-1, 0, 15, 16, 63],
                      table=[[1, 2, 3, 4], [5, 6, 7, 8], [1, 9, 10, 11],
                             [12, 13, 14, 15], [16, 17, 18, 19]])
    t = [torch.from_numpy(a).to(cuda_device) for a in case]
    q, k, v = (x.to(dtype) for x in t[:3])
    before = fd.launch_count()
    got = fd.flash_decode(q, k, v, t[3], t[4])
    torch.cuda.synchronize()
    assert fd.launch_count() == before + 1
    ref = fd.torch_paged_decode(q.float(), k.float(), v.float(), t[3], t[4])
    tol = 1e-4 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), ref, rtol=tol,
                               atol=1e-5 if dtype == torch.float32 else 8e-3)
    assert torch.all(got[0] == 0)
