"""The port's paged decode attention against the JAX package's.

On the CPU the port's arm is the plain version (``torch_paged_decode``,
which the seam takes for CPU tensors); it is held against the
JAX gather path ``xla_paged_decode`` and the JAX Pallas kernel
``flash_decode`` in interpret mode, on the page geometries of
tests/test_kernels.py, over fp pools and int8 pools with per-page scales.
The port's int8 page writers are held bitwise against the JAX writers. The
CUDA kernel against the plain version runs only where a GPU is present
(marker ``cuda``); ``chip_smoke.py`` runs it at the serving shapes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_pipeline_tpu.ops import flash_decode as jfd  # noqa: E402
from distributed_pipeline_tpu.serving import paged_kv as jpkv  # noqa: E402
from distributed_pipeline_tpu_torch.ops import flash_decode as fd  # noqa: E402
from distributed_pipeline_tpu_torch.serving.paged_kv import (  # noqa: E402
    TRASH_PAGE, PageManager, dequant_gathered, gather_kv, write_prompt_kv,
    write_prompt_kv_q8, write_token_kv, write_token_kv_q8)


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


def quantized_case(rng, **kw):
    """``paged_case`` with int8 pools and [P] f32 scales: (q, k8, v8, table,
    positions, scales_k, scales_v). The trash page holds the largest
    values under a large scale."""
    q, k, v, table, pos = paged_case(rng, **kw)
    P = k.shape[0]
    k8 = rng.integers(-127, 128, k.shape).astype(np.int8)
    v8 = rng.integers(-127, 128, v.shape).astype(np.int8)
    k8[TRASH_PAGE], v8[TRASH_PAGE] = 127, -127
    sk = rng.uniform(0.002, 0.02, (P,)).astype(np.float32)
    sv = rng.uniform(0.002, 0.02, (P,)).astype(np.float32)
    sk[TRASH_PAGE] = sv[TRASH_PAGE] = 1.0
    return q, k8, v8, table, pos, sk, sv


def port(case, impl="torch"):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in case]
    return fd.paged_decode_attention(*args[:5], impl=impl,
                                     scales_k=(args[5:] or [None])[0],
                                     scales_v=(args[6:] or [None])[0]).numpy()


def jax_xla(case):
    return np.asarray(jfd.xla_paged_decode(*map(jnp.asarray, case)))


def jax_pallas(case):
    return np.asarray(jfd.flash_decode(*map(jnp.asarray, case)))


GEOMETRIES = [
    (4, 4, [0, 3, 7, 15]),      # one live key, exact page edge, full
    (2, 8, [1, 4, 9, 14]),      # many small pages, interior positions
    (8, 2, [2, 5, 8, 12]),      # partial first page / spilled second
]


@pytest.mark.parametrize("page_size,n_pages,positions", GEOMETRIES)
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


@pytest.mark.parametrize("page_size,n_pages,positions", GEOMETRIES)
def test_int8_plain_matches_jax_xla_and_pallas_across_geometries(
        page_size, n_pages, positions):
    """int8 pools: the plain version dequantizes after the gather, as the
    JAX XLA arm does, and agrees with the interpreted JAX kernel, which
    dequantizes each page with the scales of its step row."""
    case = quantized_case(np.random.default_rng(8), slots=4,
                          n_pages=n_pages, page_size=page_size, n_heads=2,
                          head_dim=8, positions=positions)
    got = port(case)
    np.testing.assert_allclose(got, jax_xla(case), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, jax_pallas(case), rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(port(case, impl="auto"), got)
    # the int8 pool is not read as if it were fp: the scales matter
    assert not np.allclose(got, port(case[:5] + (case[5] * 2, case[6])))


def test_dequant_gathered_matches_jax():
    _, k8, _, bt, _, sk, _ = quantized_case(
        np.random.default_rng(9), slots=3, n_pages=2, page_size=4,
        n_heads=2, head_dim=8, positions=[0, 1, 2])
    ref = jpkv.dequant_gathered(jpkv.gather_kv(jnp.asarray(k8), bt),
                                jnp.asarray(sk), jnp.asarray(bt), 4,
                                jnp.float32)
    tk = torch.from_numpy(k8)
    got = dequant_gathered(gather_kv(tk, torch.from_numpy(bt)),
                           torch.from_numpy(sk), torch.from_numpy(bt), 4,
                           torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _q8_pool(rng, P, ps, H, dh):
    pages = rng.integers(-127, 128, (P, ps, H, dh)).astype(np.int8)
    scales = rng.uniform(0.001, 0.01, (P,)).astype(np.float32)
    return pages, scales


def test_int8_prompt_writer_is_bitwise_the_jax_writer():
    """A padded prefill over pages holding an earlier request's content:
    the touched pages get SET scales (absmax / 127) and int8 rows bitwise
    equal to the JAX writer's; the padded rows land on the trash page,
    whose scale (like every untouched page's) is left alone."""
    rng = np.random.default_rng(41)
    ps, n, H, dh = 4, 3, 2, 8
    pages, scales = _q8_pool(rng, 1 + 2 * n, ps, H, dh)
    bt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    kv = (rng.standard_normal((2, H, 10, dh)) * 2).astype(np.float32)
    valid = np.asarray([[1] * 10, [1] * 3 + [0] * 7], np.int32)
    jp, js = jpkv.write_prompt_kv_q8(jnp.asarray(pages), jnp.asarray(scales),
                                     jnp.asarray(bt), jnp.asarray(kv),
                                     jnp.asarray(valid))
    tp, ts = torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy())
    out = write_prompt_kv_q8(tp, ts, torch.from_numpy(bt),
                             torch.from_numpy(kv), torch.from_numpy(valid))
    assert out[0] is tp and out[1] is ts          # in place
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[TRASH_PAGE] == scales[TRASH_PAGE]    # trash scale untouched
    assert ts[5] == scales[5] and ts[6] == scales[6]   # untouched pages
    # the trash page's rows are whichever padded row landed last: only the
    # pages a read can reach are compared
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])


def test_int8_token_writer_is_bitwise_the_jax_writer():
    """Decode writes whose rows outgrow their pages' scales (slot 0) or fit
    under them (slot 1), and an inactive slot on the trash page: scales
    grow to max(old, absmax / 127), the pages' earlier int8 content is
    re-expressed under the grown scale, all bitwise the JAX writer's."""
    rng = np.random.default_rng(43)
    ps, n, H, dh = 4, 3, 2, 8
    pages, scales = _q8_pool(rng, 1 + 2 * n, ps, H, dh)
    bt = np.asarray([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    row = rng.standard_normal((3, H, dh)).astype(np.float32)
    row[0] *= 10.0                                 # grows page 2's scale
    row[1] *= 1e-3                                 # fits page 5's scale
    pos = np.asarray([6, 9, 0], np.int32)
    jp, js = jpkv.write_token_kv_q8(jnp.asarray(pages), jnp.asarray(scales),
                                    jnp.asarray(bt), jnp.asarray(row),
                                    jnp.asarray(pos))
    tp, ts = torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy())
    write_token_kv_q8(tp, ts, torch.from_numpy(bt), torch.from_numpy(row),
                      torch.from_numpy(pos))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    assert ts[2] > scales[2] and ts[5] == scales[5]
    # the grown page's other rows were re-rounded, not left as they were
    assert not np.array_equal(tp.numpy()[2, :2], pages[2, :2])


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


def test_quantized_decode_hbm_bytes_equals_jax_census():
    """int8 pools: 1-byte pages, the 9-column step table."""
    rng = np.random.default_rng(24)
    for _ in range(20):
        B, n, ps = rng.integers(1, 6), rng.integers(1, 6), rng.integers(1, 9)
        bt = rng.integers(0, 12, (B, n))
        pos = rng.integers(-1, n * ps + 3, (B,))
        H, dh = rng.integers(1, 4), rng.integers(1, 9)
        for kw in ({"quantized": True}, {"quantized": True, "dtype_bytes": 2}):
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


def test_quantized_decode_hbm_bytes_of_the_cuda_kernel():
    """``step_table=False`` over an int8 pool: 1-byte pages and the 8 bytes
    of K and V scales of each live table entry."""
    ps, H, dh = 4, 2, 8
    bt = np.asarray([[1, 2, 3], [1, 4, 5], [6, 7, 8]])
    pos = np.asarray([6, 9, -1])
    page = ps * H * dh                    # int8
    want = (2 * page * 4 + 3 * 2 * H * dh * 2
            + (2 + 3 + 0) * 4 + 3 * 4     # live entries + positions
            + (2 + 3) * 8)                # scales of the live entries
    assert fd.decode_hbm_bytes(bt, pos, ps, H, dh, dtype_bytes=2,
                               quantized=True, step_table=False) == want


H100 = dict(sms=132, smem_optin=232448)


@pytest.mark.parametrize("shape,want", [
    # GPT-2 base serving, bf16: all heads a CTA, two 49 KB stages (two CTAs
    # share an SM), 4-page chunks -> 16 splits of a 64-page reservation
    ((32, 12, 64, 16, 64, 2), (12, 1, 2, 4, 16)),
    # the same over int8 pages: half the bytes, the same grid
    ((32, 12, 64, 16, 64, 1), (12, 1, 2, 4, 16)),
    # one long slot: one page a chunk, every page its own CTA
    ((1, 12, 64, 16, 64, 2), (12, 1, 1, 1, 64)),
    # f32 pages of Dh 128 do not fit twice: two groups of 6 heads
    ((32, 12, 128, 16, 64, 4), (6, 2, 2, 8, 8)),
    # more than 12 heads: groups of at most 12, balanced (25 -> 9 + 8 + 8)
    ((8, 25, 64, 16, 64, 2), (9, 3, 2, 3, 22)),
    # a one-page reservation never splits
    ((3, 12, 64, 16, 1, 2), (12, 1, 1, 1, 1)),
])
def test_decode_plan(shape, want):
    """The kernel's static grid and ring from the shapes alone."""
    plan = fd.decode_plan(*shape, **H100)
    assert tuple(plan[:5]) == want
    assert plan.smem_bytes <= H100["smem_optin"]
    assert plan.max_splits * plan.pages_per_chunk >= shape[4]
    assert plan.groups * plan.group_heads >= shape[1]


def test_decode_plan_raises_where_no_head_group_fits():
    with pytest.raises(ValueError, match="shared memory"):
        fd.decode_plan(4, 12, 128, 256, 4, 4, **H100)


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
    q8 = quantized_case(np.random.default_rng(30), slots=2, n_pages=2,
                        page_size=4, n_heads=2, head_dim=8, positions=[1, 5])
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode(*[torch.from_numpy(a) for a in q8])
    assert fd.launch_count() == before
    assert fd.launch_count("fp") + fd.launch_count("int8") == before


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


def _on_card(case, dtype, device):
    """A case's arrays as CUDA tensors: q (and fp pools) in ``dtype``, int8
    pools and their f32 scales as they are."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in case]
    t[0] = t[0].to(dtype)
    if len(t) == 5:
        t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    return t


def _kernel_against_plain(t, dtype):
    """One launch against the plain version evaluated in f32 from the same
    inputs: f32 within 1e-4 rel / 1e-5 abs (another summation order), bf16
    within one bf16 output rounding."""
    before = fd.launch_count()
    got = fd.flash_decode(*t)
    torch.cuda.synchronize()
    assert fd.launch_count() == before + 1
    f32 = [x.float() if x.dtype in (torch.float32, torch.bfloat16) else x
           for x in t]
    ref = fd.torch_paged_decode(*f32)
    tol = 1e-4 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), ref, rtol=tol,
                               atol=1e-5 if dtype == torch.float32 else 8e-3)
    return got


# name -> (slots, n_pages, page_size, heads, head_dim, positions)
KERNEL_CASES = {
    # one slot at the end of a 64-page reservation: a chunk a page
    "long_slot": (1, 64, 16, 12, 64, [1023]),
    # one-page reservations: every slot is a single chunk
    "unsplit": (3, 1, 16, 12, 64, [0, 7, 15]),
    # 32 slots split in 4-page chunks: positions at chunk edges
    "chunk_edges": (32, 64, 16, 12, 64,
                    [-1, 0, 63, 64, 127, 128, 1023] + [100 + 29 * i
                                                        for i in range(25)]),
    # Dh 128, and 25 heads (three head groups: 9, 8 and 8)
    "dh128": (4, 8, 16, 12, 128, [0, 17, 100, 127]),
    "heads25": (3, 4, 16, 25, 64, [5, 40, 63]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_int8_matches_plain_version(cuda_device, dtype):
    """int8 pools with per-page scales, against the plain version computed
    in f32 from the same int8 pages and scales; the dead slot is zero."""
    case = quantized_case(np.random.default_rng(32), slots=5, n_pages=4,
                          page_size=16, n_heads=3, head_dim=64,
                          positions=[-1, 0, 15, 16, 63],
                          table=[[1, 2, 3, 4], [5, 6, 7, 8], [1, 9, 10, 11],
                                 [12, 13, 14, 15], [16, 17, 18, 19]])
    t = _on_card(case, dtype, cuda_device)
    before = fd.launch_count("int8")
    got = _kernel_against_plain(t, dtype)
    assert fd.launch_count("int8") == before + 1
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
@pytest.mark.parametrize("pages", ["bf16", "int8", "f32"])
def test_cuda_kernel_split_unsplit_and_grouped(cuda_device, name, pages):
    """Split and unsplit slots, chunk-edge positions, head groups, over
    bf16, int8 (bf16 q) and f32 pools."""
    slots, n, ps, H, dh, pos = KERNEL_CASES[name]
    kw = dict(slots=slots, n_pages=n, page_size=ps, n_heads=H, head_dim=dh,
              positions=pos)
    rng = np.random.default_rng(33)
    case = quantized_case(rng, **kw) if pages == "int8" else \
        paged_case(rng, **kw)
    dtype = torch.float32 if pages == "f32" else torch.bfloat16
    got = _kernel_against_plain(_on_card(case, dtype, cuda_device), dtype)
    dead = [b for b, p in enumerate(pos) if p < 0]
    assert all(torch.all(got[b] == 0) for b in dead)


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_cuda_kernel_is_deterministic(cuda_device, pages):
    """Chunks are merged in split order, without float atomics: two calls
    on the same inputs are bitwise equal."""
    slots, n, ps, H, dh, pos = KERNEL_CASES["chunk_edges"]
    kw = dict(slots=slots, n_pages=n, page_size=ps, n_heads=H, head_dim=dh,
              positions=pos)
    rng = np.random.default_rng(34)
    case = quantized_case(rng, **kw) if pages == "int8" else \
        paged_case(rng, **kw)
    t = _on_card(case, torch.bfloat16, cuda_device)
    a, b = fd.flash_decode(*t), fd.flash_decode(*t)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
