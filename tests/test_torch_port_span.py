"""The span kernel (``flash_span``, ``ops/csrc/flash_span.cu``) and what
surrounds it.

On the CPU: ``span_plan`` at the serve shape and beside it, the census
``span_hbm_bytes`` against a count made key by key, the seam's routing by
q's dtype (the kernels replaced by recorders, or by the decode kernel's
plain version for the pseudo-slot arithmetic), and the wrapper's refusal of
CPU tensors. On the card (``cuda`` marker, run by
``scripts/run_torch_cuda_tests.py``): the kernel against the plain twin
``torch_paged_span_decode`` evaluated in f32 over bf16 and int8 pages, Dh
64 and 128, L 2, 5 and 17, H 12 and 16, with positions straddling page
edges, clamped duplicates at the end of the reservation, dead links and a
dead slot; one launch on the span kernel's counter and none on the decode
kernel's, and two calls bitwise equal.
"""

import numpy as np
import pytest
import torch

from distributed_pipeline_tpu_torch.ops import flash_decode as fd

H100 = dict(sms=132, smem_optin=232448)


@pytest.mark.parametrize("shape,want", [
    # the serve phase's verify (32 slots x 5 links, H=12, Dh=64, page 16,
    # 64-page reservations): 8-page chunks (two CTAs an SM), one group
    ((32, 5, 12, 64, 16, 64, 2), (12, 1, 1, 2, 8, 8)),
    ((32, 5, 12, 64, 16, 64, 1), (12, 1, 1, 2, 8, 8)),
    # 17 links: two link tiles, so each page is read once per 16 links
    ((32, 17, 12, 64, 16, 64, 2), (12, 1, 2, 2, 13, 5)),
    # 16 heads: two groups of 8 (one warp a head, at most 12 a CTA)
    ((32, 5, 16, 64, 16, 64, 2), (8, 2, 1, 2, 13, 5)),
    # Dh 128 bf16: two stages of whole pages and the scratch of 12 heads
    # pass the card's 227 KB, so two groups of 6 (int8 pages: one group)
    ((32, 5, 12, 128, 16, 64, 2), (6, 2, 1, 2, 13, 5)),
    ((32, 5, 12, 128, 16, 64, 1), (12, 1, 1, 2, 8, 8)),
    # one slot: one-page chunks would leave the combine's weights no room
    ((1, 5, 12, 64, 16, 64, 2), (12, 1, 1, 2, 2, 32)),
], ids=["serve_bf16", "serve_int8", "L17", "H16", "dh128", "dh128_int8",
        "one_slot"])
def test_span_plan(shape, want):
    plan = fd.span_plan(*shape, **H100)
    assert (plan.group_heads, plan.groups, plan.link_tiles, plan.stages,
            plan.pages_per_chunk, plan.max_splits) == want
    assert plan.pages_per_chunk * plan.max_splits >= shape[5]
    assert plan.smem_bytes <= H100["smem_optin"]
    # the combine's per-head m, l and sums fit in the idle tiles
    tile = shape[4] * plan.group_heads * shape[3] * shape[6]
    assert plan.group_heads * (32 * plan.max_splits + 16) * 4 \
        <= plan.stages * 2 * tile


def test_span_plan_chunks_at_the_serve_shape():
    """At the serve shape the span reads 8-page chunks: half the
    pseudo-slot plan's 16-page chunks over 160 slots, twice the decode
    step's 4 (the span kernel runs one CTA an SM where the decode kernel
    runs two)."""
    for kv_bytes in (2, 1):
        span = fd.span_plan(32, 5, 12, 64, 16, 64, kv_bytes, **H100)
        step = fd.decode_plan(32, 12, 64, 16, 64, kv_bytes, **H100)
        pseudo = fd.decode_plan(160, 12, 64, 16, 64, kv_bytes, **H100)
        assert (step.pages_per_chunk, span.pages_per_chunk,
                pseudo.pages_per_chunk) == (4, 8, 16)


def test_span_plan_raises_where_no_head_group_fits():
    with pytest.raises(ValueError, match="shared memory"):
        fd.span_plan(4, 5, 12, 128, 256, 4, 4, **H100)


def _brute_force_bytes(bt, pos, ps, H, Dh, dtype_bytes, quantized):
    """Key by key: every page a live key of some link sits in (once), q and
    out of every link, each slot's block-table entries up to its farthest
    link's page, a position a link, the scales of those entries."""
    B, n = bt.shape
    L = pos.shape[1]
    elem = 1 if quantized else dtype_bytes
    pages, entries = set(), 0
    for b in range(B):
        reach = -1
        for j in range(L):
            for key in range(min(int(pos[b, j]) + 1, n * ps)):
                pages.add(int(bt[b, key // ps]))
                reach = max(reach, key // ps)
        entries += reach + 1
    total = len(pages) * 2 * ps * H * Dh * elem
    total += B * L * 2 * H * Dh * dtype_bytes
    total += entries * 4 + B * L * 4
    if quantized:
        total += entries * 8
    return total


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("seed", range(3))
def test_span_hbm_bytes_matches_brute_force(seed, quantized):
    rng = np.random.default_rng(seed)
    B, n, L, ps, H, Dh = 5, 6, 4, 4, 3, 8
    bt = rng.integers(1, 12, (B, n)).astype(np.int32)   # shared pages
    start = rng.integers(-3, n * ps, (B,))
    start[0] = -5                                       # a dead slot
    pos = np.minimum(start[:, None] + np.arange(L)[None, :],
                     n * ps - 1).astype(np.int32)       # clamped links
    got = fd.span_hbm_bytes(bt, pos, ps, H, Dh, dtype_bytes=2,
                            quantized=quantized)
    assert got == _brute_force_bytes(bt, pos, ps, H, Dh, 2, quantized)


def test_span_hbm_bytes_reads_pages_once_for_all_links():
    """The pseudo-slot census over the repeated table counts each slot's
    entries once per link; the span kernel's census counts them once."""
    bt = np.arange(1, 1 + 2 * 4, dtype=np.int32).reshape(2, 4)
    pos = np.asarray([[20, 21, 22], [5, 6, 7]], np.int32)
    ps, H, Dh, L = 8, 2, 8, 3
    span = fd.span_hbm_bytes(bt, pos, ps, H, Dh, dtype_bytes=2)
    pseudo = fd.decode_hbm_bytes(np.repeat(bt, L, axis=0), pos.reshape(-1),
                                 ps, H, Dh, dtype_bytes=2, step_table=False)
    # 3 + 1 live entries read once instead of once a link
    assert pseudo - span == (3 + 1) * (L - 1) * 4


def _span_case(rng, B, L, H, Dh, ps, n, quantized):
    """Seeded q, pools and a block table of distinct pages; slot 0 dead,
    slot 1's first links dead, slot 2 straddling a page edge, slot 3
    clamped at the reservation's end (duplicate positions), the rest at
    random depths."""
    P = 1 + B * n
    q = rng.standard_normal((B, H, L, Dh)).astype(np.float32)
    pools = [rng.standard_normal((P, ps, H, Dh)).astype(np.float32)
             for _ in range(2)]
    table = (1 + np.arange(B * n)).reshape(B, n).astype(np.int32)
    start = rng.integers(0, n * ps, (B,))
    special = [-L - 1, -2, ps - 2, n * ps - 3][:B]
    start[:len(special)] = special
    pos = np.minimum(start[:, None] + np.arange(L)[None, :],
                     n * ps - 1).astype(np.int32)
    if not quantized:
        return q, pools, table, pos, []
    scales = [np.abs(p).max(axis=(1, 2, 3)) / 127.0 for p in pools]
    q8 = [np.clip(np.round(p / s[:, None, None, None]), -127, 127)
          .astype(np.int8) for p, s in zip(pools, scales)]
    return q, q8, table, pos, [s.astype(np.float32) for s in scales]


class _Recorder:
    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, q, *args):
        self.calls.append((self.name, q.dtype))
        return torch.zeros_like(q)


def test_span_seam_routes_by_dtype(monkeypatch):
    """On CUDA tensors the seam sends bf16 q to the span kernel and f32 q
    to the pseudo-slot route, and counts one seam launch either way (the
    kernels and the device check replaced by recorders here)."""
    calls = []
    monkeypatch.setattr(fd, "resolve_decode_impl", lambda impl, dev: "cuda")
    monkeypatch.setattr(fd, "flash_span", _Recorder("flash_span", calls))
    monkeypatch.setattr(fd, "pseudo_slot_span",
                        _Recorder("pseudo_slot_span", calls))
    q, pools, table, pos, _ = _span_case(np.random.default_rng(0), 2, 3, 2,
                                         8, 4, 3, False)
    fd.reset_launch_count()
    for dt in (torch.bfloat16, torch.float32):
        fd.paged_span_attention(torch.from_numpy(q).to(dt),
                                *[torch.from_numpy(p).to(dt) for p in pools],
                                torch.from_numpy(table), torch.from_numpy(pos))
    assert calls == [("flash_span", torch.bfloat16),
                     ("pseudo_slot_span", torch.float32)]
    assert fd.span_launch_count() == 2


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_pseudo_slot_span_is_the_per_link_decode(monkeypatch, quantized):
    """The f32 route's pseudo-slot arithmetic (q and positions flattened,
    the table repeated per link) with the decode kernel's plain version in
    its place gives the plain twin bitwise."""
    monkeypatch.setattr(fd, "flash_decode", fd.torch_paged_decode)
    q, pools, table, pos, scales = _span_case(np.random.default_rng(1), 5,
                                              4, 2, 8, 4, 3, quantized)
    t = [torch.from_numpy(a) for a in (q, *pools, table, pos, *scales)]
    got = fd.pseudo_slot_span(*t)
    assert got.shape == t[0].shape
    assert torch.equal(got, fd.torch_paged_span_decode(*t))


def test_flash_span_takes_cuda_tensors_only():
    q, pools, table, pos, _ = _span_case(np.random.default_rng(2), 2, 3, 2,
                                         64, 16, 2, False)
    t = [torch.from_numpy(a) for a in (q, *pools, table, pos)]
    fd.reset_launch_count()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fd.flash_span(t[0].bfloat16(), t[1].bfloat16(), t[2].bfloat16(),
                      *t[3:])
    with pytest.raises(ValueError, match="CUDA tensors"):
        fd.paged_span_attention(t[0].bfloat16(), t[1].bfloat16(),
                                t[2].bfloat16(), *t[3:], impl="cuda")
    assert fd.span_kernel_launch_count() == fd.span_launch_count() == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(case, device):
    """bf16 q and pools (int8 pools as they are) on the card, and the same
    inputs in f32 for the plain twin."""
    q, pools, table, pos, scales = case
    qb = torch.from_numpy(q).to(device, torch.bfloat16)
    if scales:
        pk, pv = (torch.from_numpy(p).to(device) for p in pools)
    else:
        pk, pv = (torch.from_numpy(p).to(device, torch.bfloat16)
                  for p in pools)
    rest = [torch.from_numpy(a).to(device) for a in (table, pos, *scales)]
    f32 = [qb.float(), pk if scales else pk.float(),
           pv if scales else pv.float(), *rest]
    return [qb, pk, pv, *rest], f32


@pytest.mark.cuda
@pytest.mark.parametrize("H", [12, 16])
@pytest.mark.parametrize("L", [2, 5, 17])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_cuda_span_kernel_matches_plain_twin(cuda_device, quantized, Dh, L,
                                             H):
    """The span kernel against the plain twin evaluated in f32 from the
    same bf16 (or int8) inputs: within one bf16 rounding of the output and
    of P (8e-3 rel and abs, the decode kernel's bar); dead links zero; one
    launch on the span kernel's counter and none on the decode kernel's;
    two calls bitwise equal. 6 slots of 8-page reservations (page 16): a
    chunk a page, so the multi-chunk combine runs."""
    case = _span_case(np.random.default_rng(L * 100 + Dh + H), 6, L, H, Dh,
                      16, 8, quantized)
    args, f32 = _on_card(case, cuda_device)
    fd.reset_launch_count()
    got = fd.paged_span_attention(*args[:5], impl="cuda",
                                  scales_k=(args[5:] or [None])[0],
                                  scales_v=(args[6:] or [None])[0])
    torch.cuda.synchronize()
    kind = "int8" if quantized else "fp"
    assert fd.span_kernel_launch_count(kind) == fd.span_launch_count() == 1
    assert fd.launch_count() == 0
    ref = fd.torch_paged_span_decode(*f32)
    torch.testing.assert_close(got.float(), ref, rtol=8e-3, atol=8e-3)
    dead = torch.from_numpy(case[3] < 0).to(cuda_device)    # [B, L]
    assert torch.all(got.float().transpose(1, 2)[dead] == 0)
    again = fd.flash_span(*args)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_cuda_span_kernel_odd_page_size(cuda_device, quantized):
    """Page size 8: a 16-key block holds the page's 8 rows and 8 zeroed
    ones; 5 slots of 64-page reservations, 2-page chunks merged by the
    combine."""
    case = _span_case(np.random.default_rng(9), 5, 5, 12, 64, 8, 64,
                      quantized)
    args, f32 = _on_card(case, cuda_device)
    got = fd.flash_span(*args)
    torch.testing.assert_close(got.float(), fd.torch_paged_span_decode(*f32),
                               rtol=8e-3, atol=8e-3)


@pytest.mark.cuda
def test_cuda_span_f32_takes_the_pseudo_slot_route(cuda_device):
    """f32 q keeps the decode kernel over pseudo-slots (the strict bar:
    1e-4 rel, 1e-5 abs): B*L is one decode launch, none of the span
    kernel's."""
    q, pools, table, pos, _ = _span_case(np.random.default_rng(3), 6, 5, 12,
                                         64, 16, 8, False)
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (q, *pools, table, pos)]
    fd.reset_launch_count()
    got = fd.paged_span_attention(*t, impl="cuda")
    torch.cuda.synchronize()
    assert fd.launch_count("fp") == fd.span_launch_count() == 1
    assert fd.span_kernel_launch_count() == 0
    torch.testing.assert_close(got, fd.torch_paged_span_decode(*t),
                               rtol=1e-4, atol=1e-5)
