// Paged span attention for Hopper (sm_90a): the speculative-verify step,
// where each slot attends a chain of L links (the current token and its K
// draft tokens) at once, link j over keys <= positions[b, j], read straight
// from the paged KV pool through the slot's block table, over bf16 pages or
// int8 pages with per-page f32 scales.
//
// Replaces the TPU kernel distributed_pipeline_tpu/ops/flash_decode.py:328
// `paged_span_attention`, which runs `_decode_kernel` over B*L pseudo-slots
// (link j of slot b a slot of its own with b's block-table row). That
// schedule reads each of a slot's pages L times, once for every link, and
// folds each copy for one query row. Here one CTA reads each page once for
// up to 16 links.
//
// What bounds it: bytes. At L = 5 links, bf16 pages and Dh = 64 a page row
// of one head (128 bytes of K and 128 of V) meets 5 query rows: about 20
// flops per byte, far below the ~295 flop/byte at which the H100's tensor
// cores would be the limit. The design reads every live page once and
// keeps the page reads at the card's rate; the tensor cores are there only
// so that 16 query rows cost no more issue slots than one. The census is
// `span_hbm_bytes` in ops/flash_decode.py.
//
// * Grid and plan. The static grid is [B, max_splits, head groups x link
//   tiles], sized on the host from shapes alone (`span_plan`): the wrapper
//   never reads the positions. CTA (b, c, g, t) takes links [16t, 16t+16)
//   of slot b, heads of group g, and pages [c * ppc, (c + 1) * ppc) of the
//   live range, which reaches the largest position of its links; it exits
//   at once if that chunk is empty. Chunk-major order dispatches every
//   slot's first chunks first. A CTA runs alone on its SM (below), so the
//   plan aims at two CTAs an SM: 8-page chunks at the serve shape, which
//   measured faster than 4 or 16 (scripts/profile_torch_span.py).
// * Producer. One warp fetches each live page's K and V, each one
//   `cp.async.bulk` of the page as it lies (a head group: one per token
//   row), into a 2-stage ring behind full/empty mbarriers, int8 scales
//   published with the stage's second arrival (as the decode kernel).
// * Repack. Each consumer warp copies its head's 16-row block of K and V
//   into its own scratch, as bf16 (int8 converted exactly) and with every
//   row padded by 16 bytes, then releases the stage. A page row of 12
//   heads x 64 bf16 is 1536 bytes, so in the stage the 8 key rows of an
//   ldmatrix would sit on the same banks (8-way conflicts); in the scratch
//   they do not. One copy a page instead of one a token row measured 3 us
//   faster, and the ring refills before the block's MMAs.
// * Consumers on tensor cores. One warp a head runs mma.sync m16n8k16 bf16
//   with the links as the M rows (padded to 16: wgmma's 64-row minimum
//   would waste 59 of 64 rows at L = 5). S = Q K^T over a 16-key block is 2
//   n-tiles x Dh/16 k-steps in f32 (K by ldmatrix); the per-link mask key
//   <= positions[b, j] goes on the score fragment; the online softmax is
//   f32, log2 domain, per row; P is rounded to bf16 for P V (V by
//   ldmatrix.trans, Dh/8 n-tiles). For int8 pages the k scale folds into
//   S and the v scale into P before rounding.
// * Combine. A link tile with one chunk writes its output directly.
//   Otherwise each chunk writes (m, l, acc) in f32 to a workspace, takes a
//   ticket, and the tile's last chunk sums every chunk in split order (and
//   resets the ticket). No float atomics: two calls are bitwise equal.
//
// Layouts (all contiguous, as the wrapper checks):
//   q            [B, H, L, Dh]             bf16
//   pages_k/v    [P, page_size, H, Dh]     bf16, or int8 with
//   scales_k/v   [P]                       f32 (int8 pools only)
//   block_table  [B, n_pages]              int32
//   positions    [B, L]                    int32 (pos < 0: zeros)
//   out          [B, H, L, Dh]             bf16
//   ws_acc       [B, max_splits, L, H, Dh] f32 workspace (max_splits > 1)
//   ws_ml        [2, B, max_splits, L, H]  f32 workspace (max_splits > 1)
//   tickets      [B * groups * link_tiles] int32, zero between calls
// Dh is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_pipeline.cuh"

namespace {

constexpr int kMaxGroupHeads = 12;
constexpr int kMaxThreads = 32 * (kMaxGroupHeads + 1);  // + one producer
constexpr int kLinkTile = 16;  // links a CTA takes: the MMA's M rows
constexpr int kKeyBlock = 16;  // keys a P V step folds: the MMA's K depth
constexpr int kPad = 16;       // bytes after every row of a warp's scratch
constexpr float kLog2e = 1.4426950408889634f;

// Four 8x8 tiles of 16-bit elements; lane i gives the address of row i % 8
// of tile i / 8. Without .trans lane t receives (row t/4, cols 2(t%4) and
// 2(t%4)+1) of each tile, with .trans (rows 2(t%4) and 2(t%4)+1, col t/4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b: a 16x16 bf16 (rows g and g+8, k 2c.. and 2c+8.. of lane
// 4g + c), b 16x8 bf16 (k 2c.. and 2c+8.., col g), d 16x8 f32 (rows g and
// g+8, cols 2c and 2c+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 int8 -> 16 bf16 (exact): each byte biased to b + 128, placed as the
// low mantissa byte of 2^23, 2^23 + 128 subtracted; |b| <= 128 has at most
// 8 significant bits, so the f32's upper half is the bf16, and a byte
// permute packs two of them.
__device__ __forceinline__ void int8x16_to_bf16(const uint4& u,
                                                uint4 (&o)[2]) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __float_as_uint(
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u + j)) -
          8388736.f);
    r[2 * i] = __byte_perm(f[0], f[1], 0x7632u);
    r[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632u);
  }
  o[0] = make_uint4(r[0], r[1], r[2], r[3]);
  o[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// Shared memory of one CTA: `stages` x (K tile, V tile), each the page's
// page_size token rows of group_heads * Dh KV as they lie in the pool;
// a bf16 scratch of 2 x 16 rows (K, V), each padded by kPad bytes, a
// consumer warp; then the full and empty barriers, the stages' scales and
// the last-chunk flag. Mirrored by `_span_smem_bytes` in
// ops/flash_decode.py. The combine reuses the tiles for its per-warp
// [16, max_splits] weights.
__host__ __device__ __forceinline__ size_t span_tile_bytes(int page_size,
                                                           int heads, int dh,
                                                           int kv_bytes) {
  return (size_t)page_size * heads * dh * kv_bytes;
}

__host__ __device__ __forceinline__ size_t span_scratch_bytes(int heads,
                                                              int dh) {
  return (size_t)heads * 2 * kKeyBlock * (2 * dh + kPad);
}

__host__ __device__ __forceinline__ size_t span_smem_bytes(int stages,
                                                           size_t tile,
                                                           size_t scratch) {
  return stages * (2 * tile + 24) + scratch + 16;
}

// The combine's per-warp floats: m (then the weights) and l of 16 links x
// max_splits chunks, and 16 reciprocal sums.
__host__ __device__ __forceinline__ size_t combine_floats(int max_splits) {
  return (size_t)2 * kLinkTile * max_splits + kLinkTile;
}

// One CTA per (slot, chunk, head group x link tile); blockDim = 32 *
// (group_heads + 1): consumer warp w folds head h0 + w, the last warp
// produces. One CTA an SM: capped at 72 registers for two, the Dh = 64
// consumers spill, and measured slower (scripts/profile_torch_span.py).
template <typename KV, int DH>
__global__ void __launch_bounds__(kMaxThreads, 1)
flash_span_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                       const KV* __restrict__ pages_k,
                       const KV* __restrict__ pages_v,
                       const float* __restrict__ scales_k,
                       const float* __restrict__ scales_v,
                       const int* __restrict__ block_table,
                       const int* __restrict__ positions,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       int* __restrict__ tickets, int B, int H, int L,
                       int page_size, int n_pages, int group_heads,
                       int stages, int pages_per_chunk, int max_splits,
                       int link_tiles, float qk_scale) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  constexpr int KS = DH / 16;  // k-steps of Q K^T
  constexpr int NT = DH / 8;   // n-tiles of P V
  constexpr int kSPitch = 2 * DH + kPad;  // bytes a scratch row (bf16)

  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const int g = blockIdx.z / link_tiles;
  const int j0 = (blockIdx.z % link_tiles) * kLinkTile;  // first link
  const int links = min(kLinkTile, L - j0);
  const int first = chunk * pages_per_chunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // lane i < links holds link j0 + i's position; the producer reads its
  // chunk's first 32 block-table entries alongside
  const int my_pos = lane < links ? positions[(long long)b * L + j0 + lane]
                                  : -1;
  int my_page = 0;
  if (warp == group_heads && lane < pages_per_chunk && first + lane < n_pages)
    my_page = block_table[(long long)b * n_pages + first + lane];
  int max_pos = my_pos;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    max_pos = max(max_pos, __shfl_xor_sync(0xffffffffu, max_pos, off));
  // floor division: pos = -1 has no live page (C division truncates)
  const int n_live = max_pos < 0 ? 0 : min(max_pos / page_size + 1, n_pages);
  // a tile with no live page still has one chunk: it writes the zeros
  const int n_chunks = max(1, (n_live + pages_per_chunk - 1) / pages_per_chunk);
  if (chunk >= n_chunks) return;
  const int count = max(0, min(n_live - first, pages_per_chunk));
  const int h0 = g * group_heads;
  const int heads = min(group_heads, H - h0);  // this CTA's heads

  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t row_bytes = (uint32_t)(heads * DH * sizeof(KV));
  const size_t tile_alloc =
      span_tile_bytes(page_size, group_heads, DH, sizeof(KV));
  uint8_t* scratch = smem + stages * 2 * tile_alloc;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      scratch + span_scratch_bytes(group_heads, DH));
  uint64_t* empty = full + stages;
  float2* stage_scales = reinterpret_cast<float2*>(empty + stages);
  int* last_flag = reinterpret_cast<int*>(stage_scales + stages);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // two arrivals: the copies' (with their bytes) and the scales'
      mbar_init(&full[s], 2);
      mbar_init(&empty[s], heads);  // lane 0 of each working consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long row_elems = (long long)H * DH;
  const long long page_elems = (long long)page_size * row_elems;

  if (warp == group_heads) {
    // ---- producer: page ids (and scales) 32 at a time, then the copies ----
    for (int p0 = 0; p0 < count; p0 += 32) {
      if (p0 > 0 && p0 + lane < count)
        my_page = block_table[(long long)b * n_pages + first + p0 + lane];
      float my_sk = 1.f, my_sv = 1.f;
      if (kInt8 && p0 + lane < count) {
        my_sk = scales_k[my_page];
        my_sv = scales_v[my_page];
      }
      const int m = min(32, count - p0);
      for (int u = 0; u < m; ++u) {
        const int j = p0 + u;
        const int s = j % stages;
        const long long page = __shfl_sync(0xffffffffu, my_page, u);
        mbar_wait(&empty[s], ((j / stages) & 1) ^ 1);
        uint8_t* dk = smem + (size_t)s * 2 * tile_alloc;
        uint8_t* dv = dk + tile_alloc;
        if (lane == 0)
          mbar_arrive_expect_tx(&full[s], 2u * page_size * row_bytes);
        __syncwarp();
        const KV* src_k = pages_k + page * page_elems + (long long)h0 * DH;
        const KV* src_v = pages_v + page * page_elems + (long long)h0 * DH;
        if (heads == H) {  // the page is one block, as it lies
          if (lane == 0) {
            bulk_load(dk, src_k, page_size * row_bytes, &full[s]);
            bulk_load(dv, src_v, page_size * row_bytes, &full[s]);
          }
        } else {  // a head group: one copy per token row
          for (int t = lane; t < page_size; t += 32) {
            bulk_load(dk + (size_t)t * row_bytes, src_k + t * row_elems,
                      row_bytes, &full[s]);
            bulk_load(dv + (size_t)t * row_bytes, src_v + t * row_elems,
                      row_bytes, &full[s]);
          }
        }
        // the page's own lane publishes its scales (the arrive releases
        // them), so no instruction before the copies waits for their load
        if (lane == u) {
          stage_scales[s] = make_float2(my_sk, my_sv);
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  if (warp >= heads) return;  // the last group may hold fewer heads

  // ---- consumer warp: head h, links j0.., this chunk's pages ----
  const int h = h0 + warp;
  const int gq = lane / 4;  // fragment row (link) gq and gq + 8
  const int cq = lane % 4;  // fragment column pair
  const int pos_lo = __shfl_sync(0xffffffffu, my_pos, gq);
  const int pos_hi = __shfl_sync(0xffffffffu, my_pos, gq + 8);
  // Q's A fragments for every k-step (zero rows past the tile's links)
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* qh = q + (((long long)b * H + h) * L + j0) * DH;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int col = 16 * ks + 2 * cq;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = gq + 8 * (r & 1);
        qa[ks][r] = row < links ? *reinterpret_cast<const uint32_t*>(
                                      qh + row * DH + col + 8 * (r >> 1))
                                : 0u;
      }
    }
  }
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  // ldmatrix addressing: lane i points at row i % 8 of tile i / 8. K tiles
  // (keys 0-7 | 8-15) x (dh +0 | +8) give b0, b1 of the two key n-tiles;
  // V tiles (keys 0-7 | 8-15) x (dh +0 | +8), transposed, give b0, b1 of
  // two dh n-tiles.
  const int mi = lane / 8;
  const int k_row = (mi >> 1) * 8 + lane % 8, k_col = (mi & 1) * 8;
  const int v_row = (mi & 1) * 8 + lane % 8, v_col = (mi >> 1) * 8;
  const int hoff = warp * DH * (int)sizeof(KV);  // head's bytes in a row
  uint8_t* sck = scratch + (size_t)warp * 2 * kKeyBlock * kSPitch;
  uint8_t* scv = sck + kKeyBlock * kSPitch;

  for (int j = 0; j < count; ++j) {
    const int s = j % stages;
    mbar_wait(&full[s], (j / stages) & 1);
    const uint8_t* kt = smem + (size_t)s * 2 * tile_alloc;
    const uint8_t* vt = kt + tile_alloc;
    float sk = 1.f, sv = 1.f;
    if (kInt8) {
      const float2 sc = stage_scales[s];
      sk = sc.x;
      sv = sc.y;
    }
    const float scale = qk_scale * sk;
    const int key0 = (first + j) * page_size;
    for (int kb = 0; kb < page_size && key0 + kb <= max_pos; kb += kKeyBlock) {
      // this head's 16 rows of K and V into the warp's padded scratch, as
      // bf16 (int8 converted exactly); rows past the page are zeros
      constexpr int CPR = DH * (int)sizeof(KV) / 16;  // 16-byte chunks a row
      constexpr int OUT = 32 / (int)sizeof(KV);  // scratch bytes a chunk
#pragma unroll
      for (int i = lane; i < kKeyBlock * CPR; i += 32) {
        const int r = i / CPR, cc = i % CPR;
        uint4 ko[OUT / 16], vo[OUT / 16];
        if (kb + r < page_size) {
          const size_t at = (size_t)(kb + r) * row_bytes + hoff + cc * 16;
          const uint4 k16 = *reinterpret_cast<const uint4*>(kt + at);
          const uint4 v16 = *reinterpret_cast<const uint4*>(vt + at);
          if constexpr (kInt8) {
            int8x16_to_bf16(k16, ko);
            int8x16_to_bf16(v16, vo);
          } else {
            ko[0] = k16;
            vo[0] = v16;
          }
        } else {
#pragma unroll
          for (int u = 0; u < OUT / 16; ++u)
            ko[u] = vo[u] = make_uint4(0u, 0u, 0u, 0u);
        }
        uint4* dk = reinterpret_cast<uint4*>(sck + r * kSPitch + cc * OUT);
        uint4* dv = reinterpret_cast<uint4*>(scv + r * kSPitch + cc * OUT);
#pragma unroll
        for (int u = 0; u < OUT / 16; ++u) {
          dk[u] = ko[u];
          dv[u] = vo[u];
        }
      }
      __syncwarp();
      // the page's last block is in the scratch: the stage can refill
      if (lane == 0 && (kb + kKeyBlock >= page_size ||
                        key0 + kb + kKeyBlock > max_pos))
        mbar_arrive(&empty[s]);

      // S = Q K^T over 16 keys: sacc[n-tile][rows lo/hi x 2 keys]
      float sacc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4];
        ldsm_x4(kf, sck + k_row * kSPitch + (16 * ks + k_col) * 2);
        mma_bf16(sacc[0], qa[ks], kf[0], kf[1]);
        mma_bf16(sacc[1], qa[ks], kf[2], kf[3]);
      }
      // scale into the log2 domain and mask per link: key <= position
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = kb + 8 * nt + 2 * cq + (e & 1);  // row in the page
          const bool live =
              t < page_size && key0 + t <= (e < 2 ? pos_lo : pos_hi);
          sacc[nt][e] = live ? sacc[nt][e] * scale : -INFINITY;
          if (e < 2)
            mx_lo = fmaxf(mx_lo, sacc[nt][e]);
          else
            mx_hi = fmaxf(mx_hi, sacc[nt][e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // a row with no live key so far keeps m = -inf: subtract 0 instead
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float a_lo = exp2f(m_lo - mu_lo), a_hi = exp2f(m_hi - mu_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float p[2][4];
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[nt][e] = exp2f(sacc[nt][e] - (e < 2 ? mu_lo : mu_hi));
          if (e < 2)
            sum_lo += p[nt][e];
          else
            sum_hi += p[nt][e];
        }
      // l stays a per-lane partial (the quad's alpha is common)
      l_lo = fmaf(l_lo, a_lo, sum_lo);
      l_hi = fmaf(l_hi, a_hi, sum_hi);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= e < 2 ? a_lo : a_hi;
      // P (v scale folded in) as the A fragment of P V, rounded to bf16
      const uint32_t pa[4] = {pack_bf16(p[0][0] * sv, p[0][1] * sv),
                              pack_bf16(p[0][2] * sv, p[0][3] * sv),
                              pack_bf16(p[1][0] * sv, p[1][1] * sv),
                              pack_bf16(p[1][2] * sv, p[1][3] * sv)};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, scv + v_row * kSPitch + (16 * np + v_col) * 2);
        mma_bf16(o[2 * np], pa, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
      }
      __syncwarp();  // the next block rewrites the scratch
    }
  }

  // the quad's lanes hold partial sums over their own columns
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const int row_lo = gq, row_hi = gq + 8;

  if (n_chunks == 1) {
    // a link with no live key has l == 0 and acc == 0: zeros, not NaN
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-20f);
    const float inv_hi = 1.f / fmaxf(l_hi, 1e-20f);
    __nv_bfloat16* ob = out + (((long long)b * H + h) * L + j0) * DH + 2 * cq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (row_lo < links)
        *reinterpret_cast<uint32_t*>(ob + row_lo * DH + 8 * nt) =
            pack_bf16(o[nt][0] * inv_lo, o[nt][1] * inv_lo);
      if (row_hi < links)
        *reinterpret_cast<uint32_t*>(ob + row_hi * DH + 8 * nt) =
            pack_bf16(o[nt][2] * inv_hi, o[nt][3] * inv_hi);
    }
    return;
  }

  // ---- several chunks: partials to the workspace, then a ticket ----
  const long long ml_plane = (long long)B * max_splits * L * H;
  const long long split_row = ((long long)b * max_splits + chunk) * L + j0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_hi : row_lo;
    if (row < links) {
      const long long hrow = (split_row + row) * H + h;
      float* dst = ws_acc + hrow * DH + 2 * cq;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(dst + 8 * nt) =
            make_float2(o[nt][2 * half], o[nt][2 * half + 1]);
      if (cq == 0) {
        ws_ml[hrow] = half ? m_hi : m_lo;
        ws_ml[ml_plane + hrow] = half ? l_hi : l_lo;
      }
    }
  }
  __threadfence();
  named_sync(1, 32 * heads);
  if (threadIdx.x == 0) {
    int* ticket = tickets + (long long)b * gridDim.z + blockIdx.z;
    const int taken = atomicAdd(ticket, 1);
    *last_flag = taken == n_chunks - 1;
    if (taken == n_chunks - 1) *ticket = 0;  // ready for the next call
  }
  named_sync(1, 32 * heads);
  if (!*last_flag) return;
  __threadfence();

  // ---- the tile's last chunk merges every chunk in split order ----
  // Per warp (head h), in the idle tiles: w[16][max_splits] (each chunk's
  // m, then its weight exp2(m_k - max m)), lsum[16][max_splits], inv[16].
  // Lane p sums float4 column p % (DH/4) of link p / (DH/4) (and p + 32,
  // p + 64: kU columns) over the chunks, kG chunks at a time; the first
  // group's loads are issued before the weights are known, so they share a
  // trip to L2 with the m and l loads.
  constexpr int C4 = DH / 4;
  constexpr int kU = 3, kG = 4;
  float* w = reinterpret_cast<float*>(smem) + warp * combine_floats(max_splits);
  float* lsum = w + kLinkTile * max_splits;
  float* inv = lsum + kLinkTile * max_splits;
  const float* ws_l = ws_ml + ml_plane;
  const long long slot_row = (long long)b * max_splits * L + j0;  // chunk 0
  const long long k_stride = (long long)L * H * DH;  // one chunk further
  const int n_cols = links * C4;
  float4 a[kU][kG];
  auto load_group = [&](int p0, int k0) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int p = p0 + 32 * u, k = k0 + g;
        a[u][g] = p < n_cols && k < n_chunks
                      ? __ldcg(reinterpret_cast<const float4*>(
                            ws_acc + ((slot_row + p / C4) * H + h) * DH +
                            (p % C4) * 4 + k * k_stride))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
  };
  load_group(lane, 0);
  for (int p = lane; p < links * n_chunks; p += 32) {
    const int i = p / n_chunks, k = p % n_chunks;
    const long long hrow = (slot_row + (long long)k * L + i) * H + h;
    w[i * max_splits + k] = __ldcg(ws_ml + hrow);
    lsum[i * max_splits + k] = __ldcg(ws_l + hrow);
  }
  __syncwarp();
  if (lane < links) {
    float* wi = w + lane * max_splits;
    const float* li = lsum + lane * max_splits;
    float mmax = -INFINITY;
    for (int k = 0; k < n_chunks; ++k) mmax = fmaxf(mmax, wi[k]);
    const float mu = mmax == -INFINITY ? 0.f : mmax;  // a dead link
    float l = 0.f;
    for (int k = 0; k < n_chunks; ++k) {
      wi[k] = exp2f(wi[k] - mu);
      l = fmaf(wi[k], li[k], l);
    }
    inv[lane] = 1.f / fmaxf(l, 1e-20f);
  }
  __syncwarp();
  for (int p0 = lane; p0 < n_cols; p0 += 32 * kU) {
    float4 acc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < n_chunks; k0 += kG) {
      if (p0 != lane || k0 != 0) load_group(p0, k0);
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int p = p0 + 32 * u, k = k0 + g;
          const float wk =
              p < n_cols && k < n_chunks ? w[(p / C4) * max_splits + k] : 0.f;
          acc[u].x = fmaf(wk, a[u][g].x, acc[u].x);
          acc[u].y = fmaf(wk, a[u][g].y, acc[u].y);
          acc[u].z = fmaf(wk, a[u][g].z, acc[u].z);
          acc[u].w = fmaf(wk, a[u][g].w, acc[u].w);
        }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = p0 + 32 * u;
      if (p < n_cols) {
        const float r = inv[p / C4];
        *reinterpret_cast<uint2*>(
            out + (((long long)b * H + h) * L + j0 + p / C4) * DH +
            (p % C4) * 4) = make_uint2(pack_bf16(acc[u].x * r, acc[u].y * r),
                                       pack_bf16(acc[u].z * r, acc[u].w * r));
      }
    }
  }
}

template <typename KV, int DH>
cudaError_t launch(const void* q, const void* pages_k, const void* pages_v,
                   const float* scales_k, const float* scales_v,
                   const int* block_table, const int* positions, void* out,
                   float* ws_acc, float* ws_ml, int* tickets, int B, int H,
                   int L, int page_size, int n_pages, int group_heads,
                   int stages, int pages_per_chunk, int max_splits,
                   cudaStream_t stream) {
  auto kernel = flash_span_sm90_kernel<KV, DH>;
  static int optin = 0;  // once per instantiation (per process)
  if (optin == 0) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) {
      optin = 0;
      return err;
    }
  }
  const int kv = (int)sizeof(KV);
  const size_t tile = span_tile_bytes(page_size, group_heads, DH, kv);
  const size_t smem =
      span_smem_bytes(stages, tile, span_scratch_bytes(group_heads, DH));
  const int link_tiles = (L + kLinkTile - 1) / kLinkTile;
  const long long gz =
      (long long)((H + group_heads - 1) / group_heads) * link_tiles;
  if (smem > (size_t)optin || group_heads < 1 ||
      group_heads > kMaxGroupHeads || stages < 1 || pages_per_chunk < 1 ||
      max_splits < 1 || max_splits > 65535 || gz > 65535 ||
      (long long)max_splits * pages_per_chunk < n_pages ||
      (size_t)group_heads * combine_floats(max_splits) * sizeof(float) >
          (size_t)stages * 2 * tile)
    return cudaErrorInvalidValue;
  const dim3 grid(B, max_splits, (unsigned)gz);
  kernel<<<grid, 32 * (group_heads + 1), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(pages_k),
      static_cast<const KV*>(pages_v), scales_k, scales_v, block_table,
      positions, static_cast<__nv_bfloat16*>(out), ws_acc, ws_ml, tickets, B,
      H, L, page_size, n_pages, group_heads, stages, pages_per_chunk,
      max_splits, link_tiles, kLog2e / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_dh(int head_dim, const void* q, const void* pages_k,
                      const void* pages_v, const float* scales_k,
                      const float* scales_v, const int* block_table,
                      const int* positions, void* out, float* ws_acc,
                      float* ws_ml, int* tickets, int B, int H, int L,
                      int page_size, int n_pages, int group_heads, int stages,
                      int pages_per_chunk, int max_splits,
                      cudaStream_t stream) {
  if (head_dim == 64)
    return launch<KV, 64>(q, pages_k, pages_v, scales_k, scales_v,
                          block_table, positions, out, ws_acc, ws_ml, tickets,
                          B, H, L, page_size, n_pages, group_heads, stages,
                          pages_per_chunk, max_splits, stream);
  if (head_dim == 128)
    return launch<KV, 128>(q, pages_k, pages_v, scales_k, scales_v,
                           block_table, positions, out, ws_acc, ws_ml,
                           tickets, B, H, L, page_size, n_pages, group_heads,
                           stages, pages_per_chunk, max_splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q and out are bfloat16; kv_int8: 0 = bf16 pools, 1 = int8 pools with [P]
// f32 scales. The plan (group_heads, stages, pages_per_chunk, max_splits)
// comes from the wrapper; the workspaces may be null when max_splits == 1.
// Returns a cudaError_t (0 = launched). The launch is asynchronous on
// `stream`; nothing is allocated here.
int dpt_flash_span(const void* q, const void* pages_k, const void* pages_v,
                   const float* scales_k, const float* scales_v,
                   const int* block_table, const int* positions, void* out,
                   float* ws_acc, float* ws_ml, int* tickets, int B, int H,
                   int L, int head_dim, int page_size, int n_pages,
                   int group_heads, int stages, int pages_per_chunk,
                   int max_splits, int kv_int8, void* stream) {
  if (B == 0 || H == 0 || L == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return (int)launch_dh<int8_t>(
        head_dim, q, pages_k, pages_v, scales_k, scales_v, block_table,
        positions, out, ws_acc, ws_ml, tickets, B, H, L, page_size, n_pages,
        group_heads, stages, pages_per_chunk, max_splits, s);
  return (int)launch_dh<__nv_bfloat16>(
      head_dim, q, pages_k, pages_v, scales_k, scales_v, block_table,
      positions, out, ws_acc, ws_ml, tickets, B, H, L, page_size, n_pages,
      group_heads, stages, pages_per_chunk, max_splits, s);
}

}  // extern "C"
