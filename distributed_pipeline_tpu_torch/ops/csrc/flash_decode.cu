// Paged flash-decode for Hopper (sm_90a): single-query attention read
// straight from the paged KV pool through each slot's block table, over
// pages of q's type or int8 pages with per-page f32 scales.
//
// Replaces the TPU kernel distributed_pipeline_tpu/ops/flash_decode.py
// `_decode_kernel` (reached through `flash_decode`), both of its branches:
// fp pages, and int8 pages dequantized as `page.astype(f32) * scale`. It
// computes the same function, not the same schedule. The TPU walks one
// sequential grid over a compressed step table built on the device; blocks
// of a GPU grid run in parallel and in no order, so here each CTA reads its
// own block-table entries and position, and no step table exists.
//
// What bounds it: bytes. One query row per head makes this a GEMV: about 4
// flops per K/V byte in bf16 (8 in int8), far below the ~295 flop/byte at
// which the H100's tensor cores would matter, so the design keeps them out
// and moves the bytes at the card's rate. The census is
// `decode_hbm_bytes(..., step_table=False)` in ops/flash_decode.py.
//
// * Split-K over pages. The grid is static, [B, max_splits, head groups],
//   sized on the host from the reservation width n and B (never from the
//   positions, so the wrapper never waits on the device). CTA (b, c, g)
//   takes pages [c * ppc, (c + 1) * ppc) of slot b's live prefix, which it
//   computes from positions[b] itself, and exits at once if that chunk is
//   empty. A long slot is folded by many CTAs side by side. Chunk-major
//   order dispatches every slot's first chunks before the later (more
//   often empty) ones.
// * Whole pages by bulk copy. A page [page_size, H, Dh] is one contiguous
//   block for all heads; one producer warp fetches each live page's K and
//   V with `cp.async.bulk` into a ring of `stages` shared-memory stages
//   (the wrapper takes 2) behind full/empty mbarriers, so the next page is
//   in flight while the consumers fold the current one. Where two stages
//   of whole pages would not fit in the opt-in shared memory (f32 pages of
//   wide heads), or H > 12, the CTA takes a group of heads and issues one
//   bulk copy per token row of its group (the wrapper plans this and
//   raises where no group fits). int8 pages are half the bytes of bf16;
//   their two scales ride the stage beside the page: the producer loads
//   them with the page ids, issues the copies, then publishes the scales
//   with the stage's second arrival, so their load is off the copies' path.
// * Folding. One consumer warp a head (a CTA has group_heads + 1 warps;
//   group_heads <= 12, so that two CTAs share an SM). A warp reads each key
//   row of its head as 16-byte vectors from shared memory (CPR lanes a row,
//   RPP rows a pass, 16 rows a block), reduces q.k across the row's lanes,
//   keeps the online softmax in f32 in the log2 domain with one max
//   reduction per 16-row block, and accumulates p * v in registers: each
//   lane owns one 16-byte column chunk of the rows it read, so p never
//   leaves the lane. int8 scales are folded in once per row (k) and into p
//   (v); int8 -> f32 goes through a byte permute and an add instead of the
//   quarter-rate integer conversion.
// * Combining the chunks. A slot with one chunk writes its output directly.
//   Otherwise each chunk writes (m, l, acc[heads, Dh]) in f32 to a
//   workspace, takes a ticket, and the slot's last chunk merges all chunks
//   (and resets the ticket for the next call): per head, one warp reads the
//   chunks' m and l while its lanes' first accumulator loads are in
//   flight, then sums them with eight loads in flight. Every sum runs in a
//   fixed order and there are no float atomics: two calls on the same
//   inputs are bitwise equal.
//
// Layouts (all contiguous, as the wrapper checks):
//   q            [B, H, Dh]              T
//   pages_k/v    [P, page_size, H, Dh]   KV = T, or int8 with
//   scales_k/v   [P]                     f32 (int8 pools only)
//   block_table  [B, n_pages]            int32
//   positions    [B]                     int32 (pos < 0: no live key -> zeros)
//   out          [B, H, Dh]              T
//   ws_acc       [B, max_splits, H, Dh]  f32 workspace (max_splits > 1)
//   ws_ml        [2, B, max_splits, H]   f32 workspace (max_splits > 1)
//   tickets      [B * groups]            int32, zero between calls
// T is float or __nv_bfloat16; Dh is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_pipeline.cuh"

namespace {

// At most 12 heads (consumer warps) a CTA, so that two CTAs of 416 threads
// share an SM (72 registers a thread).
constexpr int kMaxGroupHeads = 12;
constexpr int kMaxThreads = 32 * (kMaxGroupHeads + 1);  // + one producer
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes of a page row -> 16 / sizeof(KV) floats.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// int8 -> f32 without the quarter-rate integer conversion: bias each byte
// to b + 128 (xor 0x80), place it as the low mantissa byte of 2^23, and
// subtract 2^23 + 128 (exact).
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16]) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u + j)) -
          8388736.f;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory of one CTA: `stages` x (K tile, V tile) of
// [page_size, heads, Dh] KV each, then the full and empty barriers, the
// stages' (k, v) scales and the last-chunk flag. Mirrored by
// `_smem_bytes` in ops/flash_decode.py. The combine reuses the tiles for
// its [heads, max_splits] chunk weights.
__host__ __device__ __forceinline__ size_t tile_bytes(int page_size,
                                                      int heads, int dh,
                                                      int kv_bytes) {
  return (size_t)page_size * heads * dh * kv_bytes;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int stages,
                                                      size_t tile) {
  return stages * (2 * tile + 24) + 16;
}

// One CTA per (chunk, slot, head group); blockDim = 32 * (group_heads + 1):
// consumer warp w folds head h0 + w, the last warp produces.
template <typename T, typename KV, int DH>
__global__ void __launch_bounds__(kMaxThreads, 2)
flash_decode_sm90_kernel(const T* __restrict__ q, const KV* __restrict__ pages_k,
                         const KV* __restrict__ pages_v,
                         const float* __restrict__ scales_k,
                         const float* __restrict__ scales_v,
                         const int* __restrict__ block_table,
                         const int* __restrict__ positions, T* __restrict__ out,
                         float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                         int* __restrict__ tickets, int B, int H,
                         int page_size, int n_pages, int group_heads,
                         int stages, int pages_per_chunk, int max_splits,
                         float qk_scale) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  constexpr int VEC = 16 / (int)sizeof(KV);  // elements in 16 bytes
  constexpr int CPR = DH / VEC;              // lanes a key row
  constexpr int RPP = 32 / CPR;              // rows a warp reads per pass
  constexpr int NP = RPP >= 16 ? 1 : 16 / RPP;  // passes a 16-row block
  static_assert(CPR >= 1 && CPR <= 32, "Dh must span 1..32 vectors");

  const int b = blockIdx.x;
  const int chunk = blockIdx.y;
  const int g = blockIdx.z;
  const int first = chunk * pages_per_chunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the producer reads its chunk's first 32 block-table entries alongside
  // the position, not after it (entries past the live prefix are never used)
  int my_page = 0;
  if (warp == group_heads && lane < pages_per_chunk && first + lane < n_pages)
    my_page = block_table[(long long)b * n_pages + first + lane];
  const int pos = positions[b];
  // floor division: pos = -1 has no live page (C division truncates)
  const int n_live = pos < 0 ? 0 : min(pos / page_size + 1, n_pages);
  // a slot with no live page still has one chunk: it writes the zeros
  const int n_chunks = max(1, (n_live + pages_per_chunk - 1) / pages_per_chunk);
  if (chunk >= n_chunks) return;
  const int count = max(0, min(n_live - first, pages_per_chunk));
  const int h0 = g * group_heads;
  const int heads = min(group_heads, H - h0);  // this CTA's heads

  extern __shared__ __align__(128) uint8_t smem[];
  const size_t tile = tile_bytes(page_size, heads, DH, sizeof(KV));
  const size_t tile_alloc = tile_bytes(page_size, group_heads, DH, sizeof(KV));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * 2 * tile_alloc);
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
    const uint32_t row_bytes = (uint32_t)(heads * DH * sizeof(KV));
    for (int j0 = 0; j0 < count; j0 += 32) {
      if (j0 > 0 && j0 + lane < count)
        my_page = block_table[(long long)b * n_pages + first + j0 + lane];
      // int8 scales: loaded now, needed only once this batch's first
      // copies are on their way
      float my_sk = 1.f, my_sv = 1.f;
      if (kInt8 && j0 + lane < count) {
        my_sk = scales_k[my_page];
        my_sv = scales_v[my_page];
      }
      const int m = min(32, count - j0);
      for (int u = 0; u < m; ++u) {
        const int j = j0 + u;
        const int s = j % stages;
        const long long page = __shfl_sync(0xffffffffu, my_page, u);
        mbar_wait(&empty[s], ((j / stages) & 1) ^ 1);
        uint8_t* dk = smem + (size_t)s * 2 * tile_alloc;
        uint8_t* dv = dk + tile_alloc;
        if (lane == 0)
          mbar_arrive_expect_tx(&full[s], (uint32_t)(2 * tile));
        __syncwarp();
        const KV* src_k = pages_k + page * page_elems + (long long)h0 * DH;
        const KV* src_v = pages_v + page * page_elems + (long long)h0 * DH;
        if (heads == H) {
          if (lane == 0) {
            bulk_load(dk, src_k, (uint32_t)tile, &full[s]);
            bulk_load(dv, src_v, (uint32_t)tile, &full[s]);
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

  // ---- consumer warp: head h of slot b over this chunk's pages ----
  const int h = h0 + warp;
  const int c = lane % CPR;   // this lane's 16-byte column chunk
  const int r = lane / CPR;   // this lane's row within a pass
  float qv[VEC], acc[VEC];
  float m_run = -INFINITY, l_run = 0.f;
  {
    const T* qrow = q + ((long long)b * H + h) * DH + c * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qv[e] = to_f32(qrow[e]) * qk_scale;
      acc[e] = 0.f;
    }
  }
  const int row_stride = heads * DH;  // elements between key rows in a tile

  for (int j = 0; j < count; ++j) {
    const int s = j % stages;
    mbar_wait(&full[s], (j / stages) & 1);
    const KV* kh = reinterpret_cast<const KV*>(
        smem + (size_t)s * 2 * tile_alloc) + warp * DH + c * VEC;
    const KV* vh = reinterpret_cast<const KV*>(
        smem + (size_t)s * 2 * tile_alloc + tile_alloc) + warp * DH + c * VEC;
    const float2 sc = stage_scales[s];
    // rows 0..valid-1 of this page are live; only a slot's last live page
    // has valid < page_size, and every live page has valid >= 1
    const int valid = min(page_size, pos - (first + j) * page_size + 1);
    for (int rb = 0; rb < valid; rb += RPP * NP) {
      float sc_row[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int t = rb + p * RPP + r;
        float d = 0.f;
        if (t < valid) {
          float kf[VEC];
          unpack(*reinterpret_cast<const uint4*>(kh + t * row_stride), kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qv[e], kf[e], d);
        }
        sc_row[p] = d;
      }
#pragma unroll
      for (int off = 1; off < CPR; off <<= 1)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          sc_row[p] += __shfl_xor_sync(0xffffffffu, sc_row[p], off);
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        sc_row[p] = rb + p * RPP + r < valid ? sc_row[p] * sc.x : -INFINITY;
        mx = fmaxf(mx, sc_row[p]);
      }
#pragma unroll
      for (int off = CPR; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // row rb is live, so mx is finite; the first block has m_run = -inf
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      m_run = m_new;
      l_run *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int t = rb + p * RPP + r;
        if (t < valid) {
          const float pr = exp2f(sc_row[p] - m_new);
          l_run += pr;
          const float pv = pr * sc.y;
          float vf[VEC];
          unpack(*reinterpret_cast<const uint4*>(vh + t * row_stride), vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pv, vf[e], acc[e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // each lane holds the sums over its own rows: add across the row lanes
#pragma unroll
  for (int off = CPR; off < 32; off <<= 1) {
    l_run += __shfl_xor_sync(0xffffffffu, l_run, off);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }

  if (n_chunks == 1) {
    if (r == 0) {
      // a slot with no live key has l == 0 and acc == 0: zeros, not NaN
      const float inv = 1.f / fmaxf(l_run, 1e-20f);
      T* orow = out + ((long long)b * H + h) * DH + c * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) orow[e] = from_f32<T>(acc[e] * inv);
    }
    return;
  }

  // ---- several chunks: partials to the workspace, then a ticket ----
  const long long ml_plane = (long long)B * max_splits * H;
  const float* ws_m = ws_ml;
  const float* ws_l = ws_ml + ml_plane;
  {
    const long long hrow = ((long long)b * max_splits + chunk) * H + h;
    if (r == 0) {
      float4* dst = reinterpret_cast<float4*>(ws_acc + hrow * DH + c * VEC);
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        dst[e / 4] = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    }
    if (lane == 0) {
      ws_ml[hrow] = m_run;
      ws_ml[ml_plane + hrow] = l_run;
    }
  }
  __threadfence();
  named_sync(1, 32 * heads);
  if (threadIdx.x == 0) {
    int* ticket = tickets + (long long)b * gridDim.z + g;
    const int taken = atomicAdd(ticket, 1);
    *last_flag = taken == n_chunks - 1;
    if (taken == n_chunks - 1) *ticket = 0;  // ready for the next call
  }
  named_sync(1, 32 * heads);
  if (!*last_flag) return;
  __threadfence();

  // ---- the slot's last chunk merges every chunk in split order ----
  // Lane (grp, col) sums float4 column col of the accumulators over chunks
  // k = grp, grp + G, ...; the first kInFlight of them are loaded before
  // the chunk weights w_k = exp2(m_k - max m) are known, so both loads
  // share one trip to L2. The weights go through the (now idle) tiles.
  constexpr int CPL = DH / 4;   // lanes a row of float4 columns
  constexpr int G = 32 / CPL;   // chunk groups in a warp
  constexpr int kInFlight = 8;
  const int col = lane % CPL, grp = lane / CPL;
  const long long head0 = (long long)b * max_splits * H + h;  // chunk 0
  auto acc_at = [&](int k) {
    return k < n_chunks ? __ldcg(reinterpret_cast<const float4*>(
                              ws_acc + (head0 + (long long)k * H) * DH) +
                          col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 a[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) a[u] = acc_at(grp + u * G);
  // lane k holds chunk k's (m, l) for the first 32 chunks
  const bool has = lane < n_chunks;
  const float m_lane = has ? __ldcg(ws_m + head0 + (long long)lane * H)
                           : -INFINITY;
  const float l_lane = has ? __ldcg(ws_l + head0 + (long long)lane * H) : 0.f;
  float* weight = reinterpret_cast<float*>(smem) + warp * max_splits;
  float mmax = m_lane;
  for (int k = lane + 32; k < n_chunks; k += 32)
    mmax = fmaxf(mmax, __ldcg(ws_m + head0 + (long long)k * H));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mmax = fmaxf(mmax, __shfl_xor_sync(0xffffffffu, mmax, off));
  float l = 0.f;
  if (has) {
    const float w = exp2f(m_lane - mmax);
    weight[lane] = w;
    l = w * l_lane;
  }
  for (int k = lane + 32; k < n_chunks; k += 32) {
    const float w = exp2f(__ldcg(ws_m + head0 + (long long)k * H) - mmax);
    weight[k] = w;
    l = fmaf(w, __ldcg(ws_l + head0 + (long long)k * H), l);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  __syncwarp();
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = grp;; k0 += G * kInFlight) {
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int k = k0 + u * G;
      const float w = k < n_chunks ? weight[k] : 0.f;
      o.x = fmaf(w, a[u].x, o.x);
      o.y = fmaf(w, a[u].y, o.y);
      o.z = fmaf(w, a[u].z, o.z);
      o.w = fmaf(w, a[u].w, o.w);
    }
    if (k0 + G * kInFlight >= n_chunks) break;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      a[u] = acc_at(k0 + G * kInFlight + u * G);
  }
#pragma unroll
  for (int off = CPL; off < 32; off <<= 1) {
    o.x += __shfl_xor_sync(0xffffffffu, o.x, off);
    o.y += __shfl_xor_sync(0xffffffffu, o.y, off);
    o.z += __shfl_xor_sync(0xffffffffu, o.z, off);
    o.w += __shfl_xor_sync(0xffffffffu, o.w, off);
  }
  if (grp == 0) {
    const float inv = 1.f / fmaxf(l, 1e-20f);
    T* orow = out + ((long long)b * H + h) * DH + col * 4;
    orow[0] = from_f32<T>(o.x * inv);
    orow[1] = from_f32<T>(o.y * inv);
    orow[2] = from_f32<T>(o.z * inv);
    orow[3] = from_f32<T>(o.w * inv);
  }
}

template <typename T, typename KV, int DH>
cudaError_t launch(const void* q, const void* pages_k, const void* pages_v,
                   const float* scales_k, const float* scales_v,
                   const int* block_table, const int* positions, void* out,
                   float* ws_acc, float* ws_ml, int* tickets, int B, int H,
                   int page_size, int n_pages, int group_heads, int stages,
                   int pages_per_chunk, int max_splits, cudaStream_t stream) {
  auto kernel = flash_decode_sm90_kernel<T, KV, DH>;
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
  const size_t smem = smem_bytes(
      stages, tile_bytes(page_size, group_heads, DH, sizeof(KV)));
  // the combine keeps [group_heads, max_splits] f32 weights in the tiles
  if (smem > (size_t)optin || group_heads < 1 ||
      group_heads > kMaxGroupHeads || stages < 1 || pages_per_chunk < 1 ||
      max_splits < 1 || max_splits > 65535 ||
      (long long)max_splits * pages_per_chunk < n_pages ||
      (size_t)group_heads * max_splits * sizeof(float) >
          (size_t)stages * 2 *
              tile_bytes(page_size, group_heads, DH, sizeof(KV)))
    return cudaErrorInvalidValue;
  const dim3 grid(B, max_splits, (H + group_heads - 1) / group_heads);
  kernel<<<grid, 32 * (group_heads + 1), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(pages_k),
      static_cast<const KV*>(pages_v), scales_k, scales_v, block_table,
      positions, static_cast<T*>(out), ws_acc, ws_ml, tickets, B, H,
      page_size, n_pages, group_heads, stages, pages_per_chunk, max_splits,
      kLog2e / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_dh(int head_dim, const void* q, const void* pages_k,
                      const void* pages_v, const float* scales_k,
                      const float* scales_v, const int* block_table,
                      const int* positions, void* out, float* ws_acc,
                      float* ws_ml, int* tickets, int B, int H,
                      int page_size, int n_pages, int group_heads,
                      int stages, int pages_per_chunk, int max_splits,
                      cudaStream_t stream) {
  if (head_dim == 64)
    return launch<T, KV, 64>(q, pages_k, pages_v, scales_k, scales_v,
                             block_table, positions, out, ws_acc, ws_ml,
                             tickets, B, H, page_size, n_pages, group_heads,
                             stages, pages_per_chunk, max_splits, stream);
  if (head_dim == 128)
    return launch<T, KV, 128>(q, pages_k, pages_v, scales_k, scales_v,
                              block_table, positions, out, ws_acc, ws_ml,
                              tickets, B, H, page_size, n_pages, group_heads,
                              stages, pages_per_chunk, max_splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of q and out): 0 = float32, 1 = bfloat16; kv_int8: 0 = pools of
// q's dtype, 1 = int8 pools with [P] f32 scales. The plan (group_heads,
// stages, pages_per_chunk, max_splits) comes from the wrapper; the
// workspaces may be null when max_splits == 1. Returns a cudaError_t
// (0 = launched). The launch is asynchronous on `stream`; nothing is
// allocated here.
int dpt_flash_decode(const void* q, const void* pages_k, const void* pages_v,
                     const float* scales_k, const float* scales_v,
                     const int* block_table, const int* positions, void* out,
                     float* ws_acc, float* ws_ml, int* tickets, int B, int H,
                     int head_dim, int page_size, int n_pages,
                     int group_heads, int stages, int pages_per_chunk,
                     int max_splits, int dtype, int kv_int8, void* stream) {
  if (B == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !kv_int8)
    return (int)launch_dh<float, float>(
        head_dim, q, pages_k, pages_v, scales_k, scales_v, block_table,
        positions, out, ws_acc, ws_ml, tickets, B, H, page_size, n_pages,
        group_heads, stages, pages_per_chunk, max_splits, s);
  if (dtype == 1 && !kv_int8)
    return (int)launch_dh<__nv_bfloat16, __nv_bfloat16>(
        head_dim, q, pages_k, pages_v, scales_k, scales_v, block_table,
        positions, out, ws_acc, ws_ml, tickets, B, H, page_size, n_pages,
        group_heads, stages, pages_per_chunk, max_splits, s);
  if (dtype == 0 && kv_int8)
    return (int)launch_dh<float, int8_t>(
        head_dim, q, pages_k, pages_v, scales_k, scales_v, block_table,
        positions, out, ws_acc, ws_ml, tickets, B, H, page_size, n_pages,
        group_heads, stages, pages_per_chunk, max_splits, s);
  if (dtype == 1 && kv_int8)
    return (int)launch_dh<__nv_bfloat16, int8_t>(
        head_dim, q, pages_k, pages_v, scales_k, scales_v, block_table,
        positions, out, ws_acc, ws_ml, tickets, B, H, page_size, n_pages,
        group_heads, stages, pages_per_chunk, max_splits, s);
  return (int)cudaErrorInvalidValue;
}

const char* dpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
