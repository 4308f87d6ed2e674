// Paged flash-decode for Hopper (sm_90a): single-query attention read
// straight from the paged KV pool through each slot's block table.
//
// Replaces the TPU kernel distributed_pipeline_tpu/ops/flash_decode.py
// `_decode_kernel` (reached through `flash_decode`). It computes the same
// function, not the same schedule: the TPU walks one sequential grid over a
// compressed step table built on the device; here every (head, slot) pair is
// an independent thread block that reads its own block-table row and
// position, so no step table exists and the dead tail of a reservation is
// never visited.
//
// What bounds it: bytes. Per generated token it reads each live K/V page
// once (plus q, one output row and the table row) and does 4 flops per byte
// of K/V in bf16, far below the ~295 flop/byte the card needs before compute
// matters. The census is `decode_hbm_bytes(..., step_table=False)` in
// ops/flash_decode.py. This
// first version keeps the design simple: plain coalesced loads, f32 math on
// the CUDA cores, one online-softmax fold per page. TMA, wgmma and split-K
// over long contexts are later work.
//
// Layouts (all contiguous, as the wrapper checks):
//   q            [B, H, Dh]            T
//   pages_k/v    [P, page_size, H, Dh] T   (page 0 is the trash page)
//   block_table  [B, n_pages]          int32
//   positions    [B]                   int32  (pos < 0: no live key -> zeros)
//   out          [B, H, Dh]            T
// T is float or __nv_bfloat16; Dh is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

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

// One block per (head, slot). Scores: each warp takes whole key rows and
// reduces q.k across its lanes. P.V: thread (g, d) owns output column d for
// the page rows t = g, g + G, ...; the G partial sums meet in shared memory
// at the end.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ pages_k,
                    const T* __restrict__ pages_v,
                    const int* __restrict__ block_table,
                    const int* __restrict__ positions, T* __restrict__ out,
                    int H, int page_size, int n_pages, float scale) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kGroups = kThreads / DH;
  constexpr int kPerLane = DH / 32;
  extern __shared__ float smem[];
  float* scores = smem;                // [page_size]
  float* partial = smem + page_size;   // [kGroups, DH]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = tid % DH;
  const int g = tid / DH;
  const int pos = positions[b];
  // floor division: pos = -1 has no live page (C division truncates)
  const int n_live = pos < 0 ? 0 : min(pos / page_size + 1, n_pages);

  const long long tok_stride = (long long)H * DH;
  const long long page_stride = (long long)page_size * tok_stride;
  const T* qrow = q + ((long long)b * H + h) * DH;
  float qv[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) qv[i] = to_f32(qrow[lane + 32 * i]);

  float m = -INFINITY;  // running max
  float l = 0.f;        // running normalizer
  float acc = 0.f;      // running sum of p * v[:, d] over this thread's rows
  for (int j = 0; j < n_live; ++j) {
    const long long page = block_table[(long long)b * n_pages + j];
    const T* kp = pages_k + page * page_stride + (long long)h * DH;
    const T* vp = pages_v + page * page_stride + (long long)h * DH;
    // rows 0..valid-1 of this page are live; only the last live page has
    // valid < page_size, and every live page has valid >= 1
    const int valid = min(page_size, pos - j * page_size + 1);
    for (int t = warp; t < valid; t += kWarps) {
      const T* krow = kp + t * tok_stride;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) s += qv[i] * to_f32(krow[lane + 32 * i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) scores[t] = s * scale;
    }
    __syncthreads();
    float m_page = -INFINITY;
    for (int t = 0; t < valid; ++t) m_page = fmaxf(m_page, scores[t]);
    const float m_new = fmaxf(m, m_page);
    const float alpha = expf(m - m_new);  // first page: exp(-inf) = 0
    float p_sum = 0.f;
    for (int t = 0; t < valid; ++t) p_sum += expf(scores[t] - m_new);
    l = l * alpha + p_sum;
    acc *= alpha;
    for (int t = g; t < valid; t += kGroups)
      acc += expf(scores[t] - m_new) * to_f32(vp[t * tok_stride + d]);
    m = m_new;
    __syncthreads();  // the next page rewrites scores
  }
  partial[g * DH + d] = acc;
  __syncthreads();
  if (g == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) total += partial[i * DH + d];
    // a slot with no live key has l == 0 and acc == 0: zeros, not NaN
    out[((long long)b * H + h) * DH + d] = from_f32<T>(total / fmaxf(l, 1e-20f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* pages_k, const void* pages_v,
                   const int* block_table, const int* positions, void* out,
                   int B, int H, int page_size, int n_pages,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  const size_t smem = (size_t)(page_size + (kThreads / DH) * DH) * sizeof(float);
  flash_decode_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages_k),
      static_cast<const T*>(pages_v), block_table, positions,
      static_cast<T*>(out), H, page_size, n_pages, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
// The launch is asynchronous on `stream`; nothing is allocated here.
int dpt_flash_decode(const void* q, const void* pages_k, const void* pages_v,
                     const int* block_table, const int* positions, void* out,
                     int B, int H, int head_dim, int page_size, int n_pages,
                     int dtype, void* stream) {
  if (B == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return (int)launch<float, 64>(q, pages_k, pages_v, block_table, positions,
                                  out, B, H, page_size, n_pages, s);
  if (dtype == 0 && head_dim == 128)
    return (int)launch<float, 128>(q, pages_k, pages_v, block_table, positions,
                                   out, B, H, page_size, n_pages, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, 64>(q, pages_k, pages_v, block_table,
                                          positions, out, B, H, page_size,
                                          n_pages, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(q, pages_k, pages_v, block_table,
                                           positions, out, B, H, page_size,
                                           n_pages, s);
  return (int)cudaErrorInvalidValue;
}

const char* dpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
