// Flash attention forward and backward for Hopper (sm_90a): blocked,
// causal/padded, online-softmax attention whose [L, L] score matrix never
// reaches device memory.
//
// Replaces the TPU kernels of distributed_pipeline_tpu/ops/flash_attention.py:
//   `_fwd_kernel` (through `_flash_forward`) by flash_fwd_kernel, and
//   `_bwd_kernel` (through `_flash_backward`) by flash_bwd_dkdv_kernel plus
//   flash_bwd_dq_kernel.
// The TPU kernels walk a sequential grid driven by a compressed step table
// (`_plan_steps`) that lists only the live (query block, key block) pairs.
// Blocks of a GPU grid run in parallel and in no order, so here each block
// owns one 64-row tile and loops over its live partner tiles itself: for a
// causal call the loop simply stops at (forward, dq) or starts at (dk/dv)
// the diagonal tile, so tiles above the diagonal are never visited and no
// step table exists.
//
// What bounds it on this card: operations. At the training shape (B=4,
// H=12, L=1024, Dh=64, causal, bf16) the forward does 6.44 GFLOP on 25 MB
// and the backward 16.1 GFLOP on 51 MB, well above the ~295 flop/byte where
// the H100's tensor cores stop waiting on memory. This first version keeps
// the design simple and right: tiles are staged in shared memory as f32,
// products run as f32 FMAs on the CUDA cores (4x4 scores and 4 x Dh/16
// outputs per thread), so it runs far below the tensor-core bound; wgmma,
// TMA and warp specialisation are later work. The softmax state (running
// max, normalizer, accumulator) is f32 throughout.
//
// dq: the TPU sums per-key-block partials (or a VMEM plane) across the key
// axis. Here the backward is two kernels, each deterministic: one block per
// key tile accumulates dk and dv over the live query tiles, and one block
// per query tile recomputes s and p and accumulates dq over the live key
// tiles. No atomics, so the result does not change from run to run.
//
// Masking follows the JAX kernels exactly: scores are f32, scaled by
// Dh**-0.5; a key with pad_mask == 0 gets NEG_INF added, a causal-future key
// (and a key past L in the ragged last tile) is set to NEG_INF; an entry is
// live iff its score is above NEG_INF/2, and only live entries enter the
// exponentials, so a fully masked row gives out = 0, lse = m + log(1e-20)
// and zero gradients.
//
// Layouts (all contiguous): q, k, v, out, dout, dq, dk, dv [B, H, L, Dh] T;
// pad_mask [B, L] int32 or null; lse, delta [B, H, L] f32.
// T is float or __nv_bfloat16; Dh is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kTile = 64;      // query and key tile rows
constexpr int kSLd = kTile + 1;
constexpr float kNegInf = -1e9f;

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

// dst[r * (DH + 1) + d] = src[row0 + r, d] as f32, zero past row L.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int L) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx % DH;
    const int row = row0 + r;
    dst[r * (DH + 1) + d] =
        row < L ? to_f32(src[(long long)row * DH + d]) : 0.f;
  }
}

// The masked, scaled score of query row r and key column c, as the JAX
// kernels compute it (see the header).
__device__ __forceinline__ float masked_score(float dot, float scale, int r,
                                              int c, int L, const int* mask_row,
                                              int causal) {
  if (c >= L) return kNegInf;
  float x = dot * scale;
  if (mask_row != nullptr && mask_row[c] == 0) x = x + kNegInf;
  if (causal && c > r) x = kNegInf;
  return x;
}

__device__ __forceinline__ bool is_live(float x) { return x > kNegInf * 0.5f; }

// Scores of a 64 x 64 tile pair: s[i][j] = sum_d A[ty+16i][d] * B[tx+16j][d].
template <int DH>
__device__ __forceinline__ void tile_dot(const float* sA, const float* sB,
                                         int ty, int tx, float s[4][4]) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sA[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = sB[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// One block per (b*h, 64-row query tile): walk the key tiles up to the
// diagonal with an online softmax.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pad_mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int L,
                 int causal, float scale) {
  constexpr int LD = DH + 1;
  constexpr int CPT = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                  // [64][LD]
  float* sK = sQ + kTile * LD;       // [64][LD]
  float* sV = sK + kTile * LD;       // [64][LD]
  float* sS = sV + kTile * LD;       // [64][kSLd] scores, then p
  float* sM = sS + kTile * kSLd;     // [64] running max
  float* sL = sM + kTile;            // [64] running normalizer
  float* sA = sL + kTile;            // [64] this tile's rescale factor

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long base = (long long)bh * L * DH;
  const int* mask_row = pad_mask ? pad_mask + (long long)(bh / H) * L : nullptr;

  load_tile<T, DH>(sQ, q + base, q0, L);
  if (tid < kTile) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DH>(sK, k + base, k0, L);
    load_tile<T, DH>(sV, v + base, k0, L);
    __syncthreads();

    float s[4][4];
    tile_dot<DH>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        sS[r * kSLd + c] =
            masked_score(s[i][j], scale, q0 + r, k0 + c, L, mask_row, causal);
      }
    __syncthreads();

    {  // four threads per query row: max, exponentials, normalizer
      const int row = tid >> 2;
      const int part = tid & 3;
      float* srow = sS + row * kSLd + part * 16;
      const float m_prev = sM[row];
      float m_new = m_prev;
#pragma unroll
      for (int t = 0; t < 16; ++t) m_new = fmaxf(m_new, srow[t]);
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float x = srow[t];
        const float p = is_live(x) ? expf(x - m_new) : 0.f;
        srow[t] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[row] = alpha;
        sL[row] = alpha * sL[row] + psum;
        sM[row] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * kSLd + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = sV[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= L) continue;
    // a fully masked row has l == 0 and acc == 0: zeros, not NaN
    const float l = fmaxf(sL[r], 1e-20f);
    T* orow = out + base + (long long)(q0 + r) * DH;
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
  if (tid < kTile && q0 + tid < L)
    lse[(long long)bh * L + q0 + tid] = sM[tid] + logf(fmaxf(sL[tid], 1e-20f));
}

// Scores and dO.V^T of one (query tile, key tile) pair, turned into p and
// ds = p * (dp - delta) * scale, for the thread's 4 x 4 entries. Rows past
// L (zero-filled q) get p = 0.
template <int DH>
__device__ __forceinline__ void probs_and_ds(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    const float lse_r[4], const float delta_r[4], int q0, int k0, int L,
    const int* mask_row, int causal, float scale, int ty, int tx,
    float p[4][4], float ds[4][4]) {
  float s[4][4], dp[4][4];
  tile_dot<DH>(sQ, sK, ty, tx, s);
  tile_dot<DH>(sdO, sV, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = q0 + ty + 16 * i;
      const float x = masked_score(s[i][j], scale, r, k0 + tx + 16 * j, L,
                                   mask_row, causal);
      p[i][j] = (r < L && is_live(x)) ? expf(x - lse_r[i]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta_r[i]) * scale;
    }
}

// One block per (b*h, 64-row key tile): walk the live query tiles (from the
// diagonal on, when causal) and accumulate dk and dv in registers.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pad_mask,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int L, int causal,
                      float scale) {
  constexpr int LD = DH + 1;
  constexpr int CPT = DH / 16;
  extern __shared__ float smem[];
  float* sK = smem;                  // [64][LD]
  float* sV = sK + kTile * LD;       // [64][LD]
  float* sQ = sV + kTile * LD;       // [64][LD]
  float* sdO = sQ + kTile * LD;      // [64][LD]
  float* sP = sdO + kTile * LD;      // [64 q][kSLd]
  float* sDS = sP + kTile * kSLd;    // [64 q][kSLd]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long base = (long long)bh * L * DH;
  const long long sbase = (long long)bh * L;
  const int* mask_row = pad_mask ? pad_mask + (long long)(bh / H) * L : nullptr;

  load_tile<T, DH>(sK, k + base, k0, L);
  load_tile<T, DH>(sV, v + base, k0, L);
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // query tiles whose rows reach this key tile: from the diagonal on
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < L; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DH>(sQ, q + base, q0, L);
    load_tile<T, DH>(sdO, dout + base, q0, L);
    __syncthreads();

    float lse_r[4], delta_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      lse_r[i] = r < L ? lse[sbase + r] : 0.f;
      delta_r[i] = r < L ? delta[sbase + r] : 0.f;
    }
    float p[4][4], ds[4][4];
    probs_and_ds<DH>(sQ, sdO, sK, sV, lse_r, delta_r, q0, k0, L, mask_row,
                     causal, scale, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sP[(ty + 16 * i) * kSLd + tx + 16 * j] = p[i][j];
        sDS[(ty + 16 * i) * kSLd + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dv[c] += sum_r p[r][c] dO[r];  dk[c] += sum_r ds[r][c] q[r]
    // (this thread owns key rows ty + 16 i, columns tx + 16 j)
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pc[4], dsc[4], dov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pc[i] = sP[r * kSLd + ty + 16 * i];
        dsc[i] = sDS[r * kSLd + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        dov[j] = sdO[r * LD + tx + 16 * j];
        qv[j] = sQ[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          dv_acc[i][j] = fmaf(pc[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsc[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= L) continue;
    T* dkrow = dk + base + (long long)c * DH;
    T* dvrow = dv + base + (long long)c * DH;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      dkrow[tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
      dvrow[tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// One block per (b*h, 64-row query tile): recompute p and ds over the live
// key tiles (up to the diagonal, when causal) and accumulate dq.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pad_mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H,
                    int L, int causal, float scale) {
  constexpr int LD = DH + 1;
  constexpr int CPT = DH / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [64][LD]
  float* sdO = sQ + kTile * LD;      // [64][LD]
  float* sK = sdO + kTile * LD;      // [64][LD]
  float* sV = sK + kTile * LD;       // [64][LD]
  float* sDS = sV + kTile * LD;      // [64 q][kSLd]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long base = (long long)bh * L * DH;
  const long long sbase = (long long)bh * L;
  const int* mask_row = pad_mask ? pad_mask + (long long)(bh / H) * L : nullptr;

  load_tile<T, DH>(sQ, q + base, q0, L);
  load_tile<T, DH>(sdO, dout + base, q0, L);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < L ? lse[sbase + r] : 0.f;
    delta_r[i] = r < L ? delta[sbase + r] : 0.f;
  }
  float dq_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq_acc[i][j] = 0.f;

  const int k_end = causal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, DH>(sK, k + base, k0, L);
    load_tile<T, DH>(sV, v + base, k0, L);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_ds<DH>(sQ, sdO, sK, sV, lse_r, delta_r, q0, k0, L, mask_row,
                     causal, scale, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sDS[(ty + 16 * i) * kSLd + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dq[r] += sum_c ds[r][c] k[c]  (rows ty + 16 i, columns tx + 16 j)
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsr[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = sDS[(ty + 16 * i) * kSLd + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) dq_acc[i][j] = fmaf(dsr[i], kv[j], dq_acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= L) continue;
    T* dqrow = dq + base + (long long)r * DH;
#pragma unroll
    for (int j = 0; j < CPT; ++j) dqrow[tx + 16 * j] = from_f32<T>(dq_acc[i][j]);
  }
}

template <int DH>
constexpr size_t fwd_smem() {
  return (size_t)(3 * kTile * (DH + 1) + kTile * kSLd + 3 * kTile) * sizeof(float);
}
template <int DH>
constexpr size_t dkdv_smem() {
  return (size_t)(4 * kTile * (DH + 1) + 2 * kTile * kSLd) * sizeof(float);
}
template <int DH>
constexpr size_t dq_smem() {
  return (size_t)(4 * kTile * (DH + 1) + kTile * kSLd) * sizeof(float);
}

template <typename T, int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* pad_mask, void* out, float* lse, int B,
                       int H, int L, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pad_mask, static_cast<T*>(out), lse, H, L,
      causal, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const int* pad_mask, const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int B, int H, int L, int causal, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem<DH>();
  constexpr size_t smem_q = dq_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, B * H);
  const float scale = 1.0f / sqrtf((float)DH);
  flash_bwd_dkdv_kernel<T, DH><<<grid, kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pad_mask, static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), H, L, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DH><<<grid, kThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pad_mask, static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dq), H, L, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128; pad_mask may be
// null. Returns a cudaError_t (0 = launched). Launches are asynchronous on
// `stream`; nothing is allocated here.
int dpt_flash_fwd(const void* q, const void* k, const void* v,
                  const int* pad_mask, void* out, float* lse, int B, int H,
                  int L, int head_dim, int causal, int dtype, void* stream) {
  if (B == 0 || H == 0 || L == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return (int)launch_fwd<float, 64>(q, k, v, pad_mask, out, lse, B, H, L,
                                      causal, s);
  if (dtype == 0 && head_dim == 128)
    return (int)launch_fwd<float, 128>(q, k, v, pad_mask, out, lse, B, H, L,
                                       causal, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch_fwd<__nv_bfloat16, 64>(q, k, v, pad_mask, out, lse, B,
                                              H, L, causal, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_fwd<__nv_bfloat16, 128>(q, k, v, pad_mask, out, lse, B,
                                               H, L, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dk/dv kernel, then dq kernel, on one stream.
int dpt_flash_bwd(const void* q, const void* k, const void* v,
                  const int* pad_mask, const void* dout, const float* lse,
                  const float* delta, void* dq, void* dk, void* dv, int B,
                  int H, int L, int head_dim, int causal, int dtype,
                  void* stream) {
  if (B == 0 || H == 0 || L == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return (int)launch_bwd<float, 64>(q, k, v, pad_mask, dout, lse, delta, dq,
                                      dk, dv, B, H, L, causal, s);
  if (dtype == 0 && head_dim == 128)
    return (int)launch_bwd<float, 128>(q, k, v, pad_mask, dout, lse, delta,
                                       dq, dk, dv, B, H, L, causal, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch_bwd<__nv_bfloat16, 64>(q, k, v, pad_mask, dout, lse,
                                              delta, dq, dk, dv, B, H, L,
                                              causal, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_bwd<__nv_bfloat16, 128>(q, k, v, pad_mask, dout, lse,
                                               delta, dq, dk, dv, B, H, L,
                                               causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
