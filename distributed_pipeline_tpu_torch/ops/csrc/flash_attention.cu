// Flash attention forward and backward for Hopper (sm_90a): blocked,
// causal/padded, online-softmax attention whose [L, L] score matrix never
// reaches device memory.
//
// Replaces the TPU kernels of distributed_pipeline_tpu/ops/flash_attention.py:
//   `_fwd_kernel` (through `_flash_forward`) and `_bwd_kernel` (through
//   `_flash_backward`).
// The TPU kernels walk a sequential grid driven by a compressed step table
// (`_plan_steps`) that lists only the live (query block, key block) pairs.
// Blocks of a GPU grid run in parallel and in no order, so here each block
// owns one tile and loops over its live partner tiles itself: for a causal
// call the loop stops at (forward, dq) or starts at (dk/dv) the diagonal
// tile, so tiles above the diagonal are never visited and no step table
// exists.
//
// What bounds it on this card: operations. At the training shape (B=4,
// H=12, L=1024, Dh=64, causal, bf16) the forward does 6.44 GFLOP on 25 MB
// and the backward 16.1 GFLOP on 51 MB, well above the ~295 flop/byte where
// the H100's tensor cores stop waiting on memory. Two arms:
//
// * bfloat16 (the training path and long prefills): FlashAttention-3's
//   shape. Every product is a wgmma (bf16 operands, f32 accumulators) on
//   tiles that one producer warp loads by TMA into 128-byte-swizzled shared
//   memory behind full/empty mbarrier rings; two consumer warpgroups own 64
//   rows each and keep scores, probabilities and the softmax state in
//   registers. Forward (flash_fwd_sm90_kernel): one CTA per 128-row query
//   tile, S = Q K^T from shared memory, P cast to bf16 in registers (as the
//   JAX kernel casts p to v's dtype before p.v) and fed to O += P V as the
//   register A operand. Backward (flash_bwd_sm90_kernel): one pass, one CTA
//   per 128-row key tile (64 at Dh=128), five products per (query tile, key
//   tile) pair. Each CTA stores its key tile's dq part (its two warpgroups'
//   parts summed in shared memory) into a plane of its own (f32, plain
//   stores), and flash_bwd_dq_reduce_kernel sums the planes in ascending
//   key order and casts: dq is the same bits on every run, as the JAX
//   kernel's fixed-order dq scratch is. Only
//   tiles on the diagonal, at the ragged end or holding padded keys take
//   the mask arithmetic.
// * float32: the FMA kernels below (flash_fwd_kernel, flash_bwd_dkdv_kernel
//   and flash_bwd_dq_kernel): 64x64 tiles staged as f32 in shared memory,
//   products as f32 FMAs on the CUDA cores, dq recomputed per query tile
//   (deterministic). Tensor cores would take f32 only as TF32, which would
//   change the numerics, and no main path runs f32 on the card.
//
// Masking follows the JAX kernels exactly: scores are f32, scaled by
// Dh**-0.5; a key with pad_mask == 0 gets NEG_INF added, a causal-future key
// (and a key past L in the ragged last tile) is set to NEG_INF; an entry is
// live iff its score is above NEG_INF/2, and only live entries enter the
// exponentials, so a fully masked row gives out = 0, lse = m + log(1e-20)
// and zero gradients. (The bf16 arm keeps scores in the log2 domain,
// s * log2(e), and uses exp2.)
//
// Layouts (all contiguous): q, k, v, out, dout, dq, dk, dv [B, H, L, Dh] T;
// pad_mask [B, L] int32 or null; lse, delta [B, H, L] f32; bf16 backward
// only: dq_part [planes, B, H, L, Dh] f32, one plane per key tile of a
// launch, and dq_accum [B, H, L, Dh] f32 (the running sum when the key
// tiles take more than one launch; null otherwise). T is float or
// __nv_bfloat16; Dh is 64 or 128.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// f32 arm. One block per (b*h, 64-row query tile): walk the key tiles up
// to the diagonal with an online softmax.
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

// ---------------------------------------------------------------------------
// The bf16 arm for Hopper: wgmma on tiles that TMA loads into 128-byte
// swizzled shared memory, behind mbarrier rings (see the header).

constexpr int kWgThreads = 128;          // one warpgroup
constexpr int kSm90Threads = 3 * kWgThreads;
constexpr int kPanel = 64;               // bf16 columns in one 128-byte row
constexpr int kPanelRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // NEG_INF in the log2 domain

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase with parity `phase` has completed. A wait
// that never ends (a broken pipeline) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 26)) __trap();
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
    if (done) return;
  }
}

// One TMA load of a [rows, 64] bf16 box at (col, row, bh) of a 3-D tensor
// map over [B*H, L, Dh]; rows past L arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO). LBO is only read when an
// operand spans more than one 64-column swizzle atom in its strided
// direction, which no product here does; it is set to the group stride.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// The descriptor `byte_offset` bytes further into the same tile.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, int byte_offset) {
  return desc + (uint64_t)(byte_offset >> 4);
}

// A value the compiler must recompute where it stands: keeps the many
// descriptors derived from it (cheap adds) out of registers across a loop.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma issue/wait points.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define DPT_D8(b)                                                     \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),         \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define DPT_D32 DPT_D8(0), DPT_D8(8), DPT_D8(16), DPT_D8(24)
#define DPT_D64 DPT_D32, DPT_D8(32), DPT_D8(40), DPT_D8(48), DPT_D8(56)

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : DPT_D32
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DPT_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the bf16 fragment
// of an m64 accumulator's 16 columns), B from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : DPT_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// The bf16 A fragments of an m64 f32 accumulator of R registers:
// chunk c covers columns [16c, 16c + 16), as wgmma's register A takes them.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R],
                                         uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int c = 0; c < R / 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[c][r] = pack_bf16(d[8 * c + 2 * r], d[8 * c + 2 * r + 1]);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive on a named barrier without waiting: the threads that bar.sync on
// it see this thread's earlier shared-memory writes.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

constexpr int kSm90Tile = 128;   // forward query/key tile
constexpr int kSm90BwdQ = 64;    // backward query tile
constexpr int kStages = 2;       // depth of the K/V (forward) and Q/dO
                                 // (backward) rings

template <int DH>
constexpr int fwd_sm90_smem() {
  // Q, then kStages x (K, V), each 128 rows x DH bf16; barriers and flags
  return 1024 + (1 + 2 * kStages) * kSm90Tile * DH * 2 + 128;
}

// One CTA per (b*h, 128-row query tile): warpgroups 0 and 1 each own 64
// query rows and run the products and the online softmax; warp 0 of
// warpgroup 2 issues the TMA loads (Q once, K and V through a kStages
// ring). Query tiles are launched heaviest first (the last tile of a causal
// call has the most key tiles).
template <int DH>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const int* __restrict__ pad_mask,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int H, int L, int causal,
                      float scale) {
  constexpr int NP = DH / kPanel;                      // 64-column panels
  constexpr int kPanelBytes = kSm90Tile * kPanelRowBytes;   // 16 KB
  constexpr int kTileBytes = NP * kPanelBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + kTileBytes;                       // [kStages]
  uint8_t* sV = sK + kStages * kTileBytes;             // [kStages]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* tile_has_pad = reinterpret_cast<int*>(empty + kStages);

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kSm90Tile;
  const int n_kt = causal ? qt + 1 : (L + kSm90Tile - 1) / kSm90Tile;
  const int* mask_row = pad_mask ? pad_mask + (long long)(bh / H) * L : nullptr;
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x / 32 != 8) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kTileBytes);
      for (int p = 0; p < NP; ++p)
        tma_load(sQ + p * kPanelBytes, &tq, q_full, p * kPanel, q0, bh);
    }
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kStages;
      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
      const int k0 = j * kSm90Tile;
      int pad = 0;
      if (mask_row != nullptr)
        for (int c = k0 + lane; c < min(L, k0 + kSm90Tile); c += 32)
          pad |= mask_row[c] == 0;
      pad = __any_sync(0xffffffffu, pad);
      if (lane == 0) {
        tile_has_pad[s] = pad;
        mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(sK + s * kTileBytes + p * kPanelBytes, &tk, &full[s],
                   p * kPanel, k0, bh);
          tma_load(sV + s * kTileBytes + p * kPanelBytes, &tv, &full[s],
                   p * kPanel, k0, bh);
        }
      }
      __syncwarp();
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const int row0 = q0 + wg * 64 + warp * 16 + g;   // and row0 + 8
    const float sl2 = scale * kLog2e;
    float o[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p) zero(o[p]);
    float m2[2] = {kNegInf2, kNegInf2};   // running max, log2 domain
    float l[2] = {0.f, 0.f};              // this thread's share of the sum
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const int k0 = j * kSm90Tile;
      const uint64_t dQ = opaque(sw128_desc(sQ + wg * 8192));
      const uint64_t dK = opaque(sw128_desc(sK + s * kTileBytes));

      float sc[64];   // S = Q K^T: rows (g, g + 8), columns 8i + 2qd (+1)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / 4, c = (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_at(dQ, p * kPanelBytes + c),
                      desc_at(dK, p * kPanelBytes + c), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(sc);

      const bool masked = tile_has_pad[s] || (causal && j == n_kt - 1) ||
                          k0 + kSm90Tile > L;
      float mx[2];
      if (masked) {
        mx[0] = mx[1] = kNegInf2;
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = k0 + 8 * i + 2 * qd + (e & 1);
            const int r = row0 + (e >> 1) * 8;
            float x = sc[4 * i + e] * sl2;
            if (c >= L) {
              x = kNegInf2;
            } else {
              if (mask_row != nullptr && mask_row[c] == 0) x += kNegInf2;
              if (causal && c > r) x = kNegInf2;
            }
            sc[4 * i + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      } else {
        float a = sc[0], b = sc[2];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          a = fmaxf(a, fmaxf(sc[4 * i], sc[4 * i + 1]));
          b = fmaxf(b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
        }
        mx[0] = a * sl2;
        mx[1] = b * sl2;
      }
      float alpha[2], m_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_new[h] = fmaxf(m2[h], mx[h]);
        alpha[h] = exp2f(m2[h] - m_new[h]);
        m2[h] = m_new[h];
        l[h] *= alpha[h];
      }
      if (masked) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float x = sc[i];
          const float pr =
              x > kNegInf2 * 0.5f ? exp2f(x - m_new[(i >> 1) & 1]) : 0.f;
          sc[i] = pr;
          l[(i >> 1) & 1] += pr;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float pr = exp2f(fmaf(sc[i], sl2, -m_new[(i >> 1) & 1]));
          sc[i] = pr;
          l[(i >> 1) & 1] += pr;
        }
      }
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i >> 1) & 1];
      // O += P V: P (bf16, as the JAX kernel's p.astype(v.dtype)) from
      // registers, V from shared memory as an MN-major B
      uint32_t pa[8][4];
      acc_to_a(sc, pa);
      const uint64_t dV = opaque(sw128_desc(sV + s * kTileBytes));
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs_n64<1>(o[p], pa[kk],
                          desc_at(dV, p * kPanelBytes + kk * 2048));
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) reg_fence(o[p]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: normalize in registers, write out (bf16) and lse (f32)
    const long long base = (long long)bh * L;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int r = row0 + 8 * h;
      if (r >= L) continue;
      // a fully masked row has l == 0 and o == 0: zeros, not NaN
      const float inv = 1.f / fmaxf(l[h], 1e-20f);
      uint32_t* orow =
          reinterpret_cast<uint32_t*>(out + (base + r) * DH) + qd;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          orow[p * 32 + i * 4] = pack_bf16(o[p][4 * i + 2 * h] * inv,
                                           o[p][4 * i + 2 * h + 1] * inv);
      if (qd == 0)
        lse[base + r] = m2[h] / kLog2e + logf(fmaxf(l[h], 1e-20f));
    }
  }
}

// The backward's CTA: consumer warpgroups of 64 key rows each, and one
// producer warpgroup. At Dh=128 one warpgroup's dK and dV accumulators
// alone take 128 registers a thread, which fits only under the 255-register
// cap of a 256-thread CTA (a 384-thread CTA compiles under 168 and spills),
// so Dh=128 runs one consumer warpgroup on a 64-row key tile.
template <int DH>
struct BwdShape {
  static constexpr int kConsumers = DH == 64 ? 2 : 1;
  static constexpr int kKeys = 64 * kConsumers;           // key tile rows
  static constexpr int kThreads = (kConsumers + 1) * kWgThreads;
  // f32 [64 x DH] where warpgroup 1 hands its dq part to warpgroup 0
  static constexpr int kFold = (kConsumers - 1) * 64 * DH;
};

template <int DH>
constexpr int bwd_sm90_smem() {
  // K, V (kKeys rows each), kStages x (Q, dO) (64 rows each), one 64 x 64
  // bf16 dS^T tile per consumer warpgroup, the dq fold, kStages x (lse,
  // delta) rows, barriers
  return 1024 + 2 * BwdShape<DH>::kKeys * DH * 2 +
         2 * kStages * kSm90BwdQ * DH * 2 +
         BwdShape<DH>::kConsumers * 64 * 64 * 2 + BwdShape<DH>::kFold * 4 +
         2 * kStages * kSm90BwdQ * 4 + 128;
}

// One CTA per (b*h, key tile), K and V resident: each consumer warpgroup
// owns 64 key rows; warp 0 of the last warpgroup streams the live 64-row
// query tiles (Q, dO by TMA; lse and delta rows) through a kStages ring.
// The key tile sits on wgmma's M dimension, so P^T and dS^T are
// accumulators and feed dV and dK as register A operands. Five products a
// (query tile, key tile) pair:
//   S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, dQ_part = dS K
// dQ_part goes with plain stores into the CTA's own f32 plane
// (dq_part + blockIdx.y * plane), rows q0.. of the query tile; with two
// consumer warpgroups, warpgroup 1 first hands its part to warpgroup 0
// through shared memory (named barriers 3 and 4), which adds it to its own
// and stores the sum. No two CTAs write one element and every sum has a
// fixed order, so dq is the same bits on every run. A launch covers key
// tiles kt_begin + blockIdx.y. Key tiles are launched heaviest first (tile
// 0 of a causal call has the most query tiles).
template <int DH>
__global__ void __launch_bounds__(BwdShape<DH>::kThreads, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const int* __restrict__ pad_mask,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq_part, long long plane,
                      int kt_begin,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int L,
                      int causal, float scale) {
  constexpr int NP = DH / kPanel;
  constexpr int kConsumers = BwdShape<DH>::kConsumers;
  constexpr int kKeys = BwdShape<DH>::kKeys;
  constexpr int kKVPanel = kKeys * kPanelRowBytes;
  constexpr int kQPanel = kSm90BwdQ * kPanelRowBytes;     // 8 KB
  constexpr int kKVBytes = NP * kKVPanel;
  constexpr int kQBytes = NP * kQPanel;
  constexpr int kDSBytes = 64 * 64 * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + kKVBytes;
  uint8_t* sQ = sV + kKVBytes;                       // [kStages]
  uint8_t* sdO = sQ + kStages * kQBytes;             // [kStages]
  uint8_t* sdS = sdO + kStages * kQBytes;            // [kConsumers]
  float* sFold =
      reinterpret_cast<float*>(sdS + kConsumers * kDSBytes);  // [kFold]
  float* sLse = sFold + BwdShape<DH>::kFold;                   // [kStages][64]
  float* sDelta = sLse + kStages * kSm90BwdQ;                    // [kStages][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDelta + kStages * kSm90BwdQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int k0 = (kt_begin + blockIdx.y) * kKeys;
  const int q_begin = causal ? k0 : 0;
  const int n_qt = (L - q_begin + kSm90BwdQ - 1) / kSm90BwdQ;
  const long long sbase = (long long)bh * L;
  const int* mask_row = pad_mask ? pad_mask + (long long)(bh / H) * L : nullptr;
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x / 32 != 4 * kConsumers) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * kKVBytes);
      for (int p = 0; p < NP; ++p) {
        tma_load(sK + p * kKVPanel, &tk, kv_full, p * kPanel, k0, bh);
        tma_load(sV + p * kKVPanel, &tv, kv_full, p * kPanel, k0, bh);
      }
    }
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % kStages;
      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
      const int q0 = q_begin + j * kSm90BwdQ;
      for (int r = lane; r < kSm90BwdQ; r += 32) {
        const bool in = q0 + r < L;
        sLse[s * kSm90BwdQ + r] = in ? lse[sbase + q0 + r] * kLog2e : 0.f;
        sDelta[s * kSm90BwdQ + r] = in ? delta[sbase + q0 + r] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(sQ + s * kQBytes + p * kQPanel, &tq, &full[s], p * kPanel,
                   q0, bh);
          tma_load(sdO + s * kQBytes + p * kQPanel, &tdo, &full[s],
                   p * kPanel, q0, bh);
        }
      }
      __syncwarp();
    }
  } else {
    // ---- consumers: 64 key rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const int kl0 = warp * 16 + g;                 // local key rows kl0, +8
    const int kr0 = k0 + wg * 64 + kl0;
    bool pad[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = kr0 + 8 * h;
      pad[h] = mask_row != nullptr && kr < L && mask_row[kr] == 0;
    }
    const float sl2 = scale * kLog2e;
    const int wg_rows = wg * 64 * kPanelRowBytes;  // this warpgroup's keys
    uint8_t* sds = sdS + wg * kDSBytes;
    float* my_plane = dq_part + (long long)blockIdx.y * plane;
    float dvacc[NP][32], dkacc[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      zero(dvacc[p]);
      zero(dkacc[p]);
    }
    mbar_wait(kv_full, 0);

    for (int j = 0; j < n_qt; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const int q0 = q_begin + j * kSm90BwdQ;
      // descriptors of this warpgroup's K and V rows, this stage's Q and
      // dO, and its dS^T tile
      const uint64_t dK = opaque(sw128_desc(sK + wg_rows));
      const uint64_t dV = opaque(sw128_desc(sV + wg_rows));
      const uint64_t dQ = opaque(sw128_desc(sQ + s * kQBytes));
      const uint64_t ddO = opaque(sw128_desc(sdO + s * kQBytes));
      const uint64_t ddS = opaque(sw128_desc(sds));
      const float* lse2 = sLse + s * kSm90BwdQ;
      const float* dl = sDelta + s * kSm90BwdQ;

      // S^T = K Q^T and dP^T = V dO^T: rows are keys (kl0, kl0 + 8),
      // columns queries 8i + 2qd (+1); dP^T runs while P^T is computed
      float st[32], dpt[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / 4, c = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(st, desc_at(dK, p * kKVPanel + c),
                           desc_at(dQ, p * kQPanel + c), kk > 0);
      }
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / 4, c = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(dpt, desc_at(dV, p * kKVPanel + c),
                           desc_at(ddO, p * kQPanel + c), kk > 0);
      }
      wg_commit();
      wg_wait<1>();
      reg_fence(st);

      // P^T = exp(S^T - lse) under the mask
      const bool masked = (causal && q0 < k0 + kKeys) ||
                          q0 + kSm90BwdQ > L || k0 + kKeys > L ||
                          pad[0] || pad[1];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * i + 2 * qd + (e & 1);
          float pr;
          if (masked) {
            const int h = e >> 1;
            const int kr = kr0 + 8 * h;
            float x = st[4 * i + e] * sl2;
            if (kr >= L) {
              x = kNegInf2;
            } else {
              if (pad[h]) x += kNegInf2;
              if (causal && kr > q0 + qc) x = kNegInf2;
            }
            pr = (q0 + qc < L && x > kNegInf2 * 0.5f) ? exp2f(x - lse2[qc])
                                                      : 0.f;
          } else {
            pr = exp2f(fmaf(st[4 * i + e], sl2, -lse2[qc]));
          }
          st[4 * i + e] = pr;
        }
      wg_wait<0>();
      reg_fence(dpt);

      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * i + e] =
              st[4 * i + e] * (dpt[4 * i + e] - dl[8 * i + 2 * qd + (e & 1)]);
      uint32_t pa[4][4], sa[4][4];
      acc_to_a(st, pa);
      acc_to_a(dpt, sa);
      // dS^T to shared memory as bf16, [key][query] with the 128-byte
      // swizzle, for dQ = dS K (an MN-major A)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kl = kl0 + 8 * h, qc = 8 * i + 2 * qd;
          *reinterpret_cast<uint32_t*>(sds + kl * kPanelRowBytes +
                                       (((qc >> 3) ^ (kl & 7)) << 4) +
                                       (qc & 7) * 2) =
              sa[i / 2][(i % 2) * 2 + h];
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, kWgThreads);

      // dV += P^T dO, dK += dS^T Q (dO and Q as MN-major B)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          wgmma_rs_n64<1>(dvacc[p], pa[kk],
                          desc_at(ddO, p * kQPanel + kk * 2048));
          wgmma_rs_n64<1>(dkacc[p], sa[kk],
                          desc_at(dQ, p * kQPanel + kk * 2048));
        }
      wg_commit();

      // dQ_part = dS K over this warpgroup's 64 keys, one 64-column panel
      // at a time; rows are queries (16 warp + g, + 8)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float dq[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64<1, 1>(dq, desc_at(ddS, kk * 2048),
                             desc_at(dK, p * kKVPanel + kk * 2048), kk > 0);
        wg_commit();
        wg_wait<0>();
        reg_fence(dq);
        if (p == 0) {
#pragma unroll
          for (int pp = 0; pp < NP; ++pp) {
            reg_fence(dvacc[pp]);
            reg_fence(dkacc[pp]);
          }
          if (lane == 0) mbar_arrive(&empty[s]);
        }
        if (kConsumers > 1) {
          // the same fragment layout in both warpgroups: thread tid of
          // warpgroup 1 holds the elements thread tid of warpgroup 0 holds
          float* fold = sFold + p * 64 * kPanel;
          if (wg == 1) {
            if (j > 0 || p > 0)
              named_sync(4, 2 * kWgThreads);  // warpgroup 0 read the last
#pragma unroll
            for (int e = 0; e < 32; ++e) fold[e * kWgThreads + tid] = dq[e];
            named_arrive(3, 2 * kWgThreads);
            continue;
          }
          named_sync(3, 2 * kWgThreads);
#pragma unroll
          for (int e = 0; e < 32; ++e) dq[e] += fold[e * kWgThreads + tid];
          named_arrive(4, 2 * kWgThreads);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qr = q0 + kl0 + 8 * h;
          if (qr >= L) continue;
          float2* dst = reinterpret_cast<float2*>(
              my_plane + (sbase + qr) * DH + p * kPanel + 2 * qd);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dst[4 * i] = make_float2(dq[4 * i + 2 * h], dq[4 * i + 2 * h + 1]);
        }
      }
    }
    // the last hand-over's arrival on barrier 4 is consumed here
    if (kConsumers > 1 && wg == 1 && n_qt > 0) named_sync(4, 2 * kWgThreads);

    // epilogue: dK carries the softmax scale; dK, dV as bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = kr0 + 8 * h;
      if (kr >= L) continue;
      const long long off = (sbase + kr) * DH;
      uint32_t* dkrow = reinterpret_cast<uint32_t*>(dk + off) + qd;
      uint32_t* dvrow = reinterpret_cast<uint32_t*>(dv + off) + qd;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dkrow[p * 32 + i * 4] =
              pack_bf16(dkacc[p][4 * i + 2 * h] * scale,
                        dkacc[p][4 * i + 2 * h + 1] * scale);
          dvrow[p * 32 + i * 4] =
              pack_bf16(dvacc[p][4 * i + 2 * h], dvacc[p][4 * i + 2 * h + 1]);
        }
    }
  }
}

// delta = rowsum(dO * O) in f32, 16 bytes of each a thread.
template <typename T, int DH>
__global__ void __launch_bounds__(256)
flash_bwd_preprocess_kernel(const T* __restrict__ dout,
                            const T* __restrict__ out,
                            float* __restrict__ delta, long long rows) {
  constexpr int E = 16 / sizeof(T);   // elements a thread
  constexpr int TPR = DH / E;         // threads a row (8 to 32: one warp's
                                      // aligned lanes)
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long row = idx / TPR;
  const int part = idx % TPR;
  const bool valid = row < rows;
  const long long off = row * DH + part * E;
  float acc = 0.f;
  if (valid) {
    const uint4 a = *reinterpret_cast<const uint4*>(dout + off);
    const uint4 b = *reinterpret_cast<const uint4*>(out + off);
    const T* ta = reinterpret_cast<const T*>(&a);
    const T* tb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int e = 0; e < E; ++e) acc = fmaf(to_f32(ta[e]), to_f32(tb[e]), acc);
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (valid && part == 0) delta[row] = acc;
}

// Sums one launch's dq planes, four elements a thread, in a fixed order:
// the running sum of the earlier launches (dq_accum, when `first` is 0),
// then the planes of key tiles kt_begin.. ascending. A causal call's key
// tile kt wrote only query rows >= its first key (kt * keys); the other
// rows of its plane hold stale bytes and are skipped. The last launch
// writes dq = bf16(sum * scale), the others the running sum. Bound by
// bytes: each plane element is read once.
__global__ void __launch_bounds__(256)
flash_bwd_dq_reduce_kernel(const float4* __restrict__ dq_part,
                           float4* __restrict__ dq_accum,
                           uint2* __restrict__ dq, long long plane4,
                           int L, int DH, int keys, int kt_begin, int n_kt,
                           int causal, int first, int last, float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= plane4) return;
  const int r = (int)((i * 4 / DH) % L);   // the query row in its sequence
  float4 a = first ? make_float4(0.f, 0.f, 0.f, 0.f) : dq_accum[i];
  for (int t = 0; t < n_kt; ++t) {
    if (causal && (kt_begin + t) * keys > r) break;
    const float4 b = dq_part[(long long)t * plane4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  if (last)
    dq[i] = make_uint2(pack_bf16(a.x * scale, a.y * scale),
                       pack_bf16(a.z * scale, a.w * scale));
  else
    dq_accum[i] = a;
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled lives in libcuda; the runtime looks it up, so the
// library needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A TMA map over a contiguous bf16 [B*H, L, Dh] tensor that loads boxes of
// [rows, 64] into 128-byte-swizzled shared memory; rows past L read zeros.
cudaError_t make_tile_map(CUtensorMap* map, const void* base, int BH, int L,
                          int DH, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)DH * 2,
                                 (cuuint64_t)L * DH * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch_fwd_sm90(const void* q, const void* k, const void* v,
                            const int* pad_mask, void* out, float* lse, int B,
                            int H, int L, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_tile_map(&tq, q, B * H, L, DH, kSm90Tile)) != cudaSuccess ||
      (err = make_tile_map(&tk, k, B * H, L, DH, kSm90Tile)) != cudaSuccess ||
      (err = make_tile_map(&tv, v, B * H, L, DH, kSm90Tile)) != cudaSuccess)
    return err;
  constexpr int smem = fwd_sm90_smem<DH>();
  static bool smem_set = false;  // once per instantiation (per process)
  if (!smem_set) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (L + kSm90Tile - 1) / kSm90Tile);
  flash_fwd_sm90_kernel<DH><<<grid, kSm90Threads, smem, stream>>>(
      tq, tk, tv, pad_mask, static_cast<__nv_bfloat16*>(out), lse, H, L,
      causal, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_preprocess(const void* dout, const void* out, float* delta,
                              long long rows, cudaStream_t stream) {
  constexpr int tpr = DH * (int)sizeof(T) / 16;   // threads a row
  flash_bwd_preprocess_kernel<T, DH><<<(unsigned)((rows * tpr + 255) / 256),
                                       256, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(out), delta, rows);
  return cudaGetLastError();
}

// The key tiles go in launches of `kt_per_launch` (the planes' scratch is
// capped by the caller), each followed by the reduce of its planes; with
// one launch dq_accum is not used and may be null.
template <int DH>
cudaError_t launch_bwd_sm90(const void* q, const void* k, const void* v,
                            const int* pad_mask, const void* dout,
                            const void* out, const float* lse, float* delta,
                            float* dq_part, float* dq_accum, void* dq,
                            void* dk, void* dv, int B, int H, int L,
                            int causal, int kt_per_launch,
                            cudaStream_t stream) {
  constexpr int keys = BwdShape<DH>::kKeys;
  const int n_kt = (L + keys - 1) / keys;
  if (dq_part == nullptr || kt_per_launch < 1 ||
      (kt_per_launch < n_kt && dq_accum == nullptr))
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * H * L;
  cudaError_t err =
      launch_preprocess<__nv_bfloat16, DH>(dout, out, delta, rows, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if ((err = make_tile_map(&tq, q, B * H, L, DH, kSm90BwdQ)) != cudaSuccess ||
      (err = make_tile_map(&tk, k, B * H, L, DH, BwdShape<DH>::kKeys)) !=
          cudaSuccess ||
      (err = make_tile_map(&tv, v, B * H, L, DH, BwdShape<DH>::kKeys)) !=
          cudaSuccess ||
      (err = make_tile_map(&tdo, dout, B * H, L, DH, kSm90BwdQ)) !=
          cudaSuccess)
    return err;
  constexpr int smem = bwd_sm90_smem<DH>();
  static bool smem_set = false;  // once per instantiation (per process)
  if (!smem_set) {
    err = cudaFuncSetAttribute(flash_bwd_sm90_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const float scale = 1.0f / sqrtf((float)DH);
  const long long plane = rows * DH;
  const long long plane4 = plane / 4;
  for (int kt0 = 0; kt0 < n_kt; kt0 += kt_per_launch) {
    const int nk = kt_per_launch < n_kt - kt0 ? kt_per_launch : n_kt - kt0;
    const dim3 grid(B * H, nk);
    flash_bwd_sm90_kernel<DH><<<grid, BwdShape<DH>::kThreads, smem,
                                stream>>>(
        tq, tk, tv, tdo, pad_mask, lse, delta, dq_part, plane, kt0,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
        L, causal, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    flash_bwd_dq_reduce_kernel<<<(unsigned)((plane4 + 255) / 256), 256, 0,
                                 stream>>>(
        reinterpret_cast<const float4*>(dq_part),
        reinterpret_cast<float4*>(dq_accum), static_cast<uint2*>(dq), plane4,
        L, DH, keys, kt0, nk, causal, kt0 == 0, kt0 + nk >= n_kt, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
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
    return (int)launch_fwd_sm90<64>(q, k, v, pad_mask, out, lse, B, H, L,
                                    causal, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_fwd_sm90<128>(q, k, v, pad_mask, out, lse, B, H, L,
                                     causal, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: delta = rowsum(dO * O) into `delta` ([B, H, L] f32), then
// for float32 the dk/dv and dq kernels, for bfloat16 the one-pass kernel in
// launches of `kt_per_launch` key tiles, each followed by the fixed-order
// sum of its dq planes (`dq_part`, one [B, H, L, Dh] f32 plane a key tile
// of the launch; `dq_accum`, one more, when there is more than one
// launch). All on one stream.
int dpt_flash_bwd(const void* q, const void* k, const void* v,
                  const int* pad_mask, const void* dout, const void* out,
                  const float* lse, float* delta, float* dq_part,
                  float* dq_accum, void* dq, void* dk, void* dv, int B, int H,
                  int L, int head_dim, int causal, int dtype,
                  int kt_per_launch, void* stream) {
  if (B == 0 || H == 0 || L == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * H * L;
  if (dtype == 0 && (head_dim == 64 || head_dim == 128)) {
    cudaError_t err =
        head_dim == 64
            ? launch_preprocess<float, 64>(dout, out, delta, rows, s)
            : launch_preprocess<float, 128>(dout, out, delta, rows, s);
    if (err != cudaSuccess) return (int)err;
    return head_dim == 64
               ? (int)launch_bwd<float, 64>(q, k, v, pad_mask, dout, lse,
                                            delta, dq, dk, dv, B, H, L,
                                            causal, s)
               : (int)launch_bwd<float, 128>(q, k, v, pad_mask, dout, lse,
                                             delta, dq, dk, dv, B, H, L,
                                             causal, s);
  }
  if (dtype == 1 && head_dim == 64)
    return (int)launch_bwd_sm90<64>(q, k, v, pad_mask, dout, out, lse, delta,
                                    dq_part, dq_accum, dq, dk, dv, B, H, L,
                                    causal, kt_per_launch, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_bwd_sm90<128>(q, k, v, pad_mask, dout, out, lse, delta,
                                     dq_part, dq_accum, dq, dk, dv, B, H, L,
                                     causal, kt_per_launch, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of the bf16 forward (backward = 0) or
// backward (1) kernel at head_dim 64 or 128; -1 for anything else.
int dpt_flash_smem_bytes(int backward, int head_dim) {
  if (head_dim == 64)
    return backward ? bwd_sm90_smem<64>() : fwd_sm90_smem<64>();
  if (head_dim == 128)
    return backward ? bwd_sm90_smem<128>() : fwd_sm90_smem<128>();
  return -1;
}

}  // extern "C"
