// Fused AdamW + EMA update for Hopper (sm_90a): one pass over every state
// copy of the trainer's flat f32 buffers, in place.
//
// Replaces the TPU kernel distributed_pipeline_tpu/ops/fused_update.py
// `_update_kernel` (reached through `_leaf_update` / `fused_adamw_ema`). The
// TPU version runs one pallas_call per parameter leaf over [rows, 128]
// blocks; here the trainer keeps params, grads, mu, nu and the R EMA copies
// each as ONE flat buffer, so one launch covers every leaf.
//
// What bounds it: bytes. Per element it reads p, g, mu, nu and R EMA values
// and writes p, mu, nu and R EMA values, (4 + R) + (3 + R) f32 words, for
// 16 + 3R f32 operations: far below the ~295 flop/byte where compute would
// matter.
// The census is `update_hbm_bytes` in ops/fused_update.py. The design does
// the one thing that matters for a streaming kernel: every word is read
// once and written once, by neighbouring threads at neighbouring addresses
// (a grid-stride loop, 4-byte accesses).
//
// Bit-exactness: the body replays optax's op order exactly, and rounds where
// separate torch ops round. Every product and sum is written with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), which nvcc never contracts into an FMA, so the result equals
// the plain version's chain of torch ops bit for bit:
//   mu' = (1-b1)*g + b1*mu
//   nu' = (1-b2)*(g*g) + b2*nu
//   u   = (mu'/bc1) / (sqrt(nu'/bc2) + eps)
//   u   = u + wd*p;  u = (-lr)*u;  p' = p + u
//   e'  = e*r + p'*(1-r)        for each EMA rate r
// The constants (1-b1, 1-b2, 1-r) come in already rounded from double to
// float, as the JAX weak-typed constants are; (-lr, bc1, bc2) are read from
// a [3] f32 device tensor, so a step never needs the host.
//
// Layouts (all contiguous f32, n elements each):
//   p, g, mu, nu [n];  ema [R, n];  scalars [3] = (-lr, bc1, bc2)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRates = 8;

struct Coefs {
  float b1, omb1, b2, omb2, eps, wd;
  float rate[kMaxRates];
  float om_rate[kMaxRates];
  int n_rates;
};

__global__ void __launch_bounds__(kThreads)
fused_update_kernel(float* __restrict__ p, const float* __restrict__ g,
                    float* __restrict__ mu, float* __restrict__ nu,
                    float* __restrict__ ema, const float* __restrict__ scalars,
                    long long n, Coefs c) {
  const float step_size = scalars[0];
  const float bc1 = scalars[1];
  const float bc2 = scalars[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float pi = p[i];
    const float m = __fadd_rn(__fmul_rn(c.omb1, gi), __fmul_rn(c.b1, mu[i]));
    const float v = __fadd_rn(__fmul_rn(c.omb2, __fmul_rn(gi, gi)),
                              __fmul_rn(c.b2, nu[i]));
    float u = __fdiv_rn(__fdiv_rn(m, bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps));
    u = __fadd_rn(u, __fmul_rn(c.wd, pi));
    u = __fmul_rn(step_size, u);
    const float pn = __fadd_rn(pi, u);
    p[i] = pn;
    mu[i] = m;
    nu[i] = v;
    // unrolled over the fixed slots so every rate is read from the
    // parameter bank directly (a runtime-indexed loop puts `c` in local
    // memory)
#pragma unroll
    for (int r = 0; r < kMaxRates; ++r) {
      if (r < c.n_rates) {
        float* e = ema + (long long)r * n + i;
        *e = __fadd_rn(__fmul_rn(*e, c.rate[r]), __fmul_rn(pn, c.om_rate[r]));
      }
    }
  }
}

}  // namespace

extern "C" {

// coefs (host memory): b1, 1-b1, b2, 1-b2, eps, wd, then n_rates rates and
// n_rates values of 1-rate. Returns a cudaError_t (0 = launched). The launch
// is asynchronous on `stream`; nothing is allocated here.
int dpt_fused_update(void* p, const void* g, void* mu, void* nu, void* ema,
                     const void* scalars, long long n, const float* coefs,
                     int n_rates, void* stream) {
  if (n_rates < 0 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Coefs c;
  c.b1 = coefs[0];
  c.omb1 = coefs[1];
  c.b2 = coefs[2];
  c.omb2 = coefs[3];
  c.eps = coefs[4];
  c.wd = coefs[5];
  c.n_rates = n_rates;
  for (int r = 0; r < kMaxRates; ++r) {
    c.rate[r] = r < n_rates ? coefs[6 + r] : 0.f;
    c.om_rate[r] = r < n_rates ? coefs[6 + n_rates + r] : 0.f;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond this
  fused_update_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<float*>(ema), static_cast<const float*>(scalars), n, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
