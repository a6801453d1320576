// The M/M/1 ensemble's Lindley recursion, one thread per replica, built with
// nvcc into a shared library and loaded through ctypes by
// kernels/mm1_scan.py.
//
// It replaces the lax.scan of happysim_tpu/tpu/mm1.py:67 (_mm1_scan), which
// XLA compiles into a loop over customers; there is no Pallas kernel behind
// it. Customer i of replica r draws elements r and R + r of
// uniform(fold_in(key, i), (2, R), 1e-12, 1.0) (threefry.cuh), and
//
//   w     = max(0, fma(-log(u1), 1/mu, w) - (-log(u0)) * (1/lam))
//   sum_w = sum_w + w,  sum_sq = fma(w, w, sum_sq),
//   sum_s = fma(-log(u1), 1/mu, sum_s)                       (i >= warmup)
//
// with each multiply-add rounded once where XLA's CPU backend contracts it
// (the subtraction of the interarrival too) and the divisions by the static
// rates as products with their float32 reciprocals, as XLA folds them. The
// multiply-adds are evaluated in double, as numerics.fma_f32 does, so the
// kernel and plain_mm1_scan agree bit for bit.
//
// What bounds it on this card: integer operations. A customer costs two
// threefry2x32 evaluations (about 166 integer operations, their rotates
// and xors on the 64 INT32 lanes of an SM alone; tools/sass_mix.py counts
// the compiled loop by pipe) against a dozen float operations and no
// memory traffic: each lane keeps w and its three
// sums in registers over the whole scan and writes 12 bytes at the end. The
// step keys fold_in(key, i) are the same for every lane, so a block's
// threads fold HS_MM1_TILE of them at once into shared memory, one fold a
// thread, and every lane of the block reads them from there: one fold per
// HS_MM1_TILE customers a lane instead of one per customer.

#include <cuda_runtime.h>

#include "threefry.cuh"

#define HS_MM1_THREADS 256
// Customers whose step keys a block holds at once.
#define HS_MM1_TILE 256

__device__ __forceinline__ float hs_fma_f64(float a, float b, float c) {
  return (float)((double)c + (double)a * (double)b);
}

// Lane r = blockIdx.x * blockDim.x + threadIdx.x runs replica first + r
// of R (a shard of a replica mesh runs its slab, `count` lanes from
// `first`; -1: every replica from `first`) and writes its sums at r. The
// block's threads fold the tile's step keys in turn (one each on the card;
// a block of one thread folds them all, as the host build of the tests
// runs it).
__global__ void __launch_bounds__(HS_MM1_THREADS)
mm1_scan_kernel(const uint32_t* __restrict__ run_key, int R, int n, int warmup, float lo,
                float span, float inv_lam, float inv_mu, float* __restrict__ sum_w,
                float* __restrict__ sum_sq, float* __restrict__ sum_s, int first = 0,
                int count = -1) {
  __shared__ HsKey step_keys[HS_MM1_TILE];
  const HsKey key{run_key[0], run_key[1]};
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int lanes = count < 0 ? R - first : count;
  const int r = first + lane;  // the replica, which keys its draws
  float w = 0.0f, sw = 0.0f, sq = 0.0f, ss = 0.0f;
  for (int base = 0; base < n; base += HS_MM1_TILE) {
    const int tile = min(HS_MM1_TILE, n - base);
    __syncthreads();  // every lane is done with the previous tile's keys
    for (int j = threadIdx.x; j < tile; j += blockDim.x)
      step_keys[j] = hs_fold_in(key, (uint32_t)(base + j));
    __syncthreads();
    if (lane >= lanes) continue;
    for (int j = 0; j < tile; ++j) {
      const HsKey k = step_keys[j];
      const float a = -logf(hs_uniform_at(k, (uint32_t)r, lo, span));
      const float s = -logf(hs_uniform_at(k, (uint32_t)R + (uint32_t)r, lo, span));
      w = fmaxf(0.0f, hs_fma_f64(-a, inv_lam, hs_fma_f64(s, inv_mu, w)));
      if (base + j >= warmup) {
        sw = sw + w;
        sq = hs_fma_f64(w, w, sq);
        ss = hs_fma_f64(s, inv_mu, ss);
      }
    }
  }
  if (lane < lanes) {
    sum_w[lane] = sw;
    sum_sq[lane] = sq;
    sum_s[lane] = ss;
  }
}

#ifdef __CUDACC__
// Lanes a thread block: each block folds every step key once.
extern "C" int hs_mm1_scan_threads() { return HS_MM1_THREADS; }

// key: the run's (2,) uint32 key in device memory; replicas first, ...,
// first + count - 1 of R; sums: (count,) float32 each, 2R < 2^32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_mm1_scan(const uint32_t* key, int R, int first, int count, int n, int warmup,
                           float lo, float span, float inv_lam, float inv_mu, float* sum_w,
                           float* sum_sq, float* sum_s, void* stream) {
  if (count <= 0) return 0;
  if ((long long)R * 2 > 0xFFFFFFFFLL || n < 0 || first < 0 || (long long)first + count > R)
    return (int)cudaErrorInvalidValue;
  const int grid = (count + HS_MM1_THREADS - 1) / HS_MM1_THREADS;
  mm1_scan_kernel<<<grid, HS_MM1_THREADS, 0, (cudaStream_t)stream>>>(
      key, R, n, warmup, lo, span, inv_lam, inv_mu, sum_w, sum_sq, sum_s, first, count);
  return (int)cudaGetLastError();
}
#endif
