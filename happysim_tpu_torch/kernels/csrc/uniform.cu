// Per-replica uniform draw: out[r, i] = uniform(fold_in(key_r, purpose),
// (n,), lo, lo + span)[i] for every replica r and every i < n, built with
// nvcc into a shared library and loaded through ctypes by
// kernels/uniform.py.
//
// It replaces the draws of happysim_tpu/tpu/chain.py's closed form
// (replica_uniform, jax.random.uniform at :345 under vmap), which the TPU
// runs as XLA's fused threefry; there is no Pallas kernel behind it. The
// chain form draws one (R, n_customers, *extra) block per purpose, about
// 10^8 uniforms a purpose at 65,536 replicas of the M/M/1.
//
// What bounds it on this card: integer operations. Each element costs one
// threefry2x32 (HS_THREEFRY_OPS operations) and a few more for the float,
// against 4 bytes written. Its rotates and xors issue only on the 64
// INT32 lanes of an SM (16.7 Tops/s on the card); its adds may also go to
// the FMA pipe as IMAD. tools/sass_mix.py counts the compiled loop's
// instructions by pipe: the INT32 lanes bound it, several times the 3.35
// TB/s bytes bound. The design spends nothing else: a
// block of HS_UNIFORM_THREADS threads covers a contiguous run of one
// replica's row, so the stores coalesce, and one fold_in per block (made
// by thread 0 into shared memory) serves all its elements.

#include <cuda_runtime.h>

#include "threefry.cuh"

#define HS_UNIFORM_THREADS 256
#define HS_UNIFORM_PER_THREAD 4

__global__ void __launch_bounds__(HS_UNIFORM_THREADS)
uniform_kernel(const uint32_t* __restrict__ keys, long long n, uint32_t purpose, float lo,
               float span, float* __restrict__ out) {
  __shared__ HsKey key;
  const int r = blockIdx.x;
  if (threadIdx.x == 0) key = hs_fold_in(HsKey{keys[2 * r], keys[2 * r + 1]}, purpose);
  __syncthreads();
  const long long span_per_block = (long long)HS_UNIFORM_THREADS * HS_UNIFORM_PER_THREAD;
  float* row = out + (long long)r * n;
  for (long long base = (long long)blockIdx.y * span_per_block; base < n;
       base += (long long)gridDim.y * span_per_block) {
#pragma unroll
    for (int j = 0; j < HS_UNIFORM_PER_THREAD; ++j) {
      const long long i = base + (long long)j * HS_UNIFORM_THREADS + threadIdx.x;
      if (i < n) row[i] = hs_uniform_at(key, (uint32_t)i, lo, span);
    }
  }
}

extern "C" int hs_uniform_threefry_ops() { return HS_THREEFRY_OPS; }

// keys: (R, 2) uint32; out: (R, n) float32, n < 2^32. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_uniform(const uint32_t* keys, int R, long long n, unsigned int purpose,
                          float lo, float span, float* out, void* stream) {
  if (R <= 0 || n <= 0) return 0;
  if (n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)HS_UNIFORM_THREADS * HS_UNIFORM_PER_THREAD;
  long long chunks = (n + per_block - 1) / per_block;
  if (chunks > 65535) chunks = 65535;
  const dim3 grid((unsigned)R, (unsigned)chunks);
  uniform_kernel<<<grid, HS_UNIFORM_THREADS, 0, (cudaStream_t)stream>>>(keys, n, purpose, lo,
                                                                          span, out);
  return (int)cudaGetLastError();
}
