// threefry2x32 and jax.random's uniform, as device code, bit-identical to
// happysim_tpu_torch/rng.py (and so to jax.random with
// jax_threefry_partitionable on).
//
// A uniform is a pure function of a key and its position: element i of
// uniform(key, shape, lo, hi) is made from the bits b0 ^ b1 of
// threefry2x32(key, (0, i)), so a kernel draws exactly the elements it
// reads, in any order, with no draw block in device memory. The event-step
// kernel (event_step.cuh) and the standalone draw kernel (uniform.cu) use
// it. Everything here is 32-bit integer arithmetic plus one double
// multiply-add; the CUDA intrinsics sit behind the shim below, so the
// header also compiles as host C++ (the CPU tests build it with g++).
//
// Cost: one threefry2x32 is 20 rounds of an add, a rotate and a xor, plus
// 5 key injections of an add and an add-with-constant, plus the key
// schedule: HS_THREEFRY_OPS integer operations (kernels/support.py counts
// the operations bound from it).

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define HS_RNG_FN __device__ __forceinline__
#else
#define HS_RNG_FN inline
#endif

// 2 (key schedule) + 2 (initial injection) + 20 * 3 (rounds) + 5 * 3
// (injections: two adds and the round constant).
#define HS_THREEFRY_OPS 79

struct HsKey {
  uint32_t k0, k1;
};

HS_RNG_FN uint32_t hs_rotl32(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

HS_RNG_FN float hs_bits_as_float(uint32_t bits) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(bits);
#else
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
#endif
}

// threefry2x32 with 20 rounds on the block (x0, x1) under key (k0, k1);
// rng.py::threefry2x32.
HS_RNG_FN void hs_threefry2x32(HsKey key, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {key.k0, key.k1, key.k0 ^ key.k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i & 1) ? 17 : 13, r1 = (i & 1) ? 29 : 15;
    const int r2 = (i & 1) ? 16 : 26, r3 = (i & 1) ? 24 : 6;
    x0 += x1; x1 = hs_rotl32(x1, r0) ^ x0;
    x0 += x1; x1 = hs_rotl32(x1, r1) ^ x0;
    x0 += x1; x1 = hs_rotl32(x1, r2) ^ x0;
    x0 += x1; x1 = hs_rotl32(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// jax.random.fold_in(key, data): the key threefry(key, (0, data)).
HS_RNG_FN HsKey hs_fold_in(HsKey key, uint32_t data) {
  uint32_t x0 = 0, x1 = data;
  hs_threefry2x32(key, x0, x1);
  return HsKey{x0, x1};
}

// Element `index` of jax.random.uniform(key, shape, float32, lo, lo +
// span): the mantissa trick on b0 ^ b1, then floats * span + lo in double
// (the product is exact, so this is XLA's fused multiply-add rounded once
// to double and once to float), then max(lo, .). rng.py::uniform.
HS_RNG_FN float hs_uniform_at(HsKey key, uint32_t index, float lo, float span) {
  uint32_t x0 = 0, x1 = index;
  hs_threefry2x32(key, x0, x1);
  const float floats = hs_bits_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
  const float scaled = (float)fma((double)floats, (double)span, (double)lo);
  return fmaxf(lo, scaled);
}
