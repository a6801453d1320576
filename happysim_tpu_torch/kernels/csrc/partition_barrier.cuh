// One lane of the partitioned executor's window barrier: the argument
// struct and the lane's work, shared by the barrier kernel
// (partition_barrier.cu) and the event-step kernel's partitioned
// instantiations (event_step.cuh, PRT), which run it at a launch's start
// for the previous window when the barrier is folded into the next
// window's launch. It also compiles as host C++.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launch arguments. The layout must match
// kernels/partition_barrier.py::_BarrierArgs.
struct BarrierArgs {
  float* t;                  // (P R,)
  float* depth_int;          // (P R, nV)
  const int* q_len;          // (P R, nV)
  float* tr_time;            // (P R, nV, TR)
  float* tr_created;         // (P R, nV, TR)
  int* tr_attempt;           // (P R, nV, TR), null without backoff retries
  int* tr_dropped;           // (P R, nV)
  int* tr_hi;                // (P R, nV) each transit row's occupancy bound
  float* ob_arrival;         // (P R, OB)
  float* ob_created;         // (P R, OB)
  int* ob_ingress;           // (P R, OB)
  int* ob_len;               // (P R,)
  const float* in_arrival;   // (R, OB) partition 0's inbox
  const float* in_created;   // (R, OB)
  const int* in_ingress;     // (R, OB)
  const int* in_len;         // (R,)
  int P, R, nV, TR, OB;
  float window_end, warmup;
};

// c + a * b rounded once (event_step.cuh's fma_f64; -fmad=false keeps the
// double ops apart).
__device__ __forceinline__ float hs_barrier_fma(float a, float b, float c) {
  return (float)((double)c + (double)a * (double)b);
}

// Park a job in the first free (+inf) slot of a server's TR transit
// registers: its arrival time, its creation time and, where the model has
// them (a non-null row), attempt number 0; false when none is free. The
// search stops at the row's occupancy bound *hi, every slot from which on
// is free: the first free slot below it, else the bound's own slot, which
// raises it. This is the event step's into_transit (event_step.cuh, PRT)
// line for line on plain rows, so a merged job lands where the event step
// would park it: the JAX engine's _into_transit. The event step keeps its
// own loop: routed through one shared routine, its chaos instantiation
// took 1.055x the parent's time a block at the same registers, against
// 1.010x with its own loop, in one call of tools/ab_parent.py on an H100.
// tests/test_torch_partitioned_kernel.py holds the two equal through the
// plain versions.
__device__ __forceinline__ bool hs_transit_park(float* time, float* created, int* attempts,
                                                int* hi, int TR, float arrival,
                                                float created_at) {
  const int n = *hi;
  int c = 0;
  while (c < n && !isinf(time[c])) ++c;
  if (c == TR) return false;
  time[c] = arrival;
  created[c] = created_at;
  if (attempts) attempts[c] = 0;
  if (c == n && !isinf(arrival)) *hi = n + 1;
  return true;
}

// Whether a launch over these arguments is well formed: the sizes, and
// every pointer but the optional attempt rows.
inline bool hs_barrier_args_ok(const BarrierArgs& a) {
  return a.P >= 1 && a.R >= 0 && a.nV >= 1 && a.TR >= 1 && a.OB >= 1 && a.t && a.depth_int &&
         a.q_len && a.tr_time && a.tr_created && a.tr_dropped && a.tr_hi && a.ob_arrival &&
         a.ob_created && a.ob_ingress && a.ob_len && a.in_arrival && a.in_created &&
         a.in_ingress && a.in_len;
}

// The barrier of lane i of the P R partition-major lanes (see
// partition_barrier.cu): the close-out, the clock, the merge of its ring
// predecessor's outbox and that outbox's reset.
__device__ __forceinline__ void hs_barrier_lane(const BarrierArgs& a, long long i) {
  const int p = (int)(i / a.R);
  const int r = (int)(i - (long long)p * a.R);
  const int nV = a.nV, TR = a.TR, OB = a.OB;
  // The outbox this lane merges, and the lane whose outbox it resets.
  const long long src = p > 0 ? i - a.R : r;
  const float* arrival = (p > 0 ? a.ob_arrival : a.in_arrival) + src * OB;
  const float* created = (p > 0 ? a.ob_created : a.in_created) + src * OB;
  const int* ingress = (p > 0 ? a.ob_ingress : a.in_ingress) + src * OB;
  const int n = p > 0 ? a.ob_len[src] : a.in_len[src];
  const long long cleared = p > 0 ? i - a.R : (long long)(a.P - 1) * a.R + r;

  const float t = a.t[i];
  const float gap = fmaxf(a.window_end - fmaxf(t, a.warmup), 0.0f);
  for (int v = 0; v < nV; ++v) {
    float* cell = a.depth_int + i * nV + v;
    *cell = hs_barrier_fma((float)a.q_len[i * nV + v], gap, *cell);
  }
  a.t[i] = fmaxf(t, a.window_end);

  for (int j = 0; j < n; ++j) {
    const int v = ingress[j];
    const long long row = (i * nV + v) * TR;
    int* attempts = a.tr_attempt ? a.tr_attempt + row : nullptr;
    if (!hs_transit_park(a.tr_time + row, a.tr_created + row, attempts, a.tr_hi + i * nV + v, TR,
                         arrival[j], created[j]))
      a.tr_dropped[i * nV + v] += 1;
  }

  // A window writes only the entries below its outbox's length (the rest
  // hold the reset values since the last barrier or the initial state),
  // so resetting those resets the whole outbox.
  const int used = p > 0 ? n : a.ob_len[cleared];
  for (int j = 0; j < used; ++j) {
    a.ob_arrival[cleared * OB + j] = INFINITY;
    a.ob_created[cleared * OB + j] = 0.0f;
    a.ob_ingress[cleared * OB + j] = 0;
  }
  a.ob_len[cleared] = 0;
}
