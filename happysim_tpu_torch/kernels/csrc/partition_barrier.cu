// The window barrier of the partitioned executor, one thread per
// (partition, replica) lane of a device's partition-major lanes, built with
// nvcc into a shared library and loaded through ctypes by
// kernels/partition_barrier.py.
//
// It replaces no Pallas kernel: it is the barrier of
// happysim_tpu/tpu/partitioned.py's one_window (:517-558), which XLA runs
// as a lax sequence after each window's scan. For every lane, in JAX's
// order:
// - the close-out of the window's depth integral, gap = max(window_end -
//   max(t, warmup), 0), depth_int += q_len * gap per server (rounded once,
//   as XLA's CPU backend contracts it: ROADMAP C);
// - the clock's alignment, t = max(t, window_end);
// - the merge of the ring predecessor's outbox into the transit registers,
//   entry by entry for i < its length, each job in its ingress server's
//   first free slot or counted in tr_dropped (hs_transit_park below, the
//   event step's into_transit line for line), its attempt number 0 where
//   the model has them;
// - the reset of the outbox it read (of the entries a window wrote).
// Lane (p, r) reads the outbox of lane (p - 1, r) where p > 0, and for
// p = 0 the inbox slab: a copy of the ring predecessor's outbox rows where
// that partition lives on another device or process, else this launch's
// own last partition's rows. Each outbox is read, then reset, by the one
// lane that reads it (lane (0, r) resets partition P - 1's, which the next
// device already copied), so no lane clears an outbox another still reads
// and a snapshot after the barrier shows every outbox reset, as JAX's.
//
// What bounds it on this card: bytes. A lane reads its clock, its servers'
// queue lengths and depth integrals and the outbox entries it merges, and
// writes what it changes, the outbox entries it resets included; at about
// half a job a lane a window that is a few dozen bytes a lane, about 3 MB
// for 65,536 lanes of the ring, about a microsecond of the card's 3.35
// TB/s, so a launch costs its launch latency. The merge's first-free
// search scans a row of TR slots in device memory per job (in the
// replica-major JAX layout, uncoalesced across a warp), the price of
// sharing the event step's layout.
//
// The kernel also compiles as host C++ (the CPU tests build it with g++
// and hold it against the plain version); the launcher is nvcc's alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define HS_BARRIER_THREADS 128

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
// them (a non-null row), attempt number 0; false when none is free. This is
// the event step's into_transit (event_step.cuh) line for line on plain
// rows, so a merged job lands where the event step would park it: the JAX
// engine's _into_transit. The event step keeps its own loop: routed
// through one shared routine, its chaos instantiation took 1.055x the
// parent's time a block at the same registers, against 1.010x with its
// own loop, in one call of tools/ab_parent.py on an H100.
// tests/test_torch_partitioned_kernel.py holds the two equal through the
// plain versions.
__device__ __forceinline__ bool hs_transit_park(float* time, float* created, int* attempts,
                                                int TR, float arrival, float created_at) {
  for (int c = 0; c < TR; ++c) {
    if (isinf(time[c])) {
      time[c] = arrival;
      created[c] = created_at;
      if (attempts) attempts[c] = 0;
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(HS_BARRIER_THREADS)
partition_barrier_kernel(const __grid_constant__ BarrierArgs a) {
  const long long lanes = (long long)a.P * a.R;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
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
    if (!hs_transit_park(a.tr_time + row, a.tr_created + row, attempts, TR, arrival[j],
                         created[j]))
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

#if defined(__CUDACC__)
extern "C" int hs_partition_barrier_args_size() { return (int)sizeof(BarrierArgs); }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_partition_barrier(const BarrierArgs* args, void* stream) {
  const long long lanes = (long long)args->P * args->R;
  if (lanes <= 0) return 0;
  if (args->nV < 1 || args->TR < 1 || args->OB < 1 || !args->t || !args->depth_int ||
      !args->q_len || !args->tr_time || !args->tr_created || !args->tr_dropped ||
      !args->ob_arrival || !args->ob_created || !args->ob_ingress || !args->ob_len ||
      !args->in_arrival || !args->in_created || !args->in_ingress || !args->in_len)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((lanes + HS_BARRIER_THREADS - 1) / HS_BARRIER_THREADS);
  partition_barrier_kernel<<<blocks, HS_BARRIER_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
#endif
