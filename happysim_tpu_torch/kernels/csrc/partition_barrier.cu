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
//   the model has them; the search stops at the row's occupancy bound
//   (tr_hi, shared with the window kernel: 1 + the highest occupied
//   slot), and a job parked at the bound raises it;
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
// a quarter of a job a lane a window that is a few dozen bytes a lane,
// 0.705 us of the card's 3.35 TB/s for the example ring's 65,536 lanes.
// It measured 10.01 us a window the device alone (10.80 us before the
// occupancy bound, timed the same way by tools/ab_parent.py on an H100
// 80GB HBM3 at 700 W), not its launch latency: each merged
// job's outbox entry and transit row sit at their own lane's address (in
// the replica-major JAX layout a lane's outbox row lies 4 OB bytes from
// its neighbour's, its transit rows 4 nV TR bytes), so a warp's accesses
// touch a sector a lane, behind the dependent loads of the outbox length
// and the row's bound.
// Where one card holds the whole ring, each lane runs this barrier at the
// start of the next window's launch instead (event_step.cuh, PRT), where
// it adds about 3.6 us to the window's 29.7 (chip_smoke.py).
//
// The kernel also compiles as host C++ (the CPU tests build it with g++
// and hold it against the plain version); the launcher is nvcc's alone.

#include "partition_barrier.cuh"

#define HS_BARRIER_THREADS 128

__global__ void __launch_bounds__(HS_BARRIER_THREADS)
partition_barrier_kernel(const __grid_constant__ BarrierArgs a) {
  const long long lanes = (long long)a.P * a.R;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  hs_barrier_lane(a, i);
}

#if defined(__CUDACC__)
extern "C" int hs_partition_barrier_args_size() { return (int)sizeof(BarrierArgs); }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_partition_barrier(const BarrierArgs* args, void* stream) {
  const long long lanes = (long long)args->P * args->R;
  if (lanes <= 0) return 0;
  if (!hs_barrier_args_ok(*args)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((lanes + HS_BARRIER_THREADS - 1) / HS_BARRIER_THREADS);
  partition_barrier_kernel<<<blocks, HS_BARRIER_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
#endif
