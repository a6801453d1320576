// Event-step kernel: advances every replica of a single-source,
// single-sink server chain by `macro` event steps in one launch.
//
// Replaces the Pallas TPU kernel
// happysim_tpu/tpu/kernels/event_step.py::build_block_step (its
// pl.pallas_call), which runs the JAX engine's traced one-event step
// (_Compiled.make_step(external_u=True)) `macro` times over a
// VMEM-resident replica tile. That body is a generic jaxpr evaluator, so
// this file writes out what it computes for the "mm1" and "chain" shapes:
// next_candidates' argmin (first index wins ties), the depth integral,
// _fire_source, _complete_server with its FIFO queue pull,
// _arrive_server and _deliver_sink, op for op in float32, in the order of
// the plain torch-op step (kernels/event_step.py::plain_block_step).
//
// Design. One thread per replica. The clock, the source's next arrival,
// the sink accumulators and, per server, the queue head and length, the
// earliest completion time, the counters and the integrals live in
// registers for the whole launch (per-server register arrays sized by
// the MAXV template argument and indexed only with compile-time indices
// through pick/put). The (nV, C) slot arrays, the (nV, K) queue rings and
// the (nK, 80) histogram are read and written in device memory in the
// JAX layout, only at the entries an event touches. A lane whose next
// event lies past the horizon stops early (the halted state is
// absorbing) and every lane writes its halted flag after its last step,
// so the host's early-exit test needs no second pass.
//
// What bounds it on this card: bytes moved per block. A block reads and
// writes each replica's dense registers once and reads its uniforms
// (macro * n_draws floats); the arithmetic is a few dozen float ops per
// event against 67 TFLOP/s. What this simple design leaves on the table:
// the per-replica rows are strided, so a warp's accesses to U, the slot
// arrays, the rings and sink_hist are uncoalesced (one 32-byte sector
// per lane). A (..., R)-minor layout, or staging a tile of replicas
// through shared memory, and drawing U in the kernel are later work.
//
// Float agreement with the plain version: build with -fmad=false and
// without --use_fast_math (every torch op is its own kernel, so the
// plain version never contracts a multiply-add), and use logf/log10f and
// IEEE division as torch's CUDA ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define HS_MAX_NV 8
#define HS_HIST_BINS 80
#define HS_THREADS 128

// Launch arguments. The layout must match kernels/event_step.py::_Args.
struct EventStepArgs {
  // state leaves, replica-major, JAX layout
  float* t;                // (R,)
  float* src_next;         // (R, 1)
  int* events;             // (R,)
  float* slot_done;        // (R, nV, C)
  float* slot_created;     // (R, nV, C)
  float* q_created;        // (R, nV, K)
  float* q_enq;            // (R, nV, K)
  int* q_head;             // (R, nV)
  int* q_len;              // (R, nV)
  int* started;            // (R, nV)
  int* completed;          // (R, nV)
  int* dropped;            // (R, nV)
  int* wait_n;             // (R, nV)
  float* busy_int;         // (R, nV)
  float* depth_int;        // (R, nV)
  float* wait_sum;         // (R, nV)
  int* sink_count;         // (R, 1)
  float* sink_sum;         // (R, 1)
  float* sink_sq;          // (R, 1)
  int* sink_hist;          // (R, 1, 80)
  uint8_t* halted;         // (R,) out
  const float* U;          // (R, macro, n_draws)
  const float* src_rate;   // (R, 1)
  const float* srv_mean;   // (R, nV)
  int R, nV, C, K, macro, n_draws;
  int src_down;            // server the source feeds
  int src_poisson;         // 1: -log(u)/rate gaps, 0: 1/rate
  int u_gap, u_svc1, u_svc2;  // uniform slots (-1: none)
  float stop_after, horizon, warmup;
  int srv_down[HS_MAX_NV];   // next server, -1 for the sink
  int svc_kind[HS_MAX_NV];   // 0 constant, 1 exponential
  int conc[HS_MAX_NV];       // valid slots per server
  int qcap[HS_MAX_NV];       // queue capacity per server
};

// Register-array access with a run-time index: unrolled selects, so the
// arrays stay in registers (the JAX step's one-hot _pick / where(row)).
template <int MAXV, typename T>
__device__ __forceinline__ T pick(const T (&a)[MAXV], int i) {
  T out = a[0];
#pragma unroll
  for (int v = 1; v < MAXV; ++v)
    if (v == i) out = a[v];
  return out;
}

template <int MAXV, typename T>
__device__ __forceinline__ void put(T (&a)[MAXV], int i, T x) {
#pragma unroll
  for (int v = 0; v < MAXV; ++v)
    if (v == i) a[v] = x;
}

template <int MAXV>
__device__ __forceinline__ int pick_arg(const int* a, int i) {
  int out = a[0];
#pragma unroll
  for (int v = 1; v < MAXV; ++v)
    if (v == i) out = a[v];
  return out;
}

__device__ __forceinline__ float sample_service(int kind, float mean, float u) {
  return kind == 0 ? mean : (-logf(u)) * mean;
}

__device__ __forceinline__ int hist_bin(float latency) {
  const float logv = log10f(fmaxf(latency, 1e-12f));
  const float frac = (logv - (-5.0f)) / 8.0f;
  const int b = (int)(frac * 80.0f);  // truncation toward zero
  return min(max(b, 0), HS_HIST_BINS - 1);
}

__device__ __forceinline__ float row_min(const float* row, int n) {
  float m = INFINITY;
  for (int c = 0; c < n; ++c) m = fminf(m, row[c]);
  return m;
}

template <int MAXV>
__global__ void __launch_bounds__(HS_THREADS)
event_step_kernel(const __grid_constant__ EventStepArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const int nV = a.nV, C = a.C, K = a.K, nd = a.n_draws;
  const size_t rv = (size_t)r * nV;
  float* slot_done = a.slot_done + rv * C;
  float* slot_created = a.slot_created + rv * C;
  float* q_created = a.q_created + rv * K;
  float* q_enq = a.q_enq + rv * K;
  int* hist = a.sink_hist + (size_t)r * HS_HIST_BINS;
  const float* U = a.U + (size_t)r * a.macro * nd;

  int q_head[MAXV], q_len[MAXV], started[MAXV], completed[MAXV];
  int dropped[MAXV], wait_n[MAXV];
  float busy[MAXV], depth[MAXV], wsum[MAXV], mean[MAXV], smin[MAXV];
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    const bool real = v < nV;
    q_head[v] = real ? a.q_head[rv + v] : 0;
    q_len[v] = real ? a.q_len[rv + v] : 0;
    started[v] = real ? a.started[rv + v] : 0;
    completed[v] = real ? a.completed[rv + v] : 0;
    dropped[v] = real ? a.dropped[rv + v] : 0;
    wait_n[v] = real ? a.wait_n[rv + v] : 0;
    busy[v] = real ? a.busy_int[rv + v] : 0.0f;
    depth[v] = real ? a.depth_int[rv + v] : 0.0f;
    wsum[v] = real ? a.wait_sum[rv + v] : 0.0f;
    mean[v] = real ? a.srv_mean[rv + v] : 0.0f;
    smin[v] = real ? row_min(slot_done + v * C, a.conc[v]) : INFINITY;
  }
  float t = a.t[r];
  float src_next = a.src_next[r];
  int events = a.events[r];
  int sk_count = a.sink_count[r];
  float sk_sum = a.sink_sum[r];
  float sk_sq = a.sink_sq[r];
  const float rate = a.src_rate[r];

  for (int k = 0; k < a.macro; ++k) {
    // next_candidates: the source first, then the servers in index
    // order; a strict < keeps the first index on ties (argmin).
    float tn = src_next;
    int ev = -1;
#pragma unroll
    for (int v = 0; v < MAXV; ++v)
      if (smin[v] < tn) { tn = smin[v]; ev = v; }
    if (isinf(tn) || tn > a.horizon) break;  // halted: every later step is a no-op

    const float* u = U + k * nd;
    const float lo = fmaxf(t, a.warmup);
    const float dt = fmaxf(tn - lo, 0.0f);
#pragma unroll
    for (int v = 0; v < MAXV; ++v)
      if (v < nV) depth[v] = depth[v] + (float)q_len[v] * dt;
    t = tn;
    events += 1;
    const bool measure = t >= a.warmup;

    int target, from = -1, from_slot = 0;
    float created;
    if (ev < 0) {  // _fire_source
      const float gap = a.src_poisson ? (-logf(u[a.u_gap])) / rate : 1.0f / rate;
      const float next_time = t + gap;
      src_next = next_time > a.stop_after ? INFINITY : next_time;
      target = a.src_down;
      created = t;
    } else {  // _complete_server: the first slot holding the earliest time
      from = ev;
      const int cv = pick_arg<MAXV>(a.conc, from);
      float* row = slot_done + from * C;
      float best = INFINITY;
      for (int c = 0; c < cv; ++c) {
        const float x = row[c];
        if (x < best) { best = x; from_slot = c; }
      }
      created = slot_created[from * C + from_slot];
      row[from_slot] = INFINITY;
      put(completed, from, pick(completed, from) + 1);
      target = pick_arg<MAXV>(a.srv_down, from);
    }

    if (target < 0) {  // _deliver_sink (zero-latency edge: arrival at t)
      if (t >= a.warmup && t <= a.horizon) {
        const float latency = t - created;
        sk_count += 1;
        sk_sum = sk_sum + latency;
        sk_sq = sk_sq + latency * latency;
        hist[hist_bin(latency)] += 1;
      }
    } else {  // _arrive_server
      const int w = target;
      const int cw = pick_arg<MAXV>(a.conc, w);
      float* row = slot_done + w * C;
      int first_free = -1;
      for (int c = 0; c < cw; ++c)
        if (isinf(row[c])) { first_free = c; break; }
      if (first_free >= 0) {
        const float ua = a.u_svc1 >= 0 ? u[a.u_svc1] : 0.5f;
        const float service =
            sample_service(pick_arg<MAXV>(a.svc_kind, w), pick(mean, w), ua);
        const float done_at = t + service;
        row[first_free] = done_at;
        slot_created[w * C + first_free] = created;
        put(started, w, pick(started, w) + 1);
        if (measure) {
          put(wait_n, w, pick(wait_n, w) + 1);
          put(busy, w, pick(busy, w) + service);
        }
        put(smin, w, fminf(pick(smin, w), done_at));
      } else {
        const int ql = pick(q_len, w);
        if (ql < pick_arg<MAXV>(a.qcap, w)) {
          const int tail = (pick(q_head, w) + ql) % K;
          q_created[w * K + tail] = created;
          q_enq[w * K + tail] = t;
          put(q_len, w, ql + 1);
        } else {
          put(dropped, w, pick(dropped, w) + 1);
        }
      }
    }

    if (from >= 0) {
      // FIFO pull into the freed slot. On a chain the delivery above
      // went to another server, so the slot is still free.
      const int ql = pick(q_len, from);
      float* row = slot_done + from * C;
      if (ql > 0) {
        const int head = pick(q_head, from);
        const float ub = a.u_svc2 >= 0 ? u[a.u_svc2] : 0.5f;
        const float service =
            sample_service(pick_arg<MAXV>(a.svc_kind, from), pick(mean, from), ub);
        row[from_slot] = t + service;
        slot_created[from * C + from_slot] = q_created[from * K + head];
        put(q_head, from, (head + 1) % K);
        put(q_len, from, ql - 1);
        put(started, from, pick(started, from) + 1);
        if (measure) {
          put(busy, from, pick(busy, from) + service);
          put(wsum, from, pick(wsum, from) + (t - q_enq[from * K + head]));
          put(wait_n, from, pick(wait_n, from) + 1);
        }
      }
      put(smin, from, row_min(row, pick_arg<MAXV>(a.conc, from)));
    }
  }

  float tn = src_next;
#pragma unroll
  for (int v = 0; v < MAXV; ++v) tn = fminf(tn, smin[v]);
  a.halted[r] = (isinf(tn) || tn > a.horizon) ? 1 : 0;

  a.t[r] = t;
  a.src_next[r] = src_next;
  a.events[r] = events;
  a.sink_count[r] = sk_count;
  a.sink_sum[r] = sk_sum;
  a.sink_sq[r] = sk_sq;
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    if (v < nV) {
      a.q_head[rv + v] = q_head[v];
      a.q_len[rv + v] = q_len[v];
      a.started[rv + v] = started[v];
      a.completed[rv + v] = completed[v];
      a.dropped[rv + v] = dropped[v];
      a.wait_n[rv + v] = wait_n[v];
      a.busy_int[rv + v] = busy[v];
      a.depth_int[rv + v] = depth[v];
      a.wait_sum[rv + v] = wsum[v];
    }
  }
}

extern "C" int hs_event_step_max_servers() { return HS_MAX_NV; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  const dim3 block(HS_THREADS);
  const dim3 grid((args->R + HS_THREADS - 1) / HS_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (args->nV <= 1) {
    event_step_kernel<1><<<grid, block, 0, s>>>(*args);
  } else if (args->nV <= 2) {
    event_step_kernel<2><<<grid, block, 0, s>>>(*args);
  } else if (args->nV <= 4) {
    event_step_kernel<4><<<grid, block, 0, s>>>(*args);
  } else if (args->nV <= HS_MAX_NV) {
    event_step_kernel<HS_MAX_NV><<<grid, block, 0, s>>>(*args);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
