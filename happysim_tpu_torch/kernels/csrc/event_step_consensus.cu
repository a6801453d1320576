// C interface of the event-step kernel's consensus instantiations
// (event_step.cuh with CON = true): the chaos code plus the partition
// consult at a delivery and the quorum gate at an arrival, with or without
// the telemetry sites and the resilience defenses, per server bound. Built
// with nvcc into a shared library of its own, in parallel with the other
// event-step libraries, and loaded through ctypes by
// kernels/event_step.py, which launches it for every model with partition
// groups or a quorum.

#include "event_step.cuh"

template <int MAXV, bool TEL>
static void launch_res(const EventStepArgs& args, cudaStream_t s) {
  if (args.res.on) {
    hs_launch(event_step_kernel<MAXV, true, true, true, TEL, true, true>, args, s);
  } else {
    hs_launch(event_step_kernel<MAXV, true, true, true, TEL, false, true>, args, s);
  }
}

template <int MAXV>
static void launch(const EventStepArgs& args, cudaStream_t s) {
  if (args.tel.nW) {
    launch_res<MAXV, true>(args, s);
  } else {
    launch_res<MAXV, false>(args, s);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // Only a model with partition groups or a quorum, on the chaos code.
  if (!args->con.on || !(args->chaos && args->graph && args->ext))
    return (int)cudaErrorInvalidValue;
  if (args->res.on && args->res.breaker && (args->res.F < 1 || args->res.F > HS_MAX_BREAKER_RING))
    return (int)cudaErrorInvalidValue;
  // Several sources or sinks launch event_step_multi.cu's library.
  if (args->nS != 1 || args->nK != 1) return (int)cudaErrorInvalidValue;
  if (!hs_args_ok(*args)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (args->nV <= 1) {
    launch<1>(*args, s);
  } else if (args->nV <= 2) {
    launch<2>(*args, s);
  } else if (args->nV <= 4) {
    launch<4>(*args, s);
  } else if (args->nV <= HS_MAX_NV) {
    launch<HS_MAX_NV>(*args, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
