// C interface of the event-step kernel's resilience instantiations
// (event_step.cuh with RES = true): the chaos code plus the circuit
// breaker, the load shed and the retry budget, with or without the
// telemetry sites, per server bound. Built with nvcc into a shared
// library of its own, in parallel with event_step.cu and
// event_step_telemetry.cu, and loaded through ctypes by
// kernels/event_step.py, which launches it for every model with a
// defense.

#include "event_step.cuh"

template <int MAXV>
static void launch(const EventStepArgs& args, cudaStream_t s) {
  if (args.tel.nW) {
    hs_launch(event_step_kernel<MAXV, true, true, true, true, true>, args, s);
  } else {
    hs_launch(event_step_kernel<MAXV, true, true, true, false, true>, args, s);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // Only a model with a defense and without partitions or a quorum, on the
  // chaos code.
  if (!args->res.on || args->con.on || !(args->chaos && args->graph && args->ext))
    return (int)cudaErrorInvalidValue;
  if (args->res.breaker && (args->res.F < 1 || args->res.F > HS_MAX_BREAKER_RING))
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
