// C interface of the event-step kernel's instantiations for several
// sources or sinks (event_step.cuh with MULTI = true): the chaos code with
// the telemetry, resilience and consensus sites, each taken only where the
// model has the feature, per server bound. Built with nvcc into a shared
// library of its own, in parallel with the other event-step libraries,
// and loaded through ctypes by kernels/event_step.py, which launches it
// for every model with more than one source or sink.

#include "event_step.cuh"

template <int MAXV>
static void launch(const EventStepArgs& args, cudaStream_t s) {
  hs_launch(event_step_kernel<MAXV, true, true, true, true, true, true, true>, args, s);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // Only a model with several sources or sinks, on the chaos code.
  if ((args->nS == 1 && args->nK == 1) || !(args->chaos && args->graph && args->ext))
    return (int)cudaErrorInvalidValue;
  if (args->res.on && args->res.breaker && (args->res.F < 1 || args->res.F > HS_MAX_BREAKER_RING))
    return (int)cudaErrorInvalidValue;
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
