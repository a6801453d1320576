// C interface of the event-step kernel's telemetry instantiations
// (event_step.cuh with TEL = true): the extended graph code, with or
// without the chaos branches, per server bound. Built with nvcc into a
// shared library of its own, in parallel with event_step.cu, and loaded
// through ctypes by kernels/event_step.py, which launches it for every
// model with a telemetry spec.

#include "event_step.cuh"

template <int MAXV>
static void launch(const EventStepArgs& args, cudaStream_t s) {
  if (args.chaos) {
    hs_launch(event_step_kernel<MAXV, true, true, true, true>, args, s);
  } else {
    hs_launch(event_step_kernel<MAXV, true, true, false, true>, args, s);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // A model with a defense launches event_step_resilience.cu's library, a
  // model with partitions or a quorum event_step_consensus.cu's.
  if (args->tel.nW < 1 || args->res.on || args->con.on || !(args->graph && args->ext))
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
