// C interface of the event-step kernel's trace-driven instantiations
// (event_step.cuh with TRC = true), built with nvcc into a shared library
// of its own, in parallel with the other event-step libraries, and loaded
// through ctypes by kernels/event_step.py, which launches it for every
// model with a traced source, one launch a stream step:
// - a single-source traced model without chaos, defenses or the
//   consensus tier runs the lean extended graph code with the trace, with
//   or without the telemetry sites;
// - every other traced model (several sources or sinks, the chaos stack,
//   the defenses, the consensus tier) runs the MULTI code with the trace,
//   each feature's sites taken only where the model has the feature.
// The libraries without the trace keep their code: TRC sits under `if
// constexpr`.

#include "event_step.cuh"

template <int MAXV>
static void launch(const EventStepArgs& args, cudaStream_t s) {
  if (args.chaos) {
    hs_launch(event_step_kernel<MAXV, true, true, true, true, true, true, true, true>, args, s);
  } else if (args.tel.nW) {
    hs_launch(event_step_kernel<MAXV, true, true, false, true, false, false, false, true>, args, s);
  } else {
    hs_launch(event_step_kernel<MAXV, true, true, false, false, false, false, false, true>, args,
              s);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // A traced model on the extended graph code; several sources or sinks,
  // the defenses and the consensus tier ride the chaos code.
  if (!(args->graph && args->ext)) return (int)cudaErrorInvalidValue;
  if (!args->chaos && (args->nS != 1 || args->nK != 1 || args->res.on || args->con.on))
    return (int)cudaErrorInvalidValue;
  if (args->res.on && args->res.breaker && (args->res.F < 1 || args->res.F > HS_MAX_BREAKER_RING))
    return (int)cudaErrorInvalidValue;
  if (!hs_args_ok(*args, true)) return (int)cudaErrorInvalidValue;
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
