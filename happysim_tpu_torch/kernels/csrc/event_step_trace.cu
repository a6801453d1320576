// C interface of the event-step kernel's trace-driven instantiations
// (event_step.cuh with TRC = true), built with nvcc into a shared library
// of its own, in parallel with the other event-step libraries, and loaded
// through ctypes by kernels/event_step.py, which launches it for every
// model with a traced source, one launch a stream step. The code is
// chosen by feature set (hs_code, named by hs_event_step_code), each
// with or without the telemetry sites:
// - a single-source traced model without chaos runs the lean extended
//   graph code with the trace;
// - a traced model with several sources or sinks and no chaos
//   (trace-poisson) runs the chaos-free MULTI code with the trace;
// - a traced model with chaos but neither the defenses nor the consensus
//   tier runs the MULTI chaos code without their sites, with the trace;
// - a traced model with a defense or the consensus tier runs the MULTI
//   chaos code with every feature's sites (the telemetry ones always),
//   each taken only where the model has the feature.
// The libraries without the trace keep their code: TRC sits under `if
// constexpr`.

#include "event_step.cuh"

template <int MAXV, bool TEL>
static void launch_code(const EventStepArgs& args, cudaStream_t s) {
  switch (hs_code(args, true)) {
    case HS_CODE_FULL:
      hs_launch(event_step_kernel<MAXV, true, true, true, true, true, true, true, true>, args, s);
      return;
    case HS_CODE_CHAOS:
      hs_launch(event_step_kernel<MAXV, true, true, true, TEL, false, false, true, true>, args, s);
      return;
    case HS_CODE_LEAN:
      hs_launch(event_step_kernel<MAXV, true, true, false, TEL, false, false, true, true>, args, s);
      return;
    default:
      hs_launch(event_step_kernel<MAXV, true, true, false, TEL, false, false, false, true>, args, s);
  }
}

template <int MAXV>
static void launch(const EventStepArgs& args, cudaStream_t s) {
  if (args.tel.nW) {
    launch_code<MAXV, true>(args, s);
  } else {
    launch_code<MAXV, false>(args, s);
  }
}

HS_EVENT_STEP_CODE(true)

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // A traced model on the extended graph code; the defenses and the
  // consensus tier ride the chaos code.
  if (!(args->graph && args->ext)) return (int)cudaErrorInvalidValue;
  if (!args->chaos && (args->res.on || args->con.on)) return (int)cudaErrorInvalidValue;
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
