// C interface of the event-step kernel's instantiations for several
// sources or sinks (event_step.cuh with MULTI = true), per server bound,
// by feature set (hs_code, named by hs_event_step_code), each with or
// without the telemetry sites:
// - without chaos, the extended graph code, which has none of the chaos
//   code's sites and so none of its registers;
// - with chaos but neither the defenses nor the consensus tier, the chaos
//   code without their sites (two-class-chaos: the 1% loss on the batch
//   edge and the batch server's deadline);
// - with a defense or the consensus tier, the chaos code with every
//   feature's sites, the telemetry ones always, each taken only where the
//   model has the feature (a null leaf, an unset flag).
// Every one keeps the sources' next arrivals in a register array and the
// other sinks' accumulators in device memory. Built with nvcc into a
// shared library of its own, in parallel with the other event-step
// libraries, and loaded through ctypes by kernels/event_step.py.

#include "event_step.cuh"

template <int MAXV, bool TEL>
static void launch_code(const EventStepArgs& args, cudaStream_t s) {
  switch (hs_code(args, false)) {
    case HS_CODE_FULL:
      hs_launch(event_step_kernel<MAXV, true, true, true, true, true, true, true>, args, s);
      return;
    case HS_CODE_CHAOS:
      hs_launch(event_step_kernel<MAXV, true, true, true, TEL, false, false, true>, args, s);
      return;
    default:
      hs_launch(event_step_kernel<MAXV, true, true, false, TEL, false, false, true>, args, s);
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

HS_EVENT_STEP_CODE(false)

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // Only a model with several sources or sinks, on the extended graph code.
  if ((args->nS == 1 && args->nK == 1) || !(args->graph && args->ext))
    return (int)cudaErrorInvalidValue;
  // The defenses and the consensus tier ride on chaos.
  if (!args->chaos && (args->res.on || args->con.on)) return (int)cudaErrorInvalidValue;
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
