// C interface of the event-step kernel's wide code (event_step.cuh with
// MAXV = HS_WIDE): a model past one of the lean instantiations' tables in
// the argument struct (more than HS_MAX_NV servers, HS_MAX_SOURCES
// sources, HS_MAX_ROUTERS routers, HS_MAX_TARGETS targets or
// HS_MAX_HOPS hops a router, HS_MAX_LIMITERS limiters or
// HS_MAX_PARTITIONS partition groups). It is the code for several sources
// or sinks (every feature's sites, each taken only where the model has
// the feature) with the per-server registers as rows in device memory and
// the model's tables in the HsWide buffer, so one instantiation runs any
// such model, and a second one with the trace branch any traced one.
// Built with nvcc into a library of its own, in parallel with the other
// event-step libraries, and loaded through ctypes by kernels/event_step.py.

#include "event_step.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // The wide code is the chaos code with every feature's sites.
  if (!(args->chaos && args->graph && args->ext)) return (int)cudaErrorInvalidValue;
  if (args->res.on && args->res.breaker && (args->res.F < 1 || args->res.F > HS_MAX_BREAKER_RING))
    return (int)cudaErrorInvalidValue;
  const bool trace = args->trc.on != 0;
  if (!hs_args_ok(*args, trace, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (trace) {
    hs_launch(event_step_kernel<HS_WIDE, true, true, true, true, true, true, true, true>, *args, s);
  } else {
    hs_launch(event_step_kernel<HS_WIDE, true, true, true, true, true, true, true>, *args, s);
  }
  return (int)cudaGetLastError();
}
