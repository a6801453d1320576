// C interface of the event-step kernel's wide code (event_step.cuh with
// MAXV = HS_WIDE): a model past one of the lean instantiations' tables in
// the argument struct (more than HS_MAX_NV servers, HS_MAX_SOURCES
// sources, HS_MAX_ROUTERS routers, HS_MAX_TARGETS targets or
// HS_MAX_HOPS hops a router, HS_MAX_LIMITERS limiters or
// HS_MAX_PARTITIONS partition groups). It is the code for several sources
// or sinks with the per-server registers as lane-minor rows in device
// memory (HsWide's scratch), the earliest times searched by groups, and
// the model's tables in the HsWide buffer, so one instantiation runs any
// such model: the chaos code with every feature's sites for a model with
// chaos, the extended graph code (with or without the telemetry sites)
// for one without, and the chaos code with the trace branch for any
// traced one. Built with nvcc into a library of its own, in parallel
// with the other event-step libraries, and loaded through ctypes by
// kernels/event_step.py.

#include "event_step.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // The wide code is the extended graph code for several sources or sinks.
  if (!(args->graph && args->ext)) return (int)cudaErrorInvalidValue;
  if (args->res.on && args->res.breaker && (args->res.F < 1 || args->res.F > HS_MAX_BREAKER_RING))
    return (int)cudaErrorInvalidValue;
  const bool trace = args->trc.on != 0;
  if (!hs_args_ok(*args, trace, true)) return (int)cudaErrorInvalidValue;
  // The defenses and the consensus tier ride on chaos.
  const bool chaos = args->chaos || args->res.on || args->con.on;
  cudaStream_t s = (cudaStream_t)stream;
  if (trace) {
    hs_launch(event_step_kernel<HS_WIDE, true, true, true, true, true, true, true, true>, *args, s);
  } else if (chaos) {
    hs_launch(event_step_kernel<HS_WIDE, true, true, true, true, true, true, true>, *args, s);
  } else if (args->tel.nW) {
    hs_launch(event_step_kernel<HS_WIDE, true, true, false, true, false, false, true>, *args, s);
  } else {
    hs_launch(event_step_kernel<HS_WIDE, true, true, false, false, false, false, true>, *args, s);
  }
  return (int)cudaGetLastError();
}
