// C interface of the event-step kernel's partitioned instantiations
// (event_step.cuh with PRT = true): one window of the partitioned executor
// (happysim_tpu_torch/partitioned.py), every lane a (partition, replica)
// pair running up to the window's event budget before the window's end,
// its draws keyed per event, its remote deliveries queued in the outbox.
// The transit registers are always on (remote arrivals land there), so
// every model runs the graph code: the lean graph code without and with
// the family sampler and with the chaos branches, the code for several
// sources or sinks, and the wide code past a lean table. Telemetry,
// resilience, consensus and traces are refused before any launch, as the
// JAX package's run_partitioned refuses them. Built with nvcc into a
// library of its own, in parallel with the other libraries, and loaded
// through ctypes by kernels/event_step.py.

#include "event_step.cuh"

template <int MAXV, bool EXT, bool CHAOS>
static void launch_lean(const EventStepArgs& args, cudaStream_t s) {
  hs_launch(event_step_kernel<MAXV, true, EXT, CHAOS, false, false, false, false, false, true>,
            args, s);
}

template <int MAXV>
static void launch(const EventStepArgs& args, cudaStream_t s) {
  if (args.nS != 1 || args.nK != 1) {
    hs_launch(event_step_kernel<MAXV, true, true, true, false, false, false, true, false, true>,
              args, s);
  } else if (args.chaos) {
    launch_lean<MAXV, true, true>(args, s);
  } else if (args.ext) {
    launch_lean<MAXV, true, false>(args, s);
  } else {
    launch_lean<MAXV, false, false>(args, s);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  if (args->tel.nW != 0 || args->res.on || args->con.on || args->trc.on)
    return (int)cudaErrorInvalidValue;
  if (!args->graph) return (int)cudaErrorInvalidValue;
  if ((args->chaos || args->nS != 1 || args->nK != 1 || args->wide.on) && !args->ext)
    return (int)cudaErrorInvalidValue;
  if (args->has_profile && !args->ext) return (int)cudaErrorInvalidValue;
  const bool wide = args->wide.on != 0;
  if (!hs_args_ok(*args, false, wide, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide) {
    hs_launch(event_step_kernel<HS_WIDE, true, true, true, false, false, false, true, false, true>,
              *args, s);
  } else if (args->nV <= 1) {
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
