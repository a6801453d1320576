// C interface of the event-step kernel (event_step.cuh) without telemetry
// or resilience: the line, graph, extended and chaos instantiations, built
// with nvcc into a shared library and loaded through ctypes by
// kernels/event_step.py. The telemetry instantiations are
// event_step_telemetry.cu's, the resilience ones event_step_resilience.cu's,
// the consensus ones event_step_consensus.cu's, those for several sources
// or sinks event_step_multi.cu's.

#include "event_step.cuh"

template <int MAXV, bool GRAPH>
static void launch_shape(const EventStepArgs& args, cudaStream_t s) {
  if (args.ext) {
    hs_launch(event_step_kernel<MAXV, GRAPH, true, false>, args, s);
  } else {
    hs_launch(event_step_kernel<MAXV, GRAPH, false, false>, args, s);
  }
}

template <int MAXV>
static void launch(const EventStepArgs& args, cudaStream_t s) {
  if (args.chaos) {
    // Every chaos model: the graph code with the family sampler.
    hs_launch(event_step_kernel<MAXV, true, true, true>, args, s);
  } else if (args.graph) {
    launch_shape<MAXV, true>(args, s);
  } else {
    launch_shape<MAXV, false>(args, s);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // A telemetry model launches event_step_telemetry.cu's library, a
  // model with a defense event_step_resilience.cu's, a model with
  // partitions or a quorum event_step_consensus.cu's.
  if (args->tel.nW != 0 || args->res.on || args->con.on) return (int)cudaErrorInvalidValue;
  // Several sources or sinks launch event_step_multi.cu's library.
  if (args->nS != 1 || args->nK != 1) return (int)cudaErrorInvalidValue;
  if (args->chaos && !(args->graph && args->ext)) return (int)cudaErrorInvalidValue;
  if (args->has_profile && !args->ext) return (int)cudaErrorInvalidValue;
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
