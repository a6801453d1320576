// C interface of the event-step kernel (event_step.cuh) without telemetry
// or resilience: the line, graph, extended and chaos instantiations, built
// with nvcc into a shared library and loaded through ctypes by
// kernels/event_step.py. The telemetry instantiations are
// event_step_telemetry.cu's, the resilience ones event_step_resilience.cu's.

#include "event_step.cuh"

extern "C" int hs_event_step_max_servers() { return HS_MAX_NV; }

extern "C" int hs_event_step_max_profile_grid() { return HS_MAX_PROFILE_GRID; }

extern "C" int hs_event_step_args_size() { return (int)sizeof(EventStepArgs); }

template <int MAXV, bool GRAPH>
static void launch_shape(const EventStepArgs& args, dim3 grid, dim3 block, cudaStream_t s) {
  // The profile tables' shared-memory stage, when the source has one.
  const size_t smem = args.has_profile ? 2 * (size_t)args.prof_n * sizeof(float) : 0;
  if (args.ext) {
    event_step_kernel<MAXV, GRAPH, true, false><<<grid, block, smem, s>>>(args);
  } else {
    event_step_kernel<MAXV, GRAPH, false, false><<<grid, block, 0, s>>>(args);
  }
}

template <int MAXV>
static void launch(const EventStepArgs& args, dim3 grid, dim3 block, cudaStream_t s) {
  if (args.chaos) {
    // Every chaos model: the graph code with the family sampler.
    const size_t smem = args.has_profile ? 2 * (size_t)args.prof_n * sizeof(float) : 0;
    event_step_kernel<MAXV, true, true, true><<<grid, block, smem, s>>>(args);
  } else if (args.graph) {
    launch_shape<MAXV, true>(args, grid, block, s);
  } else {
    launch_shape<MAXV, false>(args, grid, block, s);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_event_step(const EventStepArgs* args, void* stream) {
  if (args->R <= 0) return 0;
  // A telemetry model launches event_step_telemetry.cu's library, a
  // model with a defense event_step_resilience.cu's.
  if (args->tel.nW != 0 || args->res.on) return (int)cudaErrorInvalidValue;
  if (args->chaos && !(args->graph && args->ext)) return (int)cudaErrorInvalidValue;
  if ((args->ext || args->chaos) && args->has_profile &&
      (args->prof_n < 2 || args->prof_n > HS_MAX_PROFILE_GRID))
    return (int)cudaErrorInvalidValue;
  const dim3 block(HS_THREADS);
  const dim3 grid((args->R + HS_THREADS - 1) / HS_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (args->nV <= 1) {
    launch<1>(*args, grid, block, s);
  } else if (args->nV <= 2) {
    launch<2>(*args, grid, block, s);
  } else if (args->nV <= 4) {
    launch<4>(*args, grid, block, s);
  } else if (args->nV <= HS_MAX_NV) {
    launch<HS_MAX_NV>(*args, grid, block, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
