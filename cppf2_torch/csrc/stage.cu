// Stage markers of the pose graph: one empty one-thread kernel per stage.
//
// `utils/profiling.py::stage` launches `stage_mark_<stage>` on the current
// stream where a stage of a program begins and `stage_mark_end` where it ends.
// A marker does no work and touches no memory, so it changes no result; it
// exists for its name. Launched during a CUDA graph capture it becomes a node
// of the graph and replays with it, and in a trace (torch.profiler, nsys) the
// kernels between a stage's marker and the next `stage_mark_end` are that
// stage's. The names are C names, so a trace shows them as written here.
//
// The order of STAGES below is `profiling.STAGES`; `stage_mark_end` follows.

#include <cuda_runtime.h>

#define STAGES(X) \
  X(frontend)     \
  X(descriptors)  \
  X(mlps)         \
  X(targets)      \
  X(center_vote)  \
  X(backvote)     \
  X(cone_vote)    \
  X(align)        \
  X(finish)       \
  X(vit)          \
  X(end)

#define DEFINE_MARKER(name) \
  extern "C" __global__ void stage_mark_##name() {}
STAGES(DEFINE_MARKER)
#undef DEFINE_MARKER

// Launch marker `which` (its place in STAGES) on `stream`; returns the
// launch's cudaError.
extern "C" int cppf2_stage_mark(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int i = 0;
#define LAUNCH_MARKER(name)                   \
  if (which == i++) {                         \
    stage_mark_##name<<<1, 1, 0, s>>>();      \
    return static_cast<int>(cudaGetLastError()); \
  }
  STAGES(LAUNCH_MARKER)
#undef LAUNCH_MARKER
  return static_cast<int>(cudaErrorInvalidValue);
}
