// Step markers for Hopper (sm_90a): one empty kernel a marker name.
//
// A marker is a one-thread kernel that reads and writes nothing. Launched
// inside a step that a CUDA graph captures, it becomes a node of the graph,
// so a replay, which runs no host code, still shows the boundaries of its
// phases on the card's timeline (utils/tracing.py: mark). Each name has a
// kernel of its own, medmamba_mark_<group>_<phase>, so a profiler trace
// names the marker by its kernel. The list below is tracing.MARKERS, in
// its order; medmamba_marker_count() lets the loader check that.

#include <cuda_runtime.h>

#define MEDMAMBA_MARKERS(X)                                                 \
  X(step, begin) X(step, forward) X(step, backward) X(step, exchange)      \
  X(step, optimizer) X(step, end)                                          \
  X(forward, begin) X(forward, model) X(forward, end)                      \
  X(eval, begin) X(eval, end) X(cam, begin) X(cam, end)                    \
  X(exported, begin) X(exported, end)                                     \
  X(mixer, forward) X(mixer, backward) X(attention, forward)              \
  X(attention, backward) X(mlp, forward) X(mlp, backward)

#define MEDMAMBA_DEFINE(group, phase) \
  __global__ void medmamba_mark_##group##_##phase() {}
MEDMAMBA_MARKERS(MEDMAMBA_DEFINE)

#define MEDMAMBA_ENTRY(group, phase) \
  reinterpret_cast<const void*>(&medmamba_mark_##group##_##phase),
static const void* const kMarkers[] = {MEDMAMBA_MARKERS(MEDMAMBA_ENTRY)};
static const int kCount = sizeof(kMarkers) / sizeof(kMarkers[0]);

extern "C" int medmamba_marker_count() { return kCount; }

// Launches marker `index` (its place in the list above) on `stream`, one
// block of one thread. Returns the launch's error code, 0 when accepted,
// or cudaErrorInvalidValue for an index out of range. Does not synchronise.
extern "C" int medmamba_mark(int index, void* stream) {
  if (index < 0 || index >= kCount) return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel(kMarkers[index], dim3(1), dim3(1), nullptr, 0,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* medmamba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
