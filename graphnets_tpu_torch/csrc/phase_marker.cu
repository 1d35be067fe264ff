// Device phase markers of the port's tracing (utils/profiling.PhaseMarkers,
// on while GRAPHNETS_TPU_TORCH_TRACE=1): one empty kernel a phase of a
// step body, launched on the step's stream at the phase's start, so a
// CUDA-graph capture takes it into the graph and a profiler trace shows
// it, on the device's clock, under a name that says the phase.
//
// Why a kernel: replayed from a graph, a memset or a device-to-device
// copy runs as a kernel of libcuda's own (memset8, memcpy32_post) whose
// trace event carries no byte count, so no argument of it can name a
// phase; a copy from pinned host memory stays a copy but joins the copy
// engine to the step's stream, about 10 us of device time a marker. One
// thread of an empty kernel is a graph node like the step's own, about a
// microsecond.

#include "common.cuh"

__global__ void gn_phase_batch() {}
__global__ void gn_phase_forward() {}
__global__ void gn_phase_backward() {}
__global__ void gn_phase_optimizer() {}
__global__ void gn_phase_metrics() {}
__global__ void gn_phase_end() {}

// The marker of phase `phase`, its index in utils/profiling.PHASES.
extern "C" int gn_phase_marker(int phase, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (phase) {
    case 0: gn_phase_batch<<<1, 1, 0, s>>>(); break;
    case 1: gn_phase_forward<<<1, 1, 0, s>>>(); break;
    case 2: gn_phase_backward<<<1, 1, 0, s>>>(); break;
    case 3: gn_phase_optimizer<<<1, 1, 0, s>>>(); break;
    case 4: gn_phase_metrics<<<1, 1, 0, s>>>(); break;
    case 5: gn_phase_end<<<1, 1, 0, s>>>(); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
