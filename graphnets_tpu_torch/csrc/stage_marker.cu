// Device markers of a model's stages (utils/profiling.STAGES, on while
// GRAPHNETS_TPU_TORCH_TRACE=1): one empty kernel a stage, launched on the
// step's stream where the stage starts, as phase_marker.cu's kernels are
// for the step's phases. A profiler reads a stage from its marker to the
// next marker of any name, inside the phase it falls in.
//
// GraphCast's stages (models/graphcast.py): encoder, processor and decoder
// in the forward; decoder_bwd, processor_bwd and encoder_bwd in the
// backward, each launched by the backward of an identity at the stage's
// boundary (utils/profiling.PhaseMarkers.boundary).

#include "common.cuh"

__global__ void gn_phase_encoder() {}
__global__ void gn_phase_processor() {}
__global__ void gn_phase_decoder() {}
__global__ void gn_phase_decoder_bwd() {}
__global__ void gn_phase_processor_bwd() {}
__global__ void gn_phase_encoder_bwd() {}

// The marker of stage `stage`, its index in utils/profiling.STAGES.
extern "C" int gn_stage_marker(int stage, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case 0: gn_phase_encoder<<<1, 1, 0, s>>>(); break;
    case 1: gn_phase_processor<<<1, 1, 0, s>>>(); break;
    case 2: gn_phase_decoder<<<1, 1, 0, s>>>(); break;
    case 3: gn_phase_decoder_bwd<<<1, 1, 0, s>>>(); break;
    case 4: gn_phase_processor_bwd<<<1, 1, 0, s>>>(); break;
    case 5: gn_phase_encoder_bwd<<<1, 1, 0, s>>>(); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
