// Helpers shared by the port's CUDA kernels (built with nvcc for sm_90a
// and bound through ctypes; see ops/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Flux LayerNorm of one row held in shared memory, done by one warp, in
// place: f32 statistics, (x - mean) / (std + eps) with std = 0 where
// var == 0, then * scale + bias and one rounding to bf16.  Division and
// sqrt are IEEE (nvcc's defaults), as in the plain torch version.
// The row is read once into registers, 8 values (16 bytes) per lane per
// step; d % 8 == 0 and d <= 512.
constexpr int kLnMaxVec = 2;  // 16-byte vectors per lane: d <= 32 * 8 * 2

__device__ __forceinline__ void ln_row_inplace(__nv_bfloat16* row, int d,
                                               const float* scale,
                                               const float* bias, int lane) {
  const int nvec = d / 8;
  float v[kLnMaxVec][8];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kLnMaxVec; ++j) {
    const int vi = lane + 32 * j;
    if (vi < nvec) {
      const uint4 raw = reinterpret_cast<const uint4*>(row)[vi];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(p[t]);
        v[j][2 * t] = f.x;
        v[j][2 * t + 1] = f.y;
        s += f.x + f.y;
      }
    }
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kLnMaxVec; ++j) {
    if (lane + 32 * j < nvec) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float c = v[j][t] - mean;
        q += c * c;
      }
    }
  }
  const float var = warp_sum(q) / d;
  const float den = (var > 0.f ? sqrtf(var) : 0.f) + kLnEps;
#pragma unroll
  for (int j = 0; j < kLnMaxVec; ++j) {
    const int vi = lane + 32 * j;
    if (vi < nvec) {
      const float4 s0 = reinterpret_cast<const float4*>(scale)[2 * vi];
      const float4 s1 = reinterpret_cast<const float4*>(scale)[2 * vi + 1];
      const float4 b0 = reinterpret_cast<const float4*>(bias)[2 * vi];
      const float4 b1 = reinterpret_cast<const float4*>(bias)[2 * vi + 1];
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 packed;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float y0 = (v[j][2 * t] - mean) / den;
        const float y1 = (v[j][2 * t + 1] - mean) / den;
        p[t] = __floats2bfloat162_rn(y0 * sc[2 * t] + bi[2 * t],
                                     y1 * sc[2 * t + 1] + bi[2 * t + 1]);
      }
      reinterpret_cast<uint4*>(row)[vi] = packed;
    }
  }
}

// Asynchronous 16-byte copy from global to shared memory (sm_80+): the
// thread issues it and goes on; cp_async_wait<N>() blocks until at most N
// of the thread's committed groups are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copy of `rows` rows of `d` bf16 values (d % 8 == 0, rows
// 16-byte aligned) from a dense [*, d] source into shared rows of stride
// `ld`, spread over all `nthreads` threads of the block.
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst, int ld,
                                              const __nv_bfloat16* src,
                                              int rows, int d, int tid,
                                              int nthreads) {
  const int per_row = d / 8;
  for (int i = tid; i < rows * per_row; i += nthreads) {
    const int r = i / per_row, v = i % per_row;
    cp_async16(dst + r * ld + v * 8, src + (size_t)r * d + v * 8);
  }
}

}  // namespace gn

extern "C" const char* gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
