// Row statistics of a tile of rows straight from device memory, for the
// f32 rows of ln_linear_fwd.cu, ln_linear_bwd.cu and edge_update_g1.cu.
#pragma once

#include "common.cuh"

namespace gn {

constexpr int kGemmThreads = 256;

// Mean and s = std + eps (Flux convention: std = 0 where var == 0) of
// kRows rows of x from device memory, by the whole block: kThreads /
// kRows neighbouring lanes share a row, each with its own loads (all
// independent, so they are in flight together: one warp walking its rows
// one after the other would wait out a memory latency per row and pass),
// and add their sums by shuffles.  Rows past `rows` get mean 0, s 1.
// st[r * 2], st[r * 2 + 1]; with kSigma st[r * 3 .. r * 3 + 2] = mean, s
// and sigma = std, or 1 where var == 0.  The caller syncs.
template <int kRows, int kThreads = kGemmThreads, bool kSigma = false,
          typename T>
__device__ __forceinline__ void tile_row_stats(const T* __restrict__ x,
                                               int d, int row0, int rows,
                                               float* st) {
  constexpr int kPer = kThreads / kRows;  // lanes a row: 4 or 8
  const int tid = threadIdx.x, r = tid / kPer, j = tid % kPer;
  const T* xr = x + (size_t)(row0 + min(r, rows - 1)) * d;
  float s = 0.f;
#pragma unroll 8
  for (int c = j * 4; c < d; c += kPer * 4) {
    const float4 v = load4(xr + c);
    s += (v.x + v.y) + (v.z + v.w);
  }
#pragma unroll
  for (int o = kPer / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / d;
  float q = 0.f;
#pragma unroll 8
  for (int c = j * 4; c < d; c += kPer * 4) {
    const float4 v = load4(xr + c);
    const float a = v.x - mean, b = v.y - mean, e = v.z - mean,
                f = v.w - mean;
    q += (a * a + b * b) + (e * e + f * f);
  }
#pragma unroll
  for (int o = kPer / 2; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  const float var = q / d;
  if (j == 0) {
    constexpr int kSt = kSigma ? 3 : 2;
    const float sd = var > 0.f ? sqrtf(var) : 0.f;
    st[r * kSt] = r < rows ? mean : 0.f;
    st[r * kSt + 1] = r < rows ? sd + kLnEps : 1.f;
    if (kSigma) st[r * kSt + 2] = r < rows && var > 0.f ? sd : 1.f;
  }
}

}  // namespace gn
