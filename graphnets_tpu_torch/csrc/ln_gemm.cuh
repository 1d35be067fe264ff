// One f32 output tile of  [LN](x) @ W  with x streamed in k-chunks, for the
// f32 rows of the single-graph edge update (edge_update_g1.cu), and the row
// statistics that ln_linear_fwd.cu's f32 kernel shares.
//
// A block first takes the row statistics of its rows straight from device
// memory (Flux convention: s = std + eps, std = 0 where var == 0; a few
// lanes a row, every load independent), then walks d in chunks of 32 that
// wait in registers while the chunk before them multiplies: the x chunk is
// normalised as it goes to shared memory (((x - mean) / s) * scale + bias,
// no fused multiply-add), and every thread accumulates a 4 x 4 piece of the
// 32 x 128 tile with plain f32 multiply-adds in order of k (never TF32); the
// tile ends in the caller's registers.  Shared memory does not depend on d,
// so no width is refused for it.
#pragma once

#include "common.cuh"

namespace gn {

constexpr int kGemmThreads = 256;
constexpr int kTileCols = 128;
constexpr int kLdc = kTileCols + 4;

// Mean and s = std + eps of kRows rows of x from device memory, by the
// whole block: kThreads / kRows neighbouring lanes share a row, each
// with its own loads (all independent, so they are in flight together:
// one warp walking its rows one after the other would wait out a memory
// latency per row and pass), and add their sums by shuffles.  Rows past
// `rows` get mean 0, s 1.  st[r * 2], st[r * 2 + 1]; the caller syncs.
template <int kRows, int kThreads = kGemmThreads, typename T>
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
    st[r * 2] = r < rows ? mean : 0.f;
    st[r * 2 + 1] = r < rows ? (var > 0.f ? sqrtf(var) : 0.f) + kLnEps : 1.f;
  }
}

// ---- f32 rows --------------------------------------------------------------

constexpr int kTileRowsF = 32;
constexpr int kKcF = 32;
constexpr int kLdaF = kKcF + 1;
constexpr int kLdbF = kTileCols + 4;
constexpr size_t kTileXBytesF = (size_t)kTileRowsF * kLdaF * 4;
constexpr size_t kTileWBytesF = (size_t)kKcF * kLdbF * 4;
constexpr size_t kTileStBytesF = (size_t)kTileRowsF * 2 * 4;
constexpr size_t kTileCsBytesF = (size_t)kTileRowsF * kLdc * 4;
// Layout: x chunk | W chunk | row statistics | Cs (for callers that want
// the tile in shared memory).
constexpr size_t kTileBytesF =
    kTileXBytesF + kTileWBytesF + kTileStBytesF + kTileCsBytesF;

__device__ __forceinline__ float* tile_cs_f32(unsigned char* smem) {
  return reinterpret_cast<float*>(smem + kTileXBytesF + kTileWBytesF +
                                  kTileStBytesF);
}

// acc[i][j] = ([LN](x) @ w)[row0 + warp * 4 + i][c0 + lane * 4 + j].
template <bool kLn>
__device__ __forceinline__ void ln_gemm_tile_f32(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias, int T,
    int d, int dout, int row0, int c0, unsigned char* smem,
    float (&acc)[4][4]) {
  float* Xn = reinterpret_cast<float*>(smem);
  float* Ws = reinterpret_cast<float*>(smem + kTileXBytesF);
  float* st = reinterpret_cast<float*>(smem + kTileXBytesF + kTileWBytesF);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = min(kTileRowsF, T - row0);
  // A chunk is 4 x values and 4 float4 of W a thread.
  static_assert(kTileRowsF * kKcF == 4 * kGemmThreads &&
                kKcF * (kTileCols / 4) == 4 * kGemmThreads, "4 a thread");
  float xv[4];
  float4 wv[4];
  auto fetch = [&](int k0) {  // chunk k0 from device memory into registers
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * kGemmThreads;
      const int r = i / kKcF, kk = i % kKcF;
      xv[j] = r < rows ? x[(size_t)(row0 + r) * d + k0 + kk] : 0.f;
      const int wk = i / (kTileCols / 4), v = (i % (kTileCols / 4)) * 4;
      wv[j] = load4(w + (size_t)(k0 + wk) * dout + c0 + v);
    }
  };
  auto stash = [&](int k0) {  // ... normalised, into shared memory
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * kGemmThreads;
      const int r = i / kKcF, kk = i % kKcF;
      float v = xv[j];
      if (kLn && r < rows)
        v = __fadd_rn(__fmul_rn((v - st[r * 2]) / st[r * 2 + 1],
                                scale[k0 + kk]), bias[k0 + kk]);
      Xn[r * kLdaF + kk] = v;
      const int wk = i / (kTileCols / 4), c = (i % (kTileCols / 4)) * 4;
      *reinterpret_cast<float4*>(Ws + wk * kLdbF + c) = wv[j];
    }
  };
  fetch(0);
  if (kLn) tile_row_stats<kTileRowsF>(x, d, row0, rows, st);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();
  for (int k0 = 0; k0 < d; k0 += kKcF) {
    stash(k0);
    __syncthreads();
    if (k0 + kKcF < d) fetch(k0 + kKcF);
#pragma unroll 8
    for (int kk = 0; kk < kKcF; ++kk) {
      const float4 b =
          *reinterpret_cast<const float4*>(Ws + kk * kLdbF + lane * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = Xn[(warp * 4 + i) * kLdaF + kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
}

}  // namespace gn
