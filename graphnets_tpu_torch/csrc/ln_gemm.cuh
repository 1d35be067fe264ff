// One output tile of  [LN](x) @ W  with x streamed in k-chunks, for the
// kernels that fuse a LayerNorm into the product consuming it
// (ln_linear_fwd.cu; the f32 rows of edge_update_g1.cu).
//
// A block first takes the row statistics of its rows straight from device
// memory (Flux convention: s = std + eps, std = 0 where var == 0; a few
// lanes a row, every load independent), then
// walks d in chunks: the raw x chunk and the W chunk arrive by cp.async into
// a two-stage ring, the x chunk is normalised in place
// (((x - mean) / s) * scale + bias, no fused multiply-add, rounded to x's
// type for bf16 rows), and the product accumulates in f32.  Shared memory
// does not depend on d, so no width is refused for it.
//
// bf16 rows: 64 rows x 128 columns a block, chunks of 64, WMMA (bf16 in,
// f32 accumulate); the f32 tile ends in shared memory (Cs, stride kLdc).
// f32 rows: 32 rows x 128 columns, chunks of 32 that wait in registers
// while the chunk before them multiplies, every thread a 4 x 4 piece
// accumulated with plain f32 multiply-adds in order of k (never TF32); the
// tile ends in the caller's registers.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace gn {

constexpr int kGemmThreads = 256;
constexpr int kTileCols = 128;
constexpr int kLdc = kTileCols + 4;

// ---- bf16 rows -------------------------------------------------------------

constexpr int kTileRows = 64;
constexpr int kKc = 64;                 // k-chunk
constexpr int kLda = kKc + 8;           // x chunk stride
constexpr int kLdb = kTileCols + 8;     // W chunk stride
constexpr size_t kTileXBytes = (size_t)2 * kTileRows * kLda * 2;
constexpr size_t kTileWBytes = (size_t)2 * kKc * kLdb * 2;
constexpr size_t kTileStBytes = (size_t)kTileRows * 2 * 4;
constexpr size_t kTileCsBytes = (size_t)kTileRows * kLdc * 4;
// Layout: x ring | W ring | row statistics; the f32 tile Cs is written over
// the rings once the product is done (so that more blocks fit an SM).
static_assert(kTileCsBytes <= kTileXBytes + kTileWBytes, "Cs fits the rings");
constexpr size_t kTileBytes = kTileXBytes + kTileWBytes + kTileStBytes;

__device__ __forceinline__ float* tile_cs(unsigned char* smem) {
  return reinterpret_cast<float*>(smem);
}

// Mean and s = std + eps of kRows rows of x from device memory, by the
// whole block: kGemmThreads / kRows neighbouring lanes share a row, each
// with its own loads (all independent, so they are in flight together:
// one warp walking its rows one after the other would wait out a memory
// latency per row and pass), and add their sums by shuffles.  Rows past
// `rows` get mean 0, s 1.  st[r * 2], st[r * 2 + 1]; the caller syncs.
template <int kRows, typename T>
__device__ __forceinline__ void tile_row_stats(const T* __restrict__ x,
                                               int d, int row0, int rows,
                                               float* st) {
  constexpr int kPer = kGemmThreads / kRows;  // lanes a row: 4 or 8
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

// Cs[64][kLdc] = [LN](x[row0 : row0 + 64, :]) @ w[:, c0 : c0 + 128].
// Rows past T read as zeros.  All 256 threads call it; Cs is complete after
// the trailing __syncthreads().
template <bool kLn>
__device__ __forceinline__ void ln_gemm_tile_bf16(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias, int T,
    int d, int dout, int row0, int c0, unsigned char* smem) {
  using namespace nvcuda;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + kTileXBytes);
  float* st = reinterpret_cast<float*>(smem + kTileXBytes + kTileWBytes);
  float* Cs = tile_cs(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rows = min(kTileRows, T - row0);

  auto load_chunk = [&](int k0, int stage) {
    __nv_bfloat16* xs = Xs + stage * kTileRows * kLda;
    __nv_bfloat16* ws = Ws + stage * kKc * kLdb;
    for (int i = tid; i < kTileRows * (kKc / 8); i += kGemmThreads) {
      const int r = i / (kKc / 8), v = (i % (kKc / 8)) * 8;
      if (r < rows)
        cp_async16(xs + r * kLda + v, x + (size_t)(row0 + r) * d + k0 + v);
      else
        *reinterpret_cast<uint4*>(xs + r * kLda + v) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = tid; i < kKc * (kTileCols / 8); i += kGemmThreads) {
      const int k = i / (kTileCols / 8), v = (i % (kTileCols / 8)) * 8;
      cp_async16(ws + k * kLdb + v, w + (size_t)(k0 + k) * dout + c0 + v);
    }
    cp_async_commit();
  };

  load_chunk(0, 0);
  if (kLn) tile_row_stats<kTileRows>(x, d, row0, rows, st);

  const int rb = warp & 3, ch = warp >> 2;  // 16 rows x 64 columns a warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0, step = 0; k0 < d; k0 += kKc, ++step) {
    const int stage = step & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk `step` landed; every warp is done with step - 1
    if (k0 + kKc < d) load_chunk(k0 + kKc, stage ^ 1);
    __nv_bfloat16* xs = Xs + stage * kTileRows * kLda;
    const __nv_bfloat16* ws = Ws + stage * kKc * kLdb;
    if (kLn) {
      for (int i = tid; i < kTileRows * (kKc / 8); i += kGemmThreads) {
        const int r = i / (kKc / 8), v = (i % (kKc / 8)) * 8;
        if (r >= rows) continue;
        const float mean = st[r * 2], s = st[r * 2 + 1];
        uint4 raw = *reinterpret_cast<const uint4*>(xs + r * kLda + v);
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(p[t]);
          const int c = k0 + v + 2 * t;
          p[t] = __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn((f.x - mean) / s, scale[c]), bias[c]),
              __fadd_rn(__fmul_rn((f.y - mean) / s, scale[c + 1]),
                        bias[c + 1]));
        }
        *reinterpret_cast<uint4*>(xs + r * kLda + v) = raw;
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, xs + rb * 16 * kLda + kk, kLda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, ws + kk * kLdb + ch * 64 + j * 16, kLdb);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();  // every warp is done with the rings: Cs goes over them
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Cs + rb * 16 * kLdc + ch * 64 + j * 16, acc[j],
                            kLdc, wmma::mem_row_major);
  __syncthreads();
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
