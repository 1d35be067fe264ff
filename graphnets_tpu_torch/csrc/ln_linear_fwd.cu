// y = x.dtype(LN(x)) @ W [+ addend]: the LayerNorm of the rows fused into
// the product that consumes it.
//
// Replaces the Pallas kernel of `ln_matmul`
// (graphnets_tpu/ops/pallas/ln_linear.py, `_fwd_kernel` and `_forward`),
// with its arithmetic: f32 row statistics in the Flux convention
// ((x - mean) / (std + eps), std = 0 where var == 0), the normalised row
// rounded to x's type, the product accumulated in f32, and
//
//   without an addend:  out = f32 partial product
//   with an addend:     out = x.dtype( product + f32(addend) ), one rounding
//
// The addend ([T, dout], f32 or bf16) is read in its stored type.
//
// What bounds it on the H100: at the bucketed headline shape (T = 16384,
// d = dout = 384, bf16 rows, f32 addend) it reads 12.6 MB of x, 25.2 MB of
// addend and 0.3 MB of W and writes 12.6 MB: ~50.6 MB, ~15 us at 3.35 TB/s,
// against 4.8 GFLOP (~5 us of bf16 tensor-core work), so memory bounds it.
// At the sort task's shape (T = 512, d = dout = 384, f32) it is 0.2 GFLOP
// of f32 work on the CUDA cores (~3 us) against 2.9 MB: operations bound
// it, and launch latency is of the same size.
//
// What the design does about it: the normalised rows never reach device
// memory (the TPU kernel's point too): a block normalises its rows in
// shared memory and multiplies them there, and the addend and the output
// are streamed once with 16-byte accesses.
//
// bf16 rows: a block takes 64 rows x 128 output columns; the W column tile
// [d x 128] and the rows arrive by cp.async, each warp normalises rows in
// place, and the product runs on the tensor cores through WMMA (bf16 in,
// f32 accumulate).  x is re-read once per column tile, from L2.
//
// f32 rows: a block takes 32 rows x 128 columns; the normalised rows stay in
// shared memory in f32, W streams through in 32-row slices, and each thread
// accumulates a 4 x 4 tile with plain f32 multiply-adds in order of k: a
// true f32 product, no TF32.
//
// A TMA/wgmma pipeline and a persistent grid are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;    // output columns per block
constexpr int kRows = 64;     // rows per block, bf16
constexpr int kLdw = kCols + 8;
constexpr int kLdc = kCols + 4;
constexpr int kRowsF = 32;    // rows per block, f32
constexpr int kBk = 32;       // W rows per slice, f32

enum Addend { kNone = 0, kF32 = 1, kBf16 = 2 };

// Four addend values of row `row` at column `c`, as f32.
__device__ __forceinline__ float4 addend4(const void* addend, int kind,
                                          size_t row, int dout, int c) {
  if (kind == kF32)
    return gn::load4(static_cast<const float*>(addend) + row * dout + c);
  return gn::load4(static_cast<const __nv_bfloat16*>(addend) + row * dout + c);
}

__global__ void __launch_bounds__(kThreads)
ln_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const void* __restrict__ addend, int kind,
                      void* __restrict__ out, int T, int d, int dout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = d + 8;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* As = Ws + d * kLdw;
  float* Cs = reinterpret_cast<float*>(As + kRows * lda);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, T - row0);
  const int c0 = blockIdx.y * kCols;

  for (int i = tid; i < d * (kCols / 8); i += kThreads) {
    const int k = i / (kCols / 8), v = i % (kCols / 8);
    gn::cp_async16(Ws + k * kLdw + v * 8, w + (size_t)k * dout + c0 + v * 8);
  }
  gn::cp_async_rows(As, lda, x + (size_t)row0 * d, rows, d, tid, kThreads);
  gn::cp_async_commit();
  for (int i = rows * d + tid; i < kRows * d; i += kThreads)
    As[(i / d) * lda + i % d] = __float2bfloat16_rn(0.f);
  gn::cp_async_wait<0>();
  __syncthreads();
  for (int r = warp; r < rows; r += kThreads / 32)
    gn::ln_row_inplace(As + r * lda, d, scale, bias, lane);
  __syncthreads();

  // Warp (rb, ch) takes a 16-row block and a 64-column half of the tile.
  const int rb = warp & 3, ch = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k = 0; k < d; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::load_matrix_sync(fa, As + rb * 16 * lda + k, lda);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fb, Ws + k * kLdw + ch * 64 + j * 16, kLdw);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Cs + rb * 16 * kLdc + ch * 64 + j * 16, acc[j],
                            kLdc, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: product + addend, one rounding; four columns a thread.
  for (int i = tid; i < rows * (kCols / 4); i += kThreads) {
    const int r = i / (kCols / 4), q = i % (kCols / 4);
    const size_t row = (size_t)row0 + r;
    const int c = c0 + q * 4;
    float4 a = *reinterpret_cast<const float4*>(Cs + r * kLdc + q * 4);
    if (kind == kNone) {
      gn::store4(static_cast<float*>(out) + row * dout + c, a);
    } else {
      const float4 v = addend4(addend, kind, row, dout, c);
      a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
      gn::store4(static_cast<__nv_bfloat16*>(out) + row * dout + c, a);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ln_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const void* __restrict__ addend, int kind,
                     float* __restrict__ out, int T, int d, int dout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = d + 4;
  constexpr int kLdb = kCols + 4;
  float* Xn = reinterpret_cast<float*>(smem);   // [kRowsF][ldx]
  float* Ws = Xn + kRowsF * ldx;                // [kBk][kLdb]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRowsF;
  const int rows = min(kRowsF, T - row0);
  const int c0 = blockIdx.y * kCols;

  for (int i = tid; i < kRowsF * (d / 4); i += kThreads) {
    const int r = i / (d / 4), v = (i % (d / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) val = gn::load4(x + ((size_t)row0 + r) * d + v);
    *reinterpret_cast<float4*>(Xn + r * ldx + v) = val;
  }
  __syncthreads();
  // LayerNorm in place, one warp a row; no fused multiply-add, so the
  // rounding is the plain version's.
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* xr = Xn + r * ldx;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += xr[c];
    const float mean = gn::warp_sum(s) / d;
    float q = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = xr[c] - mean;
      q += v * v;
    }
    const float var = gn::warp_sum(q) / d;
    const float den = (var > 0.f ? sqrtf(var) : 0.f) + gn::kLnEps;
    for (int c = lane; c < d; c += 32)
      xr[c] = __fadd_rn(__fmul_rn((xr[c] - mean) / den, scale[c]), bias[c]);
  }
  __syncthreads();

  // Thread (ty, tx) takes rows ty * 4 .. + 3 and columns tx * 4 .. + 3.
  const int ty = warp, tx = lane;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kBk) {
    for (int i = tid; i < kBk * (kCols / 4); i += kThreads) {
      const int kk = i / (kCols / 4), v = (i % (kCols / 4)) * 4;
      *reinterpret_cast<float4*>(Ws + kk * kLdb + v) =
          gn::load4(w + (size_t)(k0 + kk) * dout + c0 + v);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBk; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(Ws + kk * kLdb + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = Xn[(ty * 4 + i) * ldx + k0 + kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) break;
    const size_t row = (size_t)row0 + r;
    const int c = c0 + tx * 4;
    float4 a = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (kind != kNone) {
      const float4 v = addend4(addend, kind, row, dout, c);
      a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
    }
    gn::store4(out + row * dout + c, a);
  }
}

}  // namespace

// Shared memory of one block; the wrapper's gate computes the same sum.
extern "C" size_t gn_ln_matmul_smem(int d, int is_f32) {
  if (is_f32)
    return (size_t)kRowsF * (d + 4) * 4 + (size_t)kBk * (kCols + 4) * 4;
  return (size_t)d * kLdw * 2 + (size_t)kRows * (d + 8) * 2 +
         (size_t)kRows * kLdc * 4;
}

// Launches the kernel on `stream` and returns cudaGetLastError().
// `addend_kind`: 0 none (out is the f32 partial), 1 f32, 2 bf16 (out has x's
// type).  Preconditions, checked by the Python wrapper: x [T, d] and
// w [d, dout] of one type (bf16, or f32 with is_f32), f32 scale and bias,
// addend and out [T, dout], all contiguous and 16-byte aligned; T >= 1;
// d % 128 == 0 and the block's shared memory within the limit (bf16:
// d <= 384); dout % 128 == 0.
extern "C" int gn_ln_matmul(const void* x, const void* w, const void* scale,
                            const void* bias, const void* addend, void* out,
                            int T, int d, int dout, int is_f32,
                            int addend_kind, void* stream) {
  const size_t smem = gn_ln_matmul_smem(d, is_f32);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
    cudaError_t err = cudaFuncSetAttribute(
        ln_matmul_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T + kRowsF - 1) / kRowsF, dout / kCols);
    ln_matmul_f32_kernel<<<grid, kThreads, smem, s>>>(
        (const float*)x, (const float*)w, (const float*)scale,
        (const float*)bias, addend, addend_kind, (float*)out, T, d, dout);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      ln_matmul_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kRows - 1) / kRows, dout / kCols);
  ln_matmul_bf16_kernel<<<grid, kThreads, smem, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)scale,
      (const float*)bias, addend, addend_kind, out, T, d, dout);
  return cudaGetLastError();
}
