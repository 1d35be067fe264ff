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
// memory (the TPU kernel's point too).  A block takes a tile of rows and 128
// output columns through the streaming tile of ln_gemm.cuh: it takes its
// rows' statistics from device memory first and then walks d in chunks, the
// raw x chunk and the W chunk arriving together, the x chunk normalised in
// shared memory and multiplied there.  Shared memory does not depend on d,
// so every width of the JAX package's gate runs this one kernel.  x is read
// twice (the second time from L2, and once more per column tile); the
// addend and the output are streamed once with 16-byte accesses.
//
// bf16 rows: 64 rows x 128 columns a block, the product on the tensor cores
// through WMMA (bf16 in, f32 accumulate).
//
// f32 rows: 32 rows x 128 columns a block, each thread a 4 x 4 piece
// accumulated with plain f32 multiply-adds in order of k: a true f32
// product, no TF32.
//
// A TMA/wgmma pipeline and a persistent grid are later work.

#include "ln_gemm.cuh"

namespace {

constexpr int kThreads = gn::kGemmThreads;
constexpr int kCols = gn::kTileCols;   // output columns per block

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
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * gn::kTileRows, c0 = blockIdx.y * kCols;
  const int rows = min(gn::kTileRows, T - row0);
  gn::ln_gemm_tile_bf16<true>(x, w, scale, bias, T, d, dout, row0, c0, smem);
  const float* Cs = gn::tile_cs(smem);
  for (int i = tid; i < rows * (kCols / 4); i += kThreads) {
    const int r = i / (kCols / 4), q = i % (kCols / 4);
    const size_t row = (size_t)row0 + r;
    const int c = c0 + q * 4;
    float4 a = *reinterpret_cast<const float4*>(Cs + r * gn::kLdc + q * 4);
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * gn::kTileRowsF, c0 = blockIdx.y * kCols;
  const int rows = min(gn::kTileRowsF, T - row0);
  float acc[4][4];
  gn::ln_gemm_tile_f32<true>(x, w, scale, bias, T, d, dout, row0, c0, smem,
                             acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    if (r >= rows) break;
    const size_t row = (size_t)row0 + r;
    const int c = c0 + lane * 4;
    float4 a = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (kind != kNone) {
      const float4 v = addend4(addend, kind, row, dout, c);
      a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
    }
    gn::store4(out + row * dout + c, a);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError().
// `addend_kind`: 0 none (out is the f32 partial), 1 f32, 2 bf16 (out has x's
// type).  Preconditions, checked by the Python wrapper: x [T, d] and
// w [d, dout] of one type (bf16, or f32 with is_f32), f32 scale and bias,
// addend and out [T, dout], all contiguous and 16-byte aligned; T >= 1;
// d % 128 == 0; dout % 128 == 0.
extern "C" int gn_ln_matmul(const void* x, const void* w, const void* scale,
                            const void* bias, const void* addend, void* out,
                            int T, int d, int dout, int is_f32,
                            int addend_kind, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
    const dim3 grid((T + gn::kTileRowsF - 1) / gn::kTileRowsF, dout / kCols);
    ln_matmul_f32_kernel<<<grid, kThreads, gn::kTileBytesF, s>>>(
        (const float*)x, (const float*)w, (const float*)scale,
        (const float*)bias, addend, addend_kind, (float*)out, T, d, dout);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      ln_matmul_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gn::kTileBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + gn::kTileRows - 1) / gn::kTileRows, dout / kCols);
  ln_matmul_bf16_kernel<<<grid, kThreads, gn::kTileBytes, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)scale,
      (const float*)bias, addend, addend_kind, out, T, d, dout);
  return cudaGetLastError();
}
