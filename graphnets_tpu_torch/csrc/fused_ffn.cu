// Fused LayerNorm -> FeedForward -> residual, forward.
//
// Replaces the Pallas forward kernel of `ln_ffn_residual`
// (graphnets_tpu/ops/pallas/fused_ffn.py, `_fwd_kernel` and
// `_fused_forward`), with its rounding points:
//
//   y = bf16( xf + ((bf16(relu(bf16(LN(x)) @ W1 + b1)) @ W2 + b2)
//                   + f32(extra)) )
//
// What bounds it on the H100: 4 * T * d * 4d operations (38.7 GFLOP at
// T = 16384, d = 384) against ~40 MB of traffic, so the tensor cores
// bound it: ~39 us at 989 TFLOP/s bf16, ~12 us of memory.
//
// What the design does about it: the [rows, 4d] hidden activation never
// leaves the SM.  A block takes 64 rows, keeps their LN'd bf16 copy in
// shared memory and walks the hidden dimension in slices of 32: it forms
// the slice relu(xn @ W1[:, j] + b1[j]) in shared memory, rounds it to
// bf16 and adds slice @ W2[j, :] into an f32 [64, d] accumulator held in
// registers (the binding resource: 8 warps x d/32 WMMA fragments, which
// caps the row tile at 64 for d = 384).  With few row tiles (T = 1024 or 8
// on the node and graph sets) that leaves most SMs idle and one block's
// serial walk over 4d/32 slices sets the time, so up to 8 blocks split the
// hidden dimension of a row tile and the last to finish adds their f32
// partials in a fixed order.  The W1/W2 slices stream from L2
// through a two-stage cp.async ring, so the next slice is in flight while
// the tensor cores work on this one.  Products run through WMMA (bf16 in,
// f32 accumulate); a TMA/wgmma pipeline with larger row tiles is later
// work.  Rows past T (T = 8 on the graph set) are zero-filled and never
// written.
//
// `extra` is read and the result goes to a separate buffer: the kernel
// does not alias `extra` into the output as the TPU kernel does.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kRows = 64;     // rows per block
constexpr int kSlice = 32;    // hidden columns per step
constexpr int kThreads = 256;

template <int D>
struct Layout {
  static constexpr int kLdx = D + 8;          // LN'd rows, bf16
  static constexpr int kLdw1 = kSlice + 8;    // W1[:, slice], bf16
  static constexpr int kLdw2 = D + 8;         // W2[slice, :], bf16
  static constexpr int kLdhf = kSlice + 4;    // hidden slice, f32
  static constexpr int kLdhs = kSlice + 8;    // hidden slice, bf16
  static constexpr int kLdy = D + 4;          // accumulator spill, f32
  static constexpr int kW1Stage = D * kLdw1;      // elements per stage
  static constexpr int kW2Stage = kSlice * kLdw2;
  static constexpr size_t kX = 0;
  static constexpr size_t kW1 = kX + (size_t)kRows * kLdx * 2;
  static constexpr size_t kW2 = kW1 + (size_t)2 * kW1Stage * 2;
  static constexpr size_t kHf = kW2 + (size_t)2 * kW2Stage * 2;
  static constexpr size_t kHs = kHf + (size_t)kRows * kLdhf * 4;
  static constexpr size_t kBytes = kHs + (size_t)kRows * kLdhs * 2;
  static_assert((size_t)kRows * kLdy * 4 <= kHf, "accumulator spill fits");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
ln_ffn_residual_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ extra,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const __nv_bfloat16* __restrict__ w2,
                       const float* __restrict__ b2,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partial,
                       int* __restrict__ counters, int T) {
  using L = Layout<D>;
  constexpr int DH = 4 * D;
  constexpr int NY = D / 32;  // accumulator fragments per warp
  constexpr int kSteps = DH / kSlice;
  const int splits = gridDim.y;  // blocks sharing one row tile (split-K)
  const int s_begin = blockIdx.y * (kSteps / splits);
  const int s_end = s_begin + kSteps / splits;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + L::kX);
  __nv_bfloat16* W1s = reinterpret_cast<__nv_bfloat16*>(smem + L::kW1);
  __nv_bfloat16* W2s = reinterpret_cast<__nv_bfloat16*>(smem + L::kW2);
  float* Hf = reinterpret_cast<float*>(smem + L::kHf);
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem + L::kHs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, T - row0);
  const int rb = warp & 3, ch = warp >> 2;  // 16-row block, column half

  // Issue the copy of hidden slice `s` of W1 and W2 into ring stage s & 1.
  auto load_slice = [&](int s) {
    const int j0 = s * kSlice;
    __nv_bfloat16* w1s = W1s + (s & 1) * L::kW1Stage;
    __nv_bfloat16* w2s = W2s + (s & 1) * L::kW2Stage;
    for (int i = tid; i < D * (kSlice / 8); i += kThreads) {
      const int k = i / (kSlice / 8), v = i % (kSlice / 8);
      gn::cp_async16(w1s + k * L::kLdw1 + v * 8,
                     w1 + (size_t)k * DH + j0 + v * 8);
    }
    gn::cp_async_rows(w2s, L::kLdw2, w2 + (size_t)j0 * D, kSlice, D, tid,
                      kThreads);
    gn::cp_async_commit();
  };

  // Group 0: this block's x rows; group 1: its first hidden slice.
  gn::cp_async_rows(Xs, L::kLdx, x + (size_t)row0 * D, rows, D, tid,
                    kThreads);
  gn::cp_async_commit();
  load_slice(s_begin);
  for (int i = rows * D + tid; i < kRows * D; i += kThreads)
    Xs[(i / D) * L::kLdx + i % D] = __float2bfloat16_rn(0.f);
  gn::cp_async_wait<1>();
  __syncthreads();
  for (int r = warp; r < rows; r += kThreads / 32)
    gn::ln_row_inplace(Xs + r * L::kLdx, D, scale, bias, lane);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> yacc[NY];
#pragma unroll
  for (int f = 0; f < NY; ++f) wmma::fill_fragment(yacc[f], 0.f);

  for (int s = s_begin; s < s_end; ++s) {
    if (s + 1 < s_end) {
      load_slice(s + 1);
      gn::cp_async_wait<1>();
    } else {
      gn::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* w1s = W1s + (s & 1) * L::kW1Stage;
    const __nv_bfloat16* w2s = W2s + (s & 1) * L::kW2Stage;
    const int j0 = s * kSlice;

    // Hidden slice [64, 32] = xn @ W1[:, j0:j0+32]; one fragment a warp,
    // summed in kChains independent chains so the tensor core is not
    // waiting on one accumulator.
    {
      constexpr int kChains = 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[kChains];
#pragma unroll
      for (int c = 0; c < kChains; ++c) wmma::fill_fragment(hacc[c], 0.f);
#pragma unroll
      for (int k = 0; k < D; k += 16 * kChains) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          const int kk = k + 16 * c;
          wmma::load_matrix_sync(fa, Xs + rb * 16 * L::kLdx + kk, L::kLdx);
          wmma::load_matrix_sync(fb, w1s + kk * L::kLdw1 + ch * 16,
                                 L::kLdw1);
          wmma::mma_sync(hacc[c], fa, fb, hacc[c]);
        }
      }
#pragma unroll
      for (int i = 0; i < hacc[0].num_elements; ++i)
        hacc[0].x[i] = (hacc[0].x[i] + hacc[1].x[i]) +
                       (hacc[2].x[i] + hacc[3].x[i]);
      wmma::store_matrix_sync(Hf + rb * 16 * L::kLdhf + ch * 16, hacc[0],
                              L::kLdhf, wmma::mem_row_major);
    }
    __syncthreads();

    for (int i = tid; i < kRows * kSlice; i += kThreads) {
      const int r = i / kSlice, c = i % kSlice;
      const float v = Hf[r * L::kLdhf + c] + b1[j0 + c];
      Hs[r * L::kLdhs + c] = __float2bfloat16_rn(v > 0.f ? v : 0.f);
    }
    __syncthreads();

    // acc[64, D] += hidden slice @ W2[j0:j0+32, :]; warp: 16 rows x D/2.
#pragma unroll
    for (int k = 0; k < kSlice; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Hs + rb * 16 * L::kLdhs + k, L::kLdhs);
#pragma unroll
      for (int f = 0; f < NY; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, w2s + k * L::kLdw2 + ch * (D / 2) + f * 16,
                               L::kLdw2);
        wmma::mma_sync(yacc[f], fa, fb, yacc[f]);
      }
    }
    // The next iteration refills the other stage; this one is free only
    // after every warp is done with it.
    __syncthreads();
  }

  // Spill the accumulator over the (now free) operand buffers.
  float* Ys = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int f = 0; f < NY; ++f)
    wmma::store_matrix_sync(Ys + rb * 16 * L::kLdy + ch * (D / 2) + f * 16,
                            yacc[f], L::kLdy, wmma::mem_row_major);
  __syncthreads();

  if (splits > 1) {
    // Split-K over the hidden dimension: publish this block's partial sum;
    // the last of the row tile's blocks to arrive adds the partials in
    // split order (deterministic) and finishes the rows.
    float* mine = partial + (size_t)blockIdx.y * T * D;
    for (int i = tid; i < rows * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(mine + (size_t)(row0 + r) * D + c) =
          *reinterpret_cast<const float4*>(Ys + r * L::kLdy + c);
    }
    __threadfence();
    __syncthreads();
    int* last = reinterpret_cast<int*>(smem + L::kHs);
    if (tid == 0) *last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int i = tid; i < rows * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const size_t g = (size_t)(row0 + r) * D + c;
      float4 a = __ldcg(reinterpret_cast<const float4*>(partial + g));
      for (int k = 1; k < splits; ++k) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(
            partial + (size_t)k * T * D + g));
        a.x += p.x; a.y += p.y; a.z += p.z; a.w += p.w;
      }
      *reinterpret_cast<float4*>(Ys + r * L::kLdy + c) = a;
    }
    __syncthreads();
  }

  // Epilogue: y = bf16(xf + ((acc + b2) + extra)) with xf re-read from x.
  for (int i = tid; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const size_t g = (size_t)(row0 + r) * D + c;
    const float4 a = *reinterpret_cast<const float4*>(Ys + r * L::kLdy + c);
    const float4 bb = *reinterpret_cast<const float4*>(b2 + c);
    float t[4] = {a.x + bb.x, a.y + bb.y, a.z + bb.z, a.w + bb.w};
    if (extra != nullptr) {
      const uint2 ev = *reinterpret_cast<const uint2*>(extra + g);
      const float2 e0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ev.x));
      const float2 e1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ev.y));
      t[0] += e0.x; t[1] += e0.y; t[2] += e1.x; t[3] += e1.y;
    }
    const uint2 xv = *reinterpret_cast<const uint2*>(x + g);
    const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.x));
    const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.y));
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x0.x + t[0], x0.y + t[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x1.x + t[2], x1.y + t[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + g) = packed;
  }
}

template <int D>
int launch(const void* x, const void* extra, const void* scale,
           const void* bias, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, void* partial, void* counters, int T,
           int splits, cudaStream_t stream) {
  if (splits < 1 || (4 * D / kSlice) % splits) return cudaErrorInvalidValue;
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ln_ffn_residual_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kRows - 1) / kRows, splits);
  ln_ffn_residual_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)extra,
      (const float*)scale, (const float*)bias, (const __nv_bfloat16*)w1,
      (const float*)b1, (const __nv_bfloat16*)w2, (const float*)b2,
      (__nv_bfloat16*)out, (float*)partial, (int*)counters, T);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError().
// `extra` may be null.  `splits` blocks share each 64-row tile, each taking
// 1/splits of the hidden dimension; with splits > 1, `partial` is f32
// scratch of splits * T * d and `counters` holds ceil(T / 64) zeroed ints.
// Preconditions, checked by the Python wrapper: bf16 x/extra/w1/w2/out,
// f32 scale/bias/b1/b2, contiguous, T >= 1, d in {128, 256, 384}, and
// splits dividing 4d / 32.
extern "C" int gn_ln_ffn_residual(const void* x, const void* extra,
                                  const void* scale, const void* bias,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out,
                                  void* partial, void* counters, int T, int d,
                                  int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 128: return launch<128>(x, extra, scale, bias, w1, b1, w2, b2, out, partial, counters, T, splits, s);
    case 256: return launch<256>(x, extra, scale, bias, w1, b1, w2, b2, out, partial, counters, T, splits, s);
    case 384: return launch<384>(x, extra, scale, bias, w1, b1, w2, b2, out, partial, counters, T, splits, s);
    default: return cudaErrorInvalidValue;
  }
}
