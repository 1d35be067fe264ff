// Fused LayerNorm -> FeedForward -> residual, forward.
//
// Replaces the Pallas forward kernel of `ln_ffn_residual`
// (graphnets_tpu/ops/pallas/fused_ffn.py, `_fwd_kernel` and
// `_fused_forward`), with its rounding points:
//
//   y = T( xf + ((T(relu(T(LN(x)) @ W1 + b1)) @ W2 + b2) + f32(extra)) )
//
// for rows of type T, bf16 or f32, and d = 128, 256, 384 or 512 (the JAX
// gate's widths: d % 128 == 0 and both weights within its VMEM budget).
//
// What bounds it on the H100: 4 * T * d * 4d operations (38.7 GFLOP at
// T = 16384, d = 384) against ~40 MB of traffic, so the tensor cores
// bound it: ~39 us at 989 TFLOP/s bf16, ~12 us of memory.
//
// bf16 rows.  The [rows, 4d] hidden activation never leaves the SM.  A
// block takes R rows (64; 32 at d = 512), keeps their LN'd bf16 copy in
// shared memory and walks the hidden dimension in slices of 32: it forms
// the slice relu(xn @ W1[:, j] + b1[j]) in shared memory, rounds it to
// bf16 and adds slice @ W2[j, :] into an f32 [R, d] accumulator held in
// registers (the binding resource: R * d / 256 f32 a thread, which is why
// the row tile halves at d = 512).  With few row tiles (T = 1024 or 8
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
// f32 rows (no caller trains or infers through them at the driven shapes;
// the kernel exists because the JAX gate takes them): true-f32 products on
// the CUDA cores, never TF32.  A block takes 32 rows, normalises them in
// f32 in shared memory, and walks the hidden dimension in slices of 32
// whose W1 and W2 pieces it loads whole; every thread forms 4 hidden values
// and keeps d / 8 output values, each a sum of multiply-adds in order of k.
//
// `extra` is read and the result goes to a separate buffer: the kernel
// does not alias `extra` into the output as the TPU kernel does.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kSlice = 32;    // hidden columns per step
constexpr int kThreads = 256;

// Rows a bf16 block takes at width D.
constexpr int rows_for(int D) { return D > 384 ? 32 : 64; }

template <int D, int R>
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
  static constexpr size_t kW1 = kX + (size_t)R * kLdx * 2;
  static constexpr size_t kW2 = kW1 + (size_t)2 * kW1Stage * 2;
  static constexpr size_t kHf = kW2 + (size_t)2 * kW2Stage * 2;
  static constexpr size_t kHs = kHf + (size_t)R * kLdhf * 4;
  static constexpr size_t kBytes = kHs + (size_t)R * kLdhs * 2;
  static_assert((size_t)R * kLdy * 4 <= kHf, "accumulator spill fits");
  static_assert(kBytes <= 227 * 1024, "fits an SM's shared memory");
};

template <int D, int R>
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
  using L = Layout<D, R>;
  constexpr int DH = 4 * D;
  constexpr int RB = R / 16;        // 16-row blocks
  constexpr int CG = 8 / RB;        // column groups of the accumulator
  constexpr int NY = D / (16 * CG); // accumulator fragments per warp
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
  const int row0 = blockIdx.x * R;
  const int rows = min(R, T - row0);
  const int rb = warp % RB, cg = warp / RB;  // accumulator: rows, columns

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
  for (int i = rows * D + tid; i < R * D; i += kThreads)
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

    // Hidden slice [R, 32] = xn @ W1[:, j0:j0+32]: RB x 2 fragments, one a
    // warp (warps past them wait), summed in kChains independent chains so
    // the tensor core is not waiting on one accumulator.
    if (warp < RB * 2) {
      const int hb = warp % RB, hc = warp / RB;
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
          wmma::load_matrix_sync(fa, Xs + hb * 16 * L::kLdx + kk, L::kLdx);
          wmma::load_matrix_sync(fb, w1s + kk * L::kLdw1 + hc * 16,
                                 L::kLdw1);
          wmma::mma_sync(hacc[c], fa, fb, hacc[c]);
        }
      }
#pragma unroll
      for (int i = 0; i < hacc[0].num_elements; ++i)
        hacc[0].x[i] = (hacc[0].x[i] + hacc[1].x[i]) +
                       (hacc[2].x[i] + hacc[3].x[i]);
      wmma::store_matrix_sync(Hf + hb * 16 * L::kLdhf + hc * 16, hacc[0],
                              L::kLdhf, wmma::mem_row_major);
    }
    __syncthreads();

    for (int i = tid; i < R * kSlice; i += kThreads) {
      const int r = i / kSlice, c = i % kSlice;
      const float v = Hf[r * L::kLdhf + c] + b1[j0 + c];
      Hs[r * L::kLdhs + c] = __float2bfloat16_rn(v > 0.f ? v : 0.f);
    }
    __syncthreads();

    // acc[R, D] += hidden slice @ W2[j0:j0+32, :]; warp: 16 rows x D/CG.
#pragma unroll
    for (int k = 0; k < kSlice; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Hs + rb * 16 * L::kLdhs + k, L::kLdhs);
#pragma unroll
      for (int f = 0; f < NY; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, w2s + k * L::kLdw2 + cg * (D / CG) + f * 16,
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
    wmma::store_matrix_sync(Ys + rb * 16 * L::kLdy + cg * (D / CG) + f * 16,
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
    float4 t = make_float4(a.x + bb.x, a.y + bb.y, a.z + bb.z, a.w + bb.w);
    if (extra != nullptr) {
      const float4 e = gn::load4(extra + g);
      t.x += e.x; t.y += e.y; t.z += e.z; t.w += e.w;
    }
    const float4 xv = gn::load4(x + g);
    gn::store4(out + g, make_float4(xv.x + t.x, xv.y + t.y, xv.z + t.z,
                                    xv.w + t.w));
  }
}

// ---- f32 rows --------------------------------------------------------------

constexpr int kRowsF32 = 32;

template <int D>
struct LayoutF32 {
  static constexpr int kLdx = D + 4;          // LN'd rows
  static constexpr int kLdw1 = kSlice + 4;    // W1[:, slice]
  static constexpr int kLdw2 = D + 4;         // W2[slice, :]
  static constexpr int kLdh = kSlice + 4;     // hidden slice
  static constexpr size_t kX = 0;
  static constexpr size_t kW1 = kX + (size_t)kRowsF32 * kLdx * 4;
  static constexpr size_t kW2 = kW1 + (size_t)D * kLdw1 * 4;
  static constexpr size_t kH = kW2 + (size_t)kSlice * kLdw2 * 4;
  static constexpr size_t kBytes = kH + (size_t)kRowsF32 * kLdh * 4;
  static_assert(kBytes <= 227 * 1024, "fits an SM's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
ln_ffn_residual_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ extra,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2,
                           float* __restrict__ out, int T) {
  using L = LayoutF32<D>;
  constexpr int DH = 4 * D;
  constexpr int NC = D / 32;  // 4-column groups a thread keeps
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem + L::kX);
  float* W1s = reinterpret_cast<float*>(smem + L::kW1);
  float* W2s = reinterpret_cast<float*>(smem + L::kW2);
  float* Hs = reinterpret_cast<float*>(smem + L::kH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRowsF32;
  const int rows = min(kRowsF32, T - row0);

  // LN of each row in f32, one warp a row: the plain version's arithmetic
  // ((x - mean) / (std + eps)) * scale + bias.
  for (int r = warp; r < kRowsF32; r += kThreads / 32) {
    float* xs = Xs + r * L::kLdx;
    if (r >= rows) {
      for (int c = lane; c < D; c += 32) xs[c] = 0.f;
      continue;
    }
    const float* xr = x + (size_t)(row0 + r) * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += xr[c];
    const float mean = gn::warp_sum(s) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = xr[c] - mean;
      q += v * v;
    }
    const float var = gn::warp_sum(q) / D;
    const float den = (var > 0.f ? sqrtf(var) : 0.f) + gn::kLnEps;
    for (int c = lane; c < D; c += 32)
      xs[c] = __fadd_rn(__fmul_rn((xr[c] - mean) / den, scale[c]), bias[c]);
  }

  // Thread roles: hidden values (row hr, columns hc .. hc + 3) and output
  // values (row yr, columns yc + 32 j .. + 3).
  const int hr = tid / 8, hc = (tid % 8) * 4;
  const int yr = tid / 8, yc = (tid % 8) * 4;
  float acc[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[j][t] = 0.f;

  for (int j0 = 0; j0 < DH; j0 += kSlice) {
    __syncthreads();  // the previous slice's readers are done
    for (int i = tid; i < D * (kSlice / 4); i += kThreads) {
      const int k = i / (kSlice / 4), v = (i % (kSlice / 4)) * 4;
      *reinterpret_cast<float4*>(W1s + k * L::kLdw1 + v) =
          *reinterpret_cast<const float4*>(w1 + (size_t)k * DH + j0 + v);
    }
    for (int i = tid; i < kSlice * (D / 4); i += kThreads) {
      const int k = i / (D / 4), v = (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(W2s + k * L::kLdw2 + v) =
          *reinterpret_cast<const float4*>(w2 + (size_t)(j0 + k) * D + v);
    }
    __syncthreads();
    {
      float h[4] = {0.f, 0.f, 0.f, 0.f};
      const float* xs = Xs + hr * L::kLdx;
      for (int k = 0; k < D; ++k) {
        const float a = xs[k];
        const float4 w =
            *reinterpret_cast<const float4*>(W1s + k * L::kLdw1 + hc);
        h[0] = fmaf(a, w.x, h[0]);
        h[1] = fmaf(a, w.y, h[1]);
        h[2] = fmaf(a, w.z, h[2]);
        h[3] = fmaf(a, w.w, h[3]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float v = h[t] + b1[j0 + hc + t];
        Hs[hr * L::kLdh + hc + t] = v > 0.f ? v : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kSlice; ++k) {
      const float a = Hs[yr * L::kLdh + k];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 w =
            *reinterpret_cast<const float4*>(W2s + k * L::kLdw2 + yc + 32 * j);
        acc[j][0] = fmaf(a, w.x, acc[j][0]);
        acc[j][1] = fmaf(a, w.y, acc[j][1]);
        acc[j][2] = fmaf(a, w.z, acc[j][2]);
        acc[j][3] = fmaf(a, w.w, acc[j][3]);
      }
    }
  }

  // Epilogue: y = xf + ((acc + b2) + extra).
  if (yr < rows) {
    const size_t base = (size_t)(row0 + yr) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = yc + 32 * j;
      const float4 bb = *reinterpret_cast<const float4*>(b2 + c);
      float4 t = make_float4(acc[j][0] + bb.x, acc[j][1] + bb.y,
                             acc[j][2] + bb.z, acc[j][3] + bb.w);
      if (extra != nullptr) {
        const float4 e = *reinterpret_cast<const float4*>(extra + base + c);
        t.x += e.x; t.y += e.y; t.z += e.z; t.w += e.w;
      }
      const float4 xv = *reinterpret_cast<const float4*>(x + base + c);
      *reinterpret_cast<float4*>(out + base + c) =
          make_float4(xv.x + t.x, xv.y + t.y, xv.z + t.z, xv.w + t.w);
    }
  }
}

template <int D>
int launch(const void* x, const void* extra, const void* scale,
           const void* bias, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, void* partial, void* counters, int T,
           int splits, int is_f32, cudaStream_t stream) {
  cudaError_t err;
  if (is_f32) {
    const size_t smem = LayoutF32<D>::kBytes;
    err = cudaFuncSetAttribute(ln_ffn_residual_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    ln_ffn_residual_f32_kernel<D>
        <<<(T + kRowsF32 - 1) / kRowsF32, kThreads, smem, stream>>>(
            (const float*)x, (const float*)extra, (const float*)scale,
            (const float*)bias, (const float*)w1, (const float*)b1,
            (const float*)w2, (const float*)b2, (float*)out, T);
    return cudaGetLastError();
  }
  constexpr int R = rows_for(D);
  if (splits < 1 || (4 * D / kSlice) % splits) return cudaErrorInvalidValue;
  const size_t smem = Layout<D, R>::kBytes;
  err = cudaFuncSetAttribute(ln_ffn_residual_kernel<D, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, splits);
  ln_ffn_residual_kernel<D, R><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)extra,
      (const float*)scale, (const float*)bias, (const __nv_bfloat16*)w1,
      (const float*)b1, (const __nv_bfloat16*)w2, (const float*)b2,
      (__nv_bfloat16*)out, (float*)partial, (int*)counters, T);
  return cudaGetLastError();
}

}  // namespace

// Rows of one bf16 block at width d (the split-K counters count row tiles).
extern "C" int gn_ln_ffn_residual_rows(int d) { return rows_for(d); }

// Launches the kernel on `stream` and returns cudaGetLastError().
// `extra` may be null.  bf16 rows: `splits` blocks share each row tile of
// gn_ln_ffn_residual_rows(d) rows, each taking 1/splits of the hidden
// dimension; with splits > 1, `partial` is f32 scratch of splits * T * d
// and `counters` holds one zeroed int a row tile.  f32 rows (is_f32 = 1):
// splits, partial and counters are unused.
// Preconditions, checked by the Python wrapper: x/extra/w1/w2/out all of
// the rows' type, f32 scale/bias/b1/b2, contiguous, T >= 1, d in
// {128, 256, 384, 512}, and splits dividing 4d / 32.
extern "C" int gn_ln_ffn_residual(const void* x, const void* extra,
                                  const void* scale, const void* bias,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out,
                                  void* partial, void* counters, int T, int d,
                                  int splits, int is_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 128: return launch<128>(x, extra, scale, bias, w1, b1, w2, b2, out, partial, counters, T, splits, is_f32, s);
    case 256: return launch<256>(x, extra, scale, bias, w1, b1, w2, b2, out, partial, counters, T, splits, is_f32, s);
    case 384: return launch<384>(x, extra, scale, bias, w1, b1, w2, b2, out, partial, counters, T, splits, is_f32, s);
    case 512: return launch<512>(x, extra, scale, bias, w1, b1, w2, b2, out, partial, counters, T, splits, is_f32, s);
    default: return cudaErrorInvalidValue;
  }
}
