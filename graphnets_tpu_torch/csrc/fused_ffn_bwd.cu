// Backward of the fused LayerNorm -> FeedForward -> residual
//
//   y = x [+ extra] + (relu(LN(x) @ W1 + b1) @ W2 + b2)
//
// for the cotangent g of y: dx, dscale, dbias, dW1, db1, dW2, db2.
//
// Replaces the Pallas kernel of `_fused_backward`
// (graphnets_tpu/ops/pallas/fused_ffn.py, `_bwd_kernel`), with its
// arithmetic: only x is kept from the forward; per row tile the LN
// statistics (Flux convention, std = 0 and sigma = 1 where var == 0), the
// normalised rows xn = bf16(z * scale + bias) and the hidden activation are
// recomputed, and
//
//   hp  = xn @ W1 + b1 (f32),   h = bf16(relu(hp))
//   db2 = sum_rows f32(g),      dW2 = h^T @ g
//   dh  = g @ W2^T,             dhp = dh where hp > 0 else 0 (mask from f32)
//   db1 = sum_rows dhp,         dW1 = xn^T @ bf16(dhp)
//   dxn = bf16(dhp) @ W1^T,     dscale = sum_rows dxn * z,  dbias = sum_rows dxn
//   dz  = dxn * scale
//   dx  = bf16( (dz - mean(dz)) / s - (z - mean(z)) * (mean(dz * z) / sigma)
//               + f32(g) )
//
// with every product accumulated in f32 on the tensor cores (WMMA, bf16 in).
//
// What bounds it on the H100: 12 * T * d * 4d operations in the TPU
// kernel's count (3.3 TFLOP at T = 1,048,576, d = 256: ~3.3 ms at
// 989 TFLOP/s) against 3 * T * d * 2 bytes (1.6 GB, ~0.5 ms): the tensor
// cores bound it.
//
// What the design does about it.  The [T, 4d] hidden activation never
// reaches device memory.  The TPU kernel kept both weight gradients
// (2 x d x 4d f32) resident across its sequential grid; a block here cannot
// hold them, and blocks run in parallel, so the work is split in two passes
// that each recompute hp and dh (14 products of T * d * 4d in all):
//
// 1. Row pass (dx and the three [d] sums).  A block walks 64-row tiles with
//    a grid stride.  It keeps xn and g of the tile in shared memory, walks
//    the hidden dimension in slices of 32 whose W1 and W2 pieces stream
//    through a two-stage cp.async ring, forms hp and dh of the slice, masks,
//    rounds, and adds bf16(dhp) @ W1[:, slice]^T into an f32 [64, d]
//    accumulator in registers.  Then the LN pullback and the residual
//    passthrough give dx.  Its column sums of dxn * z, dxn and g are added
//    tile after tile (fixed order) and written once per block.
// 2. Weight pass (dW1, dW2, db1).  A block owns one 32-wide hidden slice and
//    one range of rows (split-K): W1[:, slice] and W2[slice, :] stay in
//    shared memory, it walks its rows 32 at a time, rebuilds xn from x and
//    the statistics of pass 1, forms h and bf16(dhp) of the chunk, and adds
//    h^T @ g into an f32 [32, d] and xn^T @ bf16(dhp) into an f32 [d, 32]
//    accumulator in registers.  Blocks of one row range run side by side
//    (the slice is the fast grid dimension), so x and g come from L2.
// 3. The partials of both passes are added in a fixed order: no atomics,
//    deterministic.
//
// A wgmma/TMA pipeline and a single recompute are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // rows per tile, row pass
constexpr int kSlice = 32;    // hidden columns per step
constexpr int kChunk = 32;    // rows per step, weight pass

template <int D>
struct RowLayout {
  static constexpr int kLdx = D + 8;          // xn and g rows, bf16
  static constexpr int kLdw1 = kSlice + 8;    // W1[:, slice], bf16
  static constexpr int kLdw2 = D + 8;         // W2[slice, :], bf16
  static constexpr int kLdhf = kSlice + 4;    // hp / dh slices, f32
  static constexpr int kLdhs = kSlice + 8;    // bf16(dhp) slice
  static constexpr int kLdd = D + 4;          // dxn spill, f32
  static constexpr int kW1Stage = D * kLdw1;
  static constexpr int kW2Stage = kSlice * kLdw2;
  static constexpr size_t kX = 0;
  static constexpr size_t kG = kX + (size_t)kRows * kLdx * 2;
  static constexpr size_t kW1 = kG + (size_t)kRows * kLdx * 2;
  static constexpr size_t kW2 = kW1 + (size_t)2 * kW1Stage * 2;
  static constexpr size_t kHf = kW2 + (size_t)2 * kW2Stage * 2;
  static constexpr size_t kDf = kHf + (size_t)kRows * kLdhf * 4;
  static constexpr size_t kDs = kDf + (size_t)kRows * kLdhf * 4;
  static constexpr size_t kSt = kDs + (size_t)kRows * kLdhs * 2;
  static constexpr size_t kSums = kSt + (size_t)kRows * 3 * 4;
  static constexpr size_t kBytes = kSums + (size_t)3 * D * 4;
  // The dxn spill reuses the rings and the f32 slices.
  static_assert((size_t)kRows * kLdd * 4 <= kDs - kW1, "dxn spill fits");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ w1,
                    const float* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2,
                    __nv_bfloat16* __restrict__ dx, float* __restrict__ stats,
                    float* __restrict__ part_ds, float* __restrict__ part_db,
                    float* __restrict__ part_db2, int T) {
  using L = RowLayout<D>;
  constexpr int DH = 4 * D;
  constexpr int NY = D / 32;  // dxn fragments a warp
  constexpr int kSteps = DH / kSlice;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + L::kX);
  __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(smem + L::kG);
  __nv_bfloat16* W1s = reinterpret_cast<__nv_bfloat16*>(smem + L::kW1);
  __nv_bfloat16* W2s = reinterpret_cast<__nv_bfloat16*>(smem + L::kW2);
  float* Hf = reinterpret_cast<float*>(smem + L::kHf);
  float* Df = reinterpret_cast<float*>(smem + L::kDf);
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem + L::kDs);
  float* st = reinterpret_cast<float*>(smem + L::kSt);
  float* sums = reinterpret_cast<float*>(smem + L::kSums);
  float* Dx = reinterpret_cast<float*>(smem + L::kW1);  // dxn spill

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = warp & 3, ch = warp >> 2;
  for (int i = tid; i < 3 * D; i += kThreads) sums[i] = 0.f;

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

  const int tiles = (T + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    const int rows = min(kRows, T - row0);
    __syncthreads();  // the previous tile's readers of the buffers are done
    gn::cp_async_rows(Xs, L::kLdx, x + (size_t)row0 * D, rows, D, tid,
                      kThreads);
    gn::cp_async_rows(Gs, L::kLdx, g + (size_t)row0 * D, rows, D, tid,
                      kThreads);
    gn::cp_async_commit();
    load_slice(0);
    for (int i = rows * D + tid; i < kRows * D; i += kThreads) {
      Xs[(i / D) * L::kLdx + i % D] = __float2bfloat16_rn(0.f);
      Gs[(i / D) * L::kLdx + i % D] = __float2bfloat16_rn(0.f);
    }
    gn::cp_async_wait<1>();
    __syncthreads();

    // Statistics, then xn in place; one warp a row.
    for (int r = warp; r < kRows; r += kThreads / 32) {
      __nv_bfloat16* xr = Xs + r * L::kLdx;
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s += __bfloat162float(xr[c]);
      const float mean = gn::warp_sum(s) / D;
      float q = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float v = __bfloat162float(xr[c]) - mean;
        q += v * v;
      }
      const float var = gn::warp_sum(q) / D;
      const float sd = var > 0.f ? sqrtf(var) : 0.f;
      const float sv = sd + gn::kLnEps;
      if (lane == 0) {
        st[r * 3] = mean;
        st[r * 3 + 1] = sv;
        st[r * 3 + 2] = var > 0.f ? sd : 1.f;
        if (r < rows) {
          stats[(size_t)(row0 + r) * 2] = mean;
          stats[(size_t)(row0 + r) * 2 + 1] = sv;
        }
      }
      if (r < rows)
        for (int c = lane; c < D; c += 32)
          xr[c] = __float2bfloat16_rn(__fadd_rn(
              __fmul_rn((__bfloat162float(xr[c]) - mean) / sv, scale[c]),
              bias[c]));
    }

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> yacc[NY];
#pragma unroll
    for (int f = 0; f < NY; ++f) wmma::fill_fragment(yacc[f], 0.f);

    for (int s = 0; s < kSteps; ++s) {
      if (s + 1 < kSteps) {
        load_slice(s + 1);
        gn::cp_async_wait<1>();
      } else {
        gn::cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* w1s = W1s + (s & 1) * L::kW1Stage;
      const __nv_bfloat16* w2s = W2s + (s & 1) * L::kW2Stage;
      const int j0 = s * kSlice;

      // hp and dh of the slice, [64, 32] each: one fragment of each a warp
      // (rows rb * 16, columns ch * 16), two chains each.
      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[2], dacc[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          wmma::fill_fragment(hacc[c], 0.f);
          wmma::fill_fragment(dacc[c], 0.f);
        }
#pragma unroll
        for (int k = 0; k < D; k += 32) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kk = k + 16 * c;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fa, Xs + rb * 16 * L::kLdx + kk, L::kLdx);
            wmma::load_matrix_sync(fb, w1s + kk * L::kLdw1 + ch * 16,
                                   L::kLdw1);
            wmma::mma_sync(hacc[c], fa, fb, hacc[c]);
            // dh = g @ W2[slice, :]^T: B(k, n) = W2s[n][k].
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> ft;
            wmma::load_matrix_sync(fa, Gs + rb * 16 * L::kLdx + kk, L::kLdx);
            wmma::load_matrix_sync(ft, w2s + ch * 16 * L::kLdw2 + kk,
                                   L::kLdw2);
            wmma::mma_sync(dacc[c], fa, ft, dacc[c]);
          }
        }
#pragma unroll
        for (int i = 0; i < hacc[0].num_elements; ++i) {
          hacc[0].x[i] += hacc[1].x[i];
          dacc[0].x[i] += dacc[1].x[i];
        }
        wmma::store_matrix_sync(Hf + rb * 16 * L::kLdhf + ch * 16, hacc[0],
                                L::kLdhf, wmma::mem_row_major);
        wmma::store_matrix_sync(Df + rb * 16 * L::kLdhf + ch * 16, dacc[0],
                                L::kLdhf, wmma::mem_row_major);
      }
      __syncthreads();

      for (int i = tid; i < kRows * kSlice; i += kThreads) {
        const int r = i / kSlice, c = i % kSlice;
        const float hp = Hf[r * L::kLdhf + c] + b1[j0 + c];
        Ds[r * L::kLdhs + c] =
            __float2bfloat16_rn(hp > 0.f ? Df[r * L::kLdhf + c] : 0.f);
      }
      __syncthreads();

      // dxn[64, D] += bf16(dhp) @ W1[:, slice]^T: B(k, n) = W1s[n][k].
#pragma unroll
      for (int k = 0; k < kSlice; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Ds + rb * 16 * L::kLdhs + k, L::kLdhs);
#pragma unroll
        for (int f = 0; f < NY; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(
              fb, w1s + (ch * (D / 2) + f * 16) * L::kLdw1 + k, L::kLdw1);
          wmma::mma_sync(yacc[f], fa, fb, yacc[f]);
        }
      }
      // The next iteration refills the other stage and rewrites Hf, Df, Ds.
      __syncthreads();
    }

#pragma unroll
    for (int f = 0; f < NY; ++f)
      wmma::store_matrix_sync(Dx + rb * 16 * L::kLdd + ch * (D / 2) + f * 16,
                              yacc[f], L::kLdd, wmma::mem_row_major);
    __syncthreads();

    // dx, one warp a row; z from the raw x (re-read: Xs holds xn now).
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float mean = st[r * 3], sv = st[r * 3 + 1], sigma = st[r * 3 + 2];
      const __nv_bfloat16* xr = x + (size_t)(row0 + r) * D;
      const float* dr = Dx + r * L::kLdd;
      float sdz = 0.f, sdzz = 0.f, sz = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float z = (__bfloat162float(xr[c]) - mean) / sv;
        const float dz = dr[c] * scale[c];
        sdz += dz;
        sdzz += dz * z;
        sz += z;
      }
      const float mean_dz = gn::warp_sum(sdz) / D;
      const float mean_dzz = gn::warp_sum(sdzz) / D;
      const float mean_z = gn::warp_sum(sz) / D;
      __nv_bfloat16* out = dx + (size_t)(row0 + r) * D;
      for (int c = lane; c < D; c += 32) {
        const float z = (__bfloat162float(xr[c]) - mean) / sv;
        const float dz = dr[c] * scale[c];
        const float dxf = (dz - mean_dz) / sv -
                          (z - mean_z) * (mean_dzz / sigma);
        out[c] = __float2bfloat16_rn(
            dxf + __bfloat162float(Gs[r * L::kLdx + c]));
      }
    }
    // Column sums of dxn * z, dxn and g over this tile's rows, in order.
    for (int c = tid; c < D; c += kThreads) {
      float sds = sums[c], sdb = sums[D + c], sg = sums[2 * D + c];
      for (int r = 0; r < rows; ++r) {
        const float z =
            (__bfloat162float(x[(size_t)(row0 + r) * D + c]) - st[r * 3]) /
            st[r * 3 + 1];
        const float dv = Dx[r * L::kLdd + c];
        sds += dv * z;
        sdb += dv;
        sg += __bfloat162float(Gs[r * L::kLdx + c]);
      }
      sums[c] = sds;
      sums[D + c] = sdb;
      sums[2 * D + c] = sg;
    }
  }
  __syncthreads();
  for (int c = tid; c < D; c += kThreads) {
    part_ds[(size_t)blockIdx.x * D + c] = sums[c];
    part_db[(size_t)blockIdx.x * D + c] = sums[D + c];
    part_db2[(size_t)blockIdx.x * D + c] = sums[2 * D + c];
  }
}

template <int D>
struct WeightLayout {
  static constexpr int kLdx = D + 8;          // xn and g chunks, bf16
  static constexpr int kLdw1 = kSlice + 8;
  static constexpr int kLdw2 = D + 8;
  static constexpr int kLdhf = kSlice + 4;
  static constexpr int kLdhs = kSlice + 8;
  static constexpr size_t kX = 0;
  static constexpr size_t kG = kX + (size_t)kChunk * kLdx * 2;
  static constexpr size_t kW1 = kG + (size_t)kChunk * kLdx * 2;
  static constexpr size_t kW2 = kW1 + (size_t)D * kLdw1 * 2;
  static constexpr size_t kHf = kW2 + (size_t)kSlice * kLdw2 * 2;
  static constexpr size_t kDf = kHf + (size_t)kChunk * kLdhf * 4;
  static constexpr size_t kHs = kDf + (size_t)kChunk * kLdhf * 4;
  static constexpr size_t kDs = kHs + (size_t)kChunk * kLdhs * 2;
  static constexpr size_t kBytes = kDs + (size_t)kChunk * kLdhs * 2;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_weights_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ g,
                       const float* __restrict__ stats,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const __nv_bfloat16* __restrict__ w2,
                       float* __restrict__ part_dw1,
                       float* __restrict__ part_db1,
                       float* __restrict__ part_dw2, int T,
                       int rows_per_split) {
  using L = WeightLayout<D>;
  constexpr int DH = 4 * D;
  constexpr int NW = D / 128;   // 16-column (dW2) / 16-row (dW1) groups a warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + L::kX);
  __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(smem + L::kG);
  __nv_bfloat16* W1s = reinterpret_cast<__nv_bfloat16*>(smem + L::kW1);
  __nv_bfloat16* W2s = reinterpret_cast<__nv_bfloat16*>(smem + L::kW2);
  float* Hf = reinterpret_cast<float*>(smem + L::kHf);
  float* Df = reinterpret_cast<float*>(smem + L::kDf);
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem + L::kHs);
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem + L::kDs);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int j0 = blockIdx.x * kSlice;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(T, r_begin + rows_per_split);

  for (int i = tid; i < D * (kSlice / 8); i += kThreads) {
    const int k = i / (kSlice / 8), v = (i % (kSlice / 8)) * 8;
    *reinterpret_cast<uint4*>(W1s + k * L::kLdw1 + v) =
        *reinterpret_cast<const uint4*>(w1 + (size_t)k * DH + j0 + v);
  }
  for (int i = tid; i < kSlice * (D / 8); i += kThreads) {
    const int k = i / (D / 8), v = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(W2s + k * L::kLdw2 + v) =
        *reinterpret_cast<const uint4*>(w2 + (size_t)(j0 + k) * D + v);
  }

  // dW2[slice, :] (2 x NW fragments a warp: 32 hidden rows x D / 8
  // columns) and dW1[:, slice] (NW x 2: D / 8 rows x 32 hidden columns).
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[2][NW];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1[NW][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      wmma::fill_fragment(acc2[i][j], 0.f);
      wmma::fill_fragment(acc1[j][i], 0.f);
    }
  float db1 = 0.f;  // threads 0..31: the column's sum of dhp

  for (int r0 = r_begin; r0 < r_end; r0 += kChunk) {
    // xn and g rows of the chunk; rows past r_end are zeros.
    for (int i = tid; i < kChunk * (D / 8); i += kThreads) {
      const int rr = i / (D / 8), v = (i % (D / 8)) * 8;
      const int row = r0 + rr;
      uint4 xa = make_uint4(0u, 0u, 0u, 0u), ga = xa;
      if (row < r_end) {
        const float mean = stats[(size_t)row * 2];
        const float sv = stats[(size_t)row * 2 + 1];
        const uint4 raw =
            *reinterpret_cast<const uint4*>(x + (size_t)row * D + v);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&xa);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(p[t]);
          const int c = v + 2 * t;
          q[t] = __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn((f.x - mean) / sv, scale[c]), bias[c]),
              __fadd_rn(__fmul_rn((f.y - mean) / sv, scale[c + 1]),
                        bias[c + 1]));
        }
        ga = *reinterpret_cast<const uint4*>(g + (size_t)row * D + v);
      }
      *reinterpret_cast<uint4*>(Xs + rr * L::kLdx + v) = xa;
      *reinterpret_cast<uint4*>(Gs + rr * L::kLdx + v) = ga;
    }
    __syncthreads();

    // Warps 0-3: hp = xn @ W1[:, slice]; warps 4-7: dh = g @ W2[slice, :]^T;
    // [32, 32] each, one fragment a warp.
    {
      const int w = warp & 3, rb = w & 1, cb = w >> 1;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> a0, a1;
      wmma::fill_fragment(a0, 0.f);
      wmma::fill_fragment(a1, 0.f);
      if (warp < 4) {
#pragma unroll
        for (int k = 0; k < D; k += 32) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Xs + rb * 16 * L::kLdx + k, L::kLdx);
          wmma::load_matrix_sync(fb, W1s + k * L::kLdw1 + cb * 16, L::kLdw1);
          wmma::mma_sync(a0, fa, fb, a0);
          wmma::load_matrix_sync(fa, Xs + rb * 16 * L::kLdx + k + 16, L::kLdx);
          wmma::load_matrix_sync(fb, W1s + (k + 16) * L::kLdw1 + cb * 16,
                                 L::kLdw1);
          wmma::mma_sync(a1, fa, fb, a1);
        }
      } else {
#pragma unroll
        for (int k = 0; k < D; k += 32) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Gs + rb * 16 * L::kLdx + k, L::kLdx);
          wmma::load_matrix_sync(fb, W2s + cb * 16 * L::kLdw2 + k, L::kLdw2);
          wmma::mma_sync(a0, fa, fb, a0);
          wmma::load_matrix_sync(fa, Gs + rb * 16 * L::kLdx + k + 16, L::kLdx);
          wmma::load_matrix_sync(fb, W2s + cb * 16 * L::kLdw2 + k + 16,
                                 L::kLdw2);
          wmma::mma_sync(a1, fa, fb, a1);
        }
      }
#pragma unroll
      for (int i = 0; i < a0.num_elements; ++i) a0.x[i] += a1.x[i];
      wmma::store_matrix_sync((warp < 4 ? Hf : Df) + rb * 16 * L::kLdhf +
                                  cb * 16,
                              a0, L::kLdhf, wmma::mem_row_major);
    }
    __syncthreads();

    for (int i = tid; i < kChunk * kSlice; i += kThreads) {
      const int r = i / kSlice, c = i % kSlice;
      const float hp = Hf[r * L::kLdhf + c] + b1[j0 + c];
      const float dhp = hp > 0.f ? Df[r * L::kLdhf + c] : 0.f;
      Hs[r * L::kLdhs + c] = __float2bfloat16_rn(hp > 0.f ? hp : 0.f);
      Ds[r * L::kLdhs + c] = __float2bfloat16_rn(dhp);
      Df[r * L::kLdhf + c] = dhp;
    }
    __syncthreads();
    if (tid < kSlice)
      for (int r = 0; r < kChunk; ++r) db1 += Df[r * L::kLdhf + tid];

    // dW2[slice, :] += h^T @ g and dW1[:, slice] += xn^T @ bf16(dhp); the
    // A operands are the chunks read column-major (k = the chunk's rows).
#pragma unroll
    for (int k = 0; k < kChunk; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fh[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fd[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fh[i], Hs + k * L::kLdhs + i * 16, L::kLdhs);
        wmma::load_matrix_sync(fd[i], Ds + k * L::kLdhs + i * 16, L::kLdhs);
      }
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int c = warp * (D / 8) + j * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fg;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fx;
        wmma::load_matrix_sync(fg, Gs + k * L::kLdx + c, L::kLdx);
        wmma::load_matrix_sync(fx, Xs + k * L::kLdx + c, L::kLdx);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(acc2[i][j], fh[i], fg, acc2[i][j]);
          wmma::mma_sync(acc1[j][i], fx, fd[i], acc1[j][i]);
        }
      }
    }
    __syncthreads();  // the next chunk rewrites every buffer
  }

  float* o1 = part_dw1 + (size_t)blockIdx.y * D * DH;
  float* o2 = part_dw2 + (size_t)blockIdx.y * DH * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int c = warp * (D / 8) + j * 16;
      wmma::store_matrix_sync(o2 + (size_t)(j0 + i * 16) * D + c, acc2[i][j],
                              D, wmma::mem_row_major);
      wmma::store_matrix_sync(o1 + (size_t)c * DH + j0 + i * 16, acc1[j][i],
                              DH, wmma::mem_row_major);
    }
  if (tid < kSlice) part_db1[(size_t)blockIdx.y * DH + j0 + tid] = db1;
}

// out[i] = sum over p of part[p * n + i], in a fixed order: lane group j
// adds the partials p = j, j + 8, ... in turn, then the 8 sums are added in
// order of j.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ part, int parts, int n,
                       float* __restrict__ out) {
  __shared__ float sums[kThreads / 32][32];
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (i < n)
    for (int p = j; p < parts; p += kThreads / 32)
      acc += part[(size_t)p * n + i];
  sums[j][lane] = acc;
  __syncthreads();
  if (j == 0 && i < n) {
    float t = sums[0][lane];
#pragma unroll
    for (int q = 1; q < kThreads / 32; ++q) t += sums[q][lane];
    out[i] = t;
  }
}

int reduce(const void* part, int parts, int n, void* out,
           cudaStream_t stream) {
  reduce_partials_kernel<<<(n + 31) / 32, kThreads, 0, stream>>>(
      (const float*)part, parts, n, (float*)out);
  return cudaGetLastError();
}

template <int D>
int launch(const void* x, const void* g, const void* scale, const void* bias,
           const void* w1, const void* b1, const void* w2, void* dx, void* ds,
           void* db, void* dw1, void* db1, void* dw2, void* db2, void* stats,
           void* part_rows, void* part_dw1, void* part_db1, void* part_dw2,
           int T, int row_blocks, int rows_per_split, cudaStream_t s) {
  constexpr int DH = 4 * D;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)RowLayout<D>::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ffn_bwd_weights_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WeightLayout<D>::kBytes);
  if (err != cudaSuccess) return err;
  float* pr = (float*)part_rows;
  float* p_ds = pr;
  float* p_db = pr + (size_t)row_blocks * D;
  float* p_db2 = pr + (size_t)2 * row_blocks * D;
  ffn_bwd_rows_kernel<D><<<row_blocks, kThreads, RowLayout<D>::kBytes, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (const float*)scale,
      (const float*)bias, (const __nv_bfloat16*)w1, (const float*)b1,
      (const __nv_bfloat16*)w2, (__nv_bfloat16*)dx, (float*)stats, p_ds, p_db,
      p_db2, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int splits = (T + rows_per_split - 1) / rows_per_split;
  const dim3 grid(DH / kSlice, splits);
  ffn_bwd_weights_kernel<D><<<grid, kThreads, WeightLayout<D>::kBytes, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (const float*)stats,
      (const float*)scale, (const float*)bias, (const __nv_bfloat16*)w1,
      (const float*)b1, (const __nv_bfloat16*)w2, (float*)part_dw1,
      (float*)part_db1, (float*)part_dw2, T, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int e;
  if ((e = reduce(p_ds, row_blocks, D, ds, s)) != 0) return e;
  if ((e = reduce(p_db, row_blocks, D, db, s)) != 0) return e;
  if ((e = reduce(p_db2, row_blocks, D, db2, s)) != 0) return e;
  if ((e = reduce(part_dw1, splits, D * DH, dw1, s)) != 0) return e;
  if ((e = reduce(part_db1, splits, DH, db1, s)) != 0) return e;
  return reduce(part_dw2, splits, DH * D, dw2, s);
}

}  // namespace

// Runs the passes on `stream` and returns the first launch error.  Scratch,
// allocated by the Python wrapper, all f32: stats [T, 2], part_rows
// [3, row_blocks, d], part_dw1 [splits, d, 4d], part_db1 [splits, 4d],
// part_dw2 [splits, 4d, d], where splits = ceil(T / rows_per_split).
// Preconditions, checked there: bf16 x, g [T, d], w1 [d, 4d], w2 [4d, d];
// f32 scale, bias [d] and b1 [4d]; contiguous and 16-byte aligned; T >= 1;
// d in {128, 256}; row_blocks >= 1; rows_per_split % 32 == 0.
extern "C" int gn_ln_ffn_backward(const void* x, const void* g,
                                  const void* scale, const void* bias,
                                  const void* w1, const void* b1,
                                  const void* w2, void* dx, void* ds, void* db,
                                  void* dw1, void* db1, void* dw2, void* db2,
                                  void* stats, void* part_rows,
                                  void* part_dw1, void* part_db1,
                                  void* part_dw2, int T, int d,
                                  int row_blocks, int rows_per_split,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 128:
      return launch<128>(x, g, scale, bias, w1, b1, w2, dx, ds, db, dw1, db1,
                         dw2, db2, stats, part_rows, part_dw1, part_db1,
                         part_dw2, T, row_blocks, rows_per_split, s);
    case 256:
      return launch<256>(x, g, scale, bias, w1, b1, w2, dx, ds, db, dw1, db1,
                         dw2, db2, stats, part_rows, part_dw1, part_db1,
                         part_dw2, T, row_blocks, rows_per_split, s);
    default:
      return cudaErrorInvalidValue;
  }
}
