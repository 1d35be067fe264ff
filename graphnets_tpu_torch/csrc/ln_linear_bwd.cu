// Backward of y = bf16(LN(x)) @ W: dx, dW, dscale and dbias.
//
// Replaces the Pallas kernel of `ln_linear._backward`
// (graphnets_tpu/ops/pallas/ln_linear.py, `_bwd_kernel`), with its
// arithmetic: the LN statistics are recomputed from x (Flux convention,
// s = std + eps, std = 0 where var == 0, sigma = std or 1 where var == 0),
//
//   z   = (x - mean) / s,   xn = bf16(z * scale + bias)
//   dxn = g @ W^T                          (bf16 in, f32 accumulate)
//   dW  = xn^T @ g,  dscale = sum_rows dxn * z,  dbias = sum_rows dxn
//   dz  = dxn * scale
//   dx  = bf16( (dz - mean(dz)) / s - (z - mean(z)) * (mean(dz * z) / sigma) )
//
// What bounds it on the H100: at the main-path shape (T = 16384,
// d = dout = 384) it reads x and g (25 MB), writes dx (12.6 MB) and the
// f32 dW (0.6 MB): ~38.6 MB, ~11.5 us at 3.35 TB/s, against 9.7 GFLOP
// (~9.8 us of bf16 tensor-core work).
//
// What the design does about it.  The TPU kernel carried dW, dscale and
// dbias across its sequential grid; blocks here run in parallel, so the
// sums over rows are split and then added in a fixed order (no atomics;
// deterministic):
//
// 1. Row pass, one block per 32 rows: x and g rows arrive by cp.async,
//    each warp takes the statistics of its rows (also written out, 8 bytes
//    a row, for pass 2), dxn = g @ W^T runs on the tensor cores (WMMA)
//    into shared memory while W streams through a two-stage cp.async ring
//    of 32-column slices shared by the block's warps, dx is written, and
//    the block's column sums of dxn * z and dxn go to a partial row each.
// 2. dW pass: dW = xn^T @ g as a split-K product, one block per 128 x 128
//    tile of dW and per range of rows (about two blocks an SM); raw x and
//    g rows of the next step and their statistics arrive by cp.async
//    while this step's xn is rebuilt from x and multiplied; each block
//    writes its f32 partial tile.
// 3. Reduce: the partials of dW, dscale and dbias are added in partial
//    order.
//
// A wgmma/TMA pipeline and a fused reduction are later work.
//
// Pass 1 in two steps.  The row pass above keeps a block's x and g rows, a
// W^T ring and the f32 dxn rows in shared memory and its accumulators in
// registers sized by d, so it is built for d = 128 .. 512 in bf16.  Any
// other width of the JAX package's gate (and a dout whose g rows outgrow
// shared memory) takes pass 1 in two steps whose shared memory does not
// depend on the widths: a tiled product dxn = g @ W^T into an f32 [T, d]
// scratch in device memory, then a pullback pass (one warp a row) that
// reads x and dxn, writes dx and the statistics and adds the block's column
// sums.  Passes 2 and 3 are the same.  The scratch costs one extra write
// and read of T * d * 4 bytes, which is why bf16 rows keep the one-step row
// pass where it fits.
//
// f32 rows (the sort task trains in f32) take every product on the CUDA
// cores in plain f32 multiply-adds, never TF32: pass 1 always in two steps
// (32 x 128 tiles of dxn, 4 x 4 a thread; the scratch is no wider than the
// rows themselves), the dW pass in 64 x 64 tiles, 4 x 4 a thread.  At the
// sort task's shape (T = 512, d = dout = 384) that is 0.4 GFLOP of f32 work
// (~6 us at 67 TFLOP/s) against 3.7 MB, so operations bound it.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;       // rows per block of the row pass
constexpr int kTile = 128;      // dW tile (both dims) of the dW pass
constexpr int kTk = 32;         // rows per step of the dW pass
constexpr int kLdt = kTile + 8;
constexpr int kWk = 32;         // W^T rows (dout) per ring stage, row pass
constexpr int kLdw = kWk + 8;

// Shared memory of a row-pass block: x and g rows, then the W^T ring,
// whose space the f32 dxn rows reuse once the product is done, then the
// per-row statistics.
__host__ __device__ constexpr size_t rows_ring_bytes(int d) {
  return (size_t)2 * d * kLdw * 2 > (size_t)kRows * (d + 4) * 4
             ? (size_t)2 * d * kLdw * 2
             : (size_t)kRows * (d + 4) * 4;
}
__host__ __device__ constexpr size_t rows_smem_bytes(int d, int dout) {
  return (size_t)kRows * (d + 8) * 2 + (size_t)kRows * (dout + 8) * 2 +
         rows_ring_bytes(d) + (size_t)kRows * 3 * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ g,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ stats, float* __restrict__ part_ds,
                   float* __restrict__ part_db, int T, int dout) {
  constexpr int kLdx = D + 8;
  constexpr int kLdd = D + 4;
  constexpr int NF = D / 64;  // dxn fragments a warp (4 column groups)
  const int ldg = dout + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Gs = Xs + kRows * kLdx;
  __nv_bfloat16* Ws = Gs + kRows * ldg;        // 2 stages of [D][kLdw]
  float* Ds = reinterpret_cast<float*>(Ws);    // after the product
  float* st = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Ws) + rows_ring_bytes(D));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, T - row0);

  gn::cp_async_rows(Xs, kLdx, x + (size_t)row0 * D, rows, D, tid, kThreads);
  gn::cp_async_rows(Gs, ldg, g + (size_t)row0 * dout, rows, dout, tid,
                    kThreads);
  gn::cp_async_commit();
  // Issue the copy of W[:, k0:k0 + kWk] (W^T rows k0..) into ring stage.
  auto load_w = [&](int k0, int stage) {
    __nv_bfloat16* dst = Ws + stage * D * kLdw;
    for (int i = tid; i < D * (kWk / 8); i += kThreads) {
      const int n = i / (kWk / 8), v = (i % (kWk / 8)) * 8;
      gn::cp_async16(dst + n * kLdw + v, w + (size_t)n * dout + k0 + v);
    }
    gn::cp_async_commit();
  };
  load_w(0, 0);
  for (int i = rows * D + tid; i < kRows * D; i += kThreads)
    Xs[(i / D) * kLdx + i % D] = __float2bfloat16_rn(0.f);
  for (int i = rows * dout + tid; i < kRows * dout; i += kThreads)
    Gs[(i / dout) * ldg + i % dout] = __float2bfloat16_rn(0.f);
  gn::cp_async_wait<1>();  // x and g rows (the W slice may still fly)
  __syncthreads();

  // Statistics, one warp a row.
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const __nv_bfloat16* xr = Xs + r * kLdx;
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
    if (lane == 0) {
      st[r * 3] = mean;
      st[r * 3 + 1] = sd + gn::kLnEps;
      st[r * 3 + 2] = var > 0.f ? sd : 1.f;
      if (r < rows) {
        stats[(size_t)(row0 + r) * 2] = mean;
        stats[(size_t)(row0 + r) * 2 + 1] = sd + gn::kLnEps;
      }
    }
  }

  // dxn = g @ W^T: warp (rb, cg) takes 16 rows x D/4 columns.  A ring
  // stage holds W[:, k0:k0 + kWk] as [n][k], which is W^T's slice in
  // column-major order.
  {
    const int rb = warp & 1, cg = warp >> 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int k0 = 0; k0 < dout; k0 += kWk) {
      const int stage = (k0 / kWk) & 1;
      if (k0 + kWk < dout) {
        load_w(k0 + kWk, stage ^ 1);
        gn::cp_async_wait<1>();
      } else {
        gn::cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* ws = Ws + stage * D * kLdw;
#pragma unroll
      for (int kk = 0; kk < kWk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Gs + rb * 16 * ldg + k0 + kk, ldg);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          const int n = cg * (D / 4) + f * 16;
          wmma::load_matrix_sync(fb, ws + n * kLdw + kk, kLdw);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
      // The next iteration refills the other stage; this one is free only
      // once every warp is done with it (and Ds reuses the ring after).
      __syncthreads();
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
      wmma::store_matrix_sync(Ds + rb * 16 * kLdd + cg * (D / 4) + f * 16,
                              acc[f], kLdd, wmma::mem_row_major);
  }
  __syncthreads();

  // dx, one warp a row.
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float mean = st[r * 3], s = st[r * 3 + 1], sigma = st[r * 3 + 2];
    const __nv_bfloat16* xr = Xs + r * kLdx;
    const float* dr = Ds + r * kLdd;
    float sdz = 0.f, sdzz = 0.f, sz = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float z = (__bfloat162float(xr[c]) - mean) / s;
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
      const float z = (__bfloat162float(xr[c]) - mean) / s;
      const float dz = dr[c] * scale[c];
      out[c] = __float2bfloat16_rn((dz - mean_dz) / s -
                                   (z - mean_z) * (mean_dzz / sigma));
    }
  }

  // This block's column sums of dxn * z and dxn, rows in order.
  for (int c = tid; c < D; c += kThreads) {
    float sds = 0.f, sdb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float z = (__bfloat162float(Xs[r * kLdx + c]) - st[r * 3]) /
                      st[r * 3 + 1];
      const float d = Ds[r * kLdd + c];
      sds += d * z;
      sdb += d;
    }
    part_ds[(size_t)blockIdx.x * D + c] = sds;
    part_db[(size_t)blockIdx.x * D + c] = sdb;
  }
}

// Partial dW tile: xn[rows]^T @ g[rows] for one 128 x 128 tile and one
// range of rows.  Warp (wm, wn) takes 32 x 64 of the tile.  Raw x and g
// rows of step r0 + kTk stream into one stage of a two-stage ring while
// step r0's xn is built into As and multiplied.
__global__ void __launch_bounds__(kThreads)
ln_bwd_dw_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ g,
                 const float* __restrict__ stats,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ part_dw,
                 int T, int D, int dout, int rows_per_split) {
  // Raw x and g rows [2 stages][k][kLdt], and xn rows [k][m] (the A
  // operand in column-major order).
  __shared__ __align__(128) __nv_bfloat16 Xr[2 * kTk * kLdt];
  __shared__ __align__(128) __nv_bfloat16 Bs[2 * kTk * kLdt];
  __shared__ __align__(128) __nv_bfloat16 As[kTk * kLdt];
  __shared__ __align__(16) float St[2 * kTk * 2];  // rows' mean, s
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(T, r_begin + rows_per_split);
  const int wm = warp & 3, wn = warp >> 2;

  // Issue the copies of rows r0.. (and their statistics) into ring stage
  // `stage`; rows past r_end are zero-filled.
  auto load = [&](int r0, int stage) {
    __nv_bfloat16* xr = Xr + stage * kTk * kLdt;
    __nv_bfloat16* gr = Bs + stage * kTk * kLdt;
    if (tid < kTk / 2) {  // 16 bytes: the statistics of two rows
      const int row = r0 + 2 * tid;
      float* dst = St + stage * kTk * 2 + 4 * tid;
      if (row + 1 < r_end) {
        gn::cp_async16(dst, stats + (size_t)row * 2);
      } else if (row < r_end) {
        dst[0] = stats[(size_t)row * 2];
        dst[1] = stats[(size_t)row * 2 + 1];
      }
    }
    for (int i = tid; i < kTk * (kTile / 8); i += kThreads) {
      const int rr = i / (kTile / 8), v = (i % (kTile / 8)) * 8;
      const int row = r0 + rr;
      if (row < r_end) {
        gn::cp_async16(xr + rr * kLdt + v, x + (size_t)row * D + m0 + v);
        gn::cp_async16(gr + rr * kLdt + v, g + (size_t)row * dout + n0 + v);
      } else {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(xr + rr * kLdt + v) = zero;
        *reinterpret_cast<uint4*>(gr + rr * kLdt + v) = zero;
      }
    }
    gn::cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (r_begin < r_end) load(r_begin, 0);
  for (int r0 = r_begin, step = 0; r0 < r_end; r0 += kTk, ++step) {
    const int stage = step & 1;
    if (r0 + kTk < r_end) {
      load(r0 + kTk, stage ^ 1);
      gn::cp_async_wait<1>();
    } else {
      gn::cp_async_wait<0>();
    }
    __syncthreads();
    // xn = bf16(((x - mean) / s) * scale + bias), rounded as the plain
    // version rounds it (no fused multiply-add).
    const __nv_bfloat16* xr = Xr + stage * kTk * kLdt;
    const float* st = St + stage * kTk * 2;
    for (int i = tid; i < kTk * (kTile / 8); i += kThreads) {
      const int rr = i / (kTile / 8), v = (i % (kTile / 8)) * 8;
      const int row = r0 + rr;
      uint4 xa = make_uint4(0u, 0u, 0u, 0u);
      if (row < r_end) {
        const float mean = st[rr * 2], s = st[rr * 2 + 1];
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + rr * kLdt + v);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&xa);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(p[t]);
          const int c = m0 + v + 2 * t;
          const float y0 = __fadd_rn(__fmul_rn((f.x - mean) / s, scale[c]),
                                     bias[c]);
          const float y1 = __fadd_rn(
              __fmul_rn((f.y - mean) / s, scale[c + 1]), bias[c + 1]);
          q[t] = __floats2bfloat162_rn(y0, y1);
        }
      }
      *reinterpret_cast<uint4*>(As + rr * kLdt + v) = xa;
    }
    __syncthreads();
    const __nv_bfloat16* gs = Bs + stage * kTk * kLdt;
#pragma unroll
    for (int kk = 0; kk < kTk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * kLdt + wm * 32 + i * 16,
                               kLdt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, gs + kk * kLdt + wn * 64 + j * 16, kLdt);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    // The next iteration refills this stage's twin and rewrites As.
    __syncthreads();
  }
  float* out = part_dw + (size_t)blockIdx.z * D * dout;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(
          out + (size_t)(m0 + wm * 32 + i * 16) * dout + n0 + wn * 64 + j * 16,
          acc[i][j], dout, wmma::mem_row_major);
}

// out[i] = sum over p of part[p * n + i], in a fixed order: lane group j
// adds the partials p = j, j + 8, ... in turn, then the 8 sums are added
// in order of j.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ part, int parts, int n,
                       float* __restrict__ out) {
  __shared__ float sums[kThreads / 32][32];
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (i < n)
    for (int p = j; p < parts; p += kThreads / 32) acc += part[(size_t)p * n + i];
  sums[j][lane] = acc;
  __syncthreads();
  if (j == 0 && i < n) {
    float t = sums[0][lane];
#pragma unroll
    for (int q = 1; q < kThreads / 32; ++q) t += sums[q][lane];
    out[i] = t;
  }
}

template <int D>
int launch_rows(const void* x, const void* g, const void* w,
                const void* scale, void* dx, void* stats, void* part_ds,
                void* part_db, int T, int dout, cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(D, dout);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ln_bwd_rows_kernel<D><<<(T + kRows - 1) / kRows, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
      (const __nv_bfloat16*)w, (const float*)scale, (__nv_bfloat16*)dx,
      (float*)stats, (float*)part_ds, (float*)part_db, T, dout);
  return cudaGetLastError();
}

// ---- f32 rows ------------------------------------------------------------

constexpr int kTileF = 64;         // dW tile (both dims), f32 dW pass
constexpr int kLdtF = kTileF + 4;

// Partial dW tile for f32 rows: xn[rows]^T @ g[rows] for one 64 x 64 tile
// and one range of rows; thread (ty, tx) takes a 4 x 4 piece.
__global__ void __launch_bounds__(kThreads)
ln_bwd_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ stats,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     float* __restrict__ part_dw, int T, int D, int dout,
                     int rows_per_split) {
  __shared__ __align__(16) float As[kTk * kLdtF];   // xn rows [k][m]
  __shared__ __align__(16) float Bs[kTk * kLdtF];   // g rows [k][n]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * kTileF, n0 = blockIdx.y * kTileF;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(T, r_begin + rows_per_split);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kTk) {
    for (int i = tid; i < kTk * (kTileF / 4); i += kThreads) {
      const int rr = i / (kTileF / 4), v = (i % (kTileF / 4)) * 4;
      const int row = r0 + rr;
      float4 xa = make_float4(0.f, 0.f, 0.f, 0.f), ga = xa;
      if (row < r_end) {
        const float mean = stats[(size_t)row * 2];
        const float s = stats[(size_t)row * 2 + 1];
        const float4 xv = gn::load4(x + (size_t)row * D + m0 + v);
        const float4 sc = gn::load4(scale + m0 + v);
        const float4 bi = gn::load4(bias + m0 + v);
        xa.x = __fadd_rn(__fmul_rn((xv.x - mean) / s, sc.x), bi.x);
        xa.y = __fadd_rn(__fmul_rn((xv.y - mean) / s, sc.y), bi.y);
        xa.z = __fadd_rn(__fmul_rn((xv.z - mean) / s, sc.z), bi.z);
        xa.w = __fadd_rn(__fmul_rn((xv.w - mean) / s, sc.w), bi.w);
        ga = gn::load4(g + (size_t)row * dout + n0 + v);
      }
      *reinterpret_cast<float4*>(As + rr * kLdtF + v) = xa;
      *reinterpret_cast<float4*>(Bs + rr * kLdtF + v) = ga;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTk; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * kLdtF + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * kLdtF + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
  float* out = part_dw + (size_t)blockIdx.z * D * dout;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    gn::store4(out + (size_t)(m0 + ty * 4 + i) * dout + n0 + tx * 4,
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// ---- pass 1 in two steps ------------------------------------------------

constexpr int kGr = 64;          // rows per block, bf16 product
constexpr int kGc = 128;         // dxn columns per block
constexpr int kGk = 64;          // k-chunk (over dout), bf16 product
constexpr int kLdgk = kGk + 8;
constexpr int kLdgc = kGc + 4;

// dxn[T, d] (f32) = g[T, dout] @ w[d, dout]^T, bf16 in, f32 accumulate.
__global__ void __launch_bounds__(kThreads)
gemm_nt_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                    const __nv_bfloat16* __restrict__ w,
                    float* __restrict__ dxn, int T, int d, int dout) {
  // g chunk [64][kLdgk] and W chunk [n][k], then (after the product) the
  // f32 tile over the same bytes.
  __shared__ __align__(128) unsigned char buf[kGr * kLdgc * 4];
  static_assert((kGr + kGc) * kLdgk * 2 <= kGr * kLdgc * 4, "chunks fit");
  __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(buf);
  __nv_bfloat16* Ws = Gs + kGr * kLdgk;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.x * kGr, n0 = blockIdx.y * kGc;
  const int rows = min(kGr, T - row0);
  const int rb = warp & 3, ch = warp >> 2;  // 16 rows x 64 columns a warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < dout; k0 += kGk) {
    for (int i = tid; i < kGr * (kGk / 8); i += kThreads) {
      const int r = i / (kGk / 8), v = (i % (kGk / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        val = *reinterpret_cast<const uint4*>(
            g + (size_t)(row0 + r) * dout + k0 + v);
      *reinterpret_cast<uint4*>(Gs + r * kLdgk + v) = val;
    }
    for (int i = tid; i < kGc * (kGk / 8); i += kThreads) {
      const int n = i / (kGk / 8), v = (i % (kGk / 8)) * 8;
      *reinterpret_cast<uint4*>(Ws + n * kLdgk + v) =
          *reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * dout + k0 + v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Gs + rb * 16 * kLdgk + kk, kLdgk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fb, Ws + (ch * 64 + j * 16) * kLdgk + kk,
                               kLdgk);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  // Through shared memory, so that a ragged last tile writes its rows only.
  float* Cs = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Cs + rb * 16 * kLdgc + ch * 64 + j * 16, acc[j],
                            kLdgc, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < rows * (kGc / 4); i += kThreads) {
    const int r = i / (kGc / 4), c = (i % (kGc / 4)) * 4;
    *reinterpret_cast<float4*>(dxn + (size_t)(row0 + r) * d + n0 + c) =
        *reinterpret_cast<const float4*>(Cs + r * kLdgc + c);
  }
}

// The same in f32 on the CUDA cores: 32 rows x 128 columns a block, chunks
// of 32, a 4 x 4 piece a thread, multiply-adds in order of k.
__global__ void __launch_bounds__(kThreads)
gemm_nt_f32_kernel(const float* __restrict__ g, const float* __restrict__ w,
                   float* __restrict__ dxn, int T, int d, int dout) {
  constexpr int kR = 32, kK = 32, kLdg = kK + 1, kLdw = kGc + 4;
  __shared__ float Gs[kR * kLdg];
  __shared__ __align__(16) float Wt[kK * kLdw];  // [k][n]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kR, n0 = blockIdx.y * kGc;
  const int rows = min(kR, T - row0);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < dout; k0 += kK) {
    for (int i = tid; i < kR * kK; i += kThreads) {
      const int r = i / kK, kk = i % kK;
      Gs[r * kLdg + kk] =
          r < rows ? g[(size_t)(row0 + r) * dout + k0 + kk] : 0.f;
    }
    for (int i = tid; i < kGc * kK; i += kThreads) {
      const int n = i / kK, kk = i % kK;
      Wt[kk * kLdw + n] = w[(size_t)(n0 + n) * dout + k0 + kk];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(Wt + kk * kLdw + lane * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = Gs[(warp * 4 + i) * kLdg + kk];
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
    const int r = warp * 4 + i;
    if (r < rows)
      gn::store4(dxn + (size_t)(row0 + r) * d + n0 + lane * 4,
                 make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The LN pullback of kRows rows from dxn in device memory: statistics, dx,
// and the block's column sums of dxn * z and dxn (rows in order).
template <typename TX>
__global__ void __launch_bounds__(kThreads)
ln_pullback_kernel(const TX* __restrict__ x, const float* __restrict__ dxn,
                   const float* __restrict__ scale, TX* __restrict__ dx,
                   float* __restrict__ stats, float* __restrict__ part_ds,
                   float* __restrict__ part_db, int T, int d) {
  __shared__ float st[kRows * 2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, T - row0);
  for (int r = warp; r < rows; r += kThreads / 32) {
    const TX* xr = x + (size_t)(row0 + r) * d;
    const float* dr = dxn + (size_t)(row0 + r) * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += as_f32(xr[c]);
    const float mean = gn::warp_sum(s) / d;
    float q = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = as_f32(xr[c]) - mean;
      q += v * v;
    }
    const float var = gn::warp_sum(q) / d;
    const float sd = var > 0.f ? sqrtf(var) : 0.f;
    const float sv = sd + gn::kLnEps, sigma = var > 0.f ? sd : 1.f;
    if (lane == 0) {
      st[r * 2] = mean;
      st[r * 2 + 1] = sv;
      stats[(size_t)(row0 + r) * 2] = mean;
      stats[(size_t)(row0 + r) * 2 + 1] = sv;
    }
    float sdz = 0.f, sdzz = 0.f, sz = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float z = (as_f32(xr[c]) - mean) / sv;
      const float dz = dr[c] * scale[c];
      sdz += dz;
      sdzz += dz * z;
      sz += z;
    }
    const float mean_dz = gn::warp_sum(sdz) / d;
    const float mean_dzz = gn::warp_sum(sdzz) / d;
    const float mean_z = gn::warp_sum(sz) / d;
    TX* out = dx + (size_t)(row0 + r) * d;
    for (int c = lane; c < d; c += 32) {
      const float z = (as_f32(xr[c]) - mean) / sv;
      const float dz = dr[c] * scale[c];
      put(out + c, (dz - mean_dz) / sv - (z - mean_z) * (mean_dzz / sigma));
    }
  }
  __syncthreads();
  for (int c = tid; c < d; c += kThreads) {
    float sds = 0.f, sdb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float z =
          (as_f32(x[(size_t)(row0 + r) * d + c]) - st[r * 2]) / st[r * 2 + 1];
      const float dv = dxn[(size_t)(row0 + r) * d + c];
      sds += dv * z;
      sdb += dv;
    }
    part_ds[(size_t)blockIdx.x * d + c] = sds;
    part_db[(size_t)blockIdx.x * d + c] = sdb;
  }
}

// Pass 1 in two steps: the product into `dxn`, then the pullback.
int launch_rows_wide(const void* x, const void* g, const void* w,
                     const void* scale, void* dx, void* stats, void* part_ds,
                     void* part_db, void* dxn, int T, int d, int dout,
                     bool is_f32, cudaStream_t stream) {
  const int blocks = (T + kRows - 1) / kRows;
  if (is_f32) {
    const dim3 grid((T + 31) / 32, d / kGc);
    gemm_nt_f32_kernel<<<grid, kThreads, 0, stream>>>(
        (const float*)g, (const float*)w, (float*)dxn, T, d, dout);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ln_pullback_kernel<float><<<blocks, kThreads, 0, stream>>>(
        (const float*)x, (const float*)dxn, (const float*)scale, (float*)dx,
        (float*)stats, (float*)part_ds, (float*)part_db, T, d);
    return cudaGetLastError();
  }
  const dim3 grid((T + kGr - 1) / kGr, d / kGc);
  gemm_nt_bf16_kernel<<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)g, (const __nv_bfloat16*)w, (float*)dxn, T, d,
      dout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_pullback_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, (const float*)dxn, (const float*)scale,
      (__nv_bfloat16*)dx, (float*)stats, (float*)part_ds, (float*)part_db, T,
      d);
  return cudaGetLastError();
}

int reduce(const void* part, int parts, int n, void* out,
           cudaStream_t stream) {
  reduce_partials_kernel<<<(n + 31) / 32, kThreads, 0, stream>>>(
      (const float*)part, parts, n, (float*)out);
  return cudaGetLastError();
}

}  // namespace

// Runs the three passes on `stream` and returns the first launch error.
// Scratch, allocated by the Python wrapper: stats [T, 2], part_dw
// [splits, d, dout], part_ds and part_db [ceil(T / 32), d], all f32, where
// splits = ceil(T / rows_per_split); with `wide` also dxn [T, d] f32 (else
// null).  Preconditions, checked there: bf16 x [T, d], g [T, dout],
// w [d, dout]; f32 scale, bias; contiguous; T >= 1; d % 128 == 0;
// dout % 128 == 0; rows_per_split % 32 == 0; `wide` unless d is one of
// 128, 256, 384, 512 and pass 1's block fits shared memory.
extern "C" int gn_ln_linear_backward(const void* x, const void* g,
                                     const void* w, const void* scale,
                                     const void* bias, void* dx, void* dw,
                                     void* ds, void* db, void* stats,
                                     void* part_dw, void* part_ds,
                                     void* part_db, void* dxn, int T, int d,
                                     int dout, int rows_per_split, int wide,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (wide) err = launch_rows_wide(x, g, w, scale, dx, stats, part_ds, part_db, dxn, T, d, dout, false, s);
  else switch (d) {
    case 128: err = launch_rows<128>(x, g, w, scale, dx, stats, part_ds, part_db, T, dout, s); break;
    case 256: err = launch_rows<256>(x, g, w, scale, dx, stats, part_ds, part_db, T, dout, s); break;
    case 384: err = launch_rows<384>(x, g, w, scale, dx, stats, part_ds, part_db, T, dout, s); break;
    case 512: err = launch_rows<512>(x, g, w, scale, dx, stats, part_ds, part_db, T, dout, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int splits = (T + rows_per_split - 1) / rows_per_split;
  const dim3 grid(d / kTile, dout / kTile, splits);
  ln_bwd_dw_kernel<<<grid, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (const float*)stats,
      (const float*)scale, (const float*)bias, (float*)part_dw, T, d, dout,
      rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int blocks = (T + kRows - 1) / kRows;
  if ((err = reduce(part_dw, splits, d * dout, dw, s)) != cudaSuccess)
    return err;
  if ((err = reduce(part_ds, blocks, d, ds, s)) != cudaSuccess) return err;
  return reduce(part_db, blocks, d, db, s);
}

// The same for f32 rows: x, g, w and dx are f32, the products run in f32 on
// the CUDA cores, and pass 1 always takes its two steps (`wide` must be
// set, dxn given).  Scratch and preconditions otherwise as above.
extern "C" int gn_ln_linear_backward_f32(const void* x, const void* g,
                                         const void* w, const void* scale,
                                         const void* bias, void* dx, void* dw,
                                         void* ds, void* db, void* stats,
                                         void* part_dw, void* part_ds,
                                         void* part_db, void* dxn, int T,
                                         int d, int dout, int rows_per_split,
                                         int wide, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!wide) return cudaErrorInvalidValue;
  int err = launch_rows_wide(x, g, w, scale, dx, stats, part_ds, part_db, dxn,
                             T, d, dout, true, s);
  if (err != cudaSuccess) return err;
  const int splits = (T + rows_per_split - 1) / rows_per_split;
  const dim3 grid(d / kTileF, dout / kTileF, splits);
  ln_bwd_dw_f32_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)x, (const float*)g, (const float*)stats,
      (const float*)scale, (const float*)bias, (float*)part_dw, T, d, dout,
      rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int blocks = (T + kRows - 1) / kRows;
  if ((err = reduce(part_dw, splits, d * dout, dw, s)) != cudaSuccess)
    return err;
  if ((err = reduce(part_ds, blocks, d, ds, s)) != cudaSuccess) return err;
  return reduce(part_db, blocks, d, db, s);
}
