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
// What bounds it on the H100: memory.  At the large graph's shape
// (T = 1,048,576, d = dout = 256) it must read x and g (1.07 GB) and write
// dx (0.54 GB): ~0.48 ms at 3.35 TB/s, against 0.27 TFLOP (~0.28 ms of
// bf16 tensor-core work at 989 TFLOP/s); at the main path's (T = 16384,
// d = dout = 384) ~38.6 MB, ~11.5 us, against 9.7 GFLOP.
//
// bf16 rows of d = 128, 256, 384 or 512 (every driven shape): two passes
// of wgmma fed by TMA, and no separate reduction.
//
// 1. Row pass.  Persistent blocks (one an SM) of two warpgroups walk
//    64-row tiles; one thread issues the TMA loads (a producer warp would
//    cap a thread's registers at 168, too few at d = 384 and 512): each x
//    tile (two in flight up to d = 384) and a ring of g chunks [64 x 64]
//    and W chunks [d x 64], a stage refilled as soon as both warpgroups
//    hand it back (W is [d, dout] row-major, already the K-major B
//    operand of dxn = g @ W^T: no transpose).  Per tile the warps take the
//    row statistics from the x tile (one warp a row) and write the bf16 xn
//    rows to device memory for pass 2; the two warpgroups then
//    split dxn's d columns (wgmma m64n64k16 from shared memory; the f32
//    [64 x d / 2] accumulator stays in registers), and the LN pullback runs
//    on the accumulator in registers: the row sums of dz, dz * z and z are
//    added across the lanes of a row and then across the two warpgroups
//    through shared memory, dx is staged in shared memory and written in
//    whole rows (over the x tile, whose buffer then takes a later tile),
//    and each lane adds the column sums of dxn * z and dxn of its columns
//    across the block's tiles in registers.
// 2. dW pass.  dW = xn^T @ g takes the rows as K: [64 x 64] TMA boxes of
//    xn and g land MN-major and wgmma's transpose bits read them (the FFN
//    backward's weight pass); one 128 x 128 tile of dW and one range of
//    rows a block, the ranges of a tile on neighbouring blocks so that
//    their rows are read from device memory about once.  Each block writes
//    its f32 partial tile; the last block of a tile to finish (a counter a
//    tile, zeroed by pass 1) adds the partials in range order, and the last
//    blocks of the first column of tiles add the row pass's dscale and
//    dbias partials of their 128 columns in block order.  No atomics in
//    any sum: a second launch on the same inputs is bit-equal.
//
// Traffic at the large graph's shape: pass 1 reads x and g and writes dx
// and xn (2.1 GB), pass 2 reads xn and g (1.07 GB): ~3.2 GB, ~0.96 ms at
// 3.35 TB/s.  Rejected: rebuilding xn from x in pass 2 (the same bytes, and
// the normalisation in front of every product) and passes over L2-sized row
// chunks (not built).  The PR 2 design (WMMA fed by a two-stage cp.async
// ring, a dW pass that re-read x and g, and three reduce launches) took
// 4.23 ms there on an H100 80GB HBM3 at 700 W.
//
// Any other width of the JAX package's gate takes pass 1 in two steps
// whose shared memory does not depend on the widths: a tiled product dxn =
// g @ W^T into an f32 [T, d] scratch in device memory, then a pullback pass
// (one warp a row) that reads x and dxn, writes dx and the statistics and
// adds the block's column sums; then a split-K WMMA dW pass that rebuilds
// xn from x, and three fixed-order reductions.
//
// f32 rows of d = 128, 256, 384 or 512, the JAX package's default
// precision (phase F(b) of chip_smoke.py takes them three times a step at
// T = 1,048,576, d = dout = 256; the sort task's f32 training twice a step
// at T = 512, d = dout = 384): every product on the CUDA cores in true f32
// multiply-adds, never TF32, on the register-blocked tile of f32_tile.cuh.
// What bounds them is 4 T d dout f32 operations at 67 TFLOP/s (4.10 ms at
// the large graph's shape, 4.5 us at the sort task's) against ~4 GB of
// rows (1.2 ms) and 3.7 MB.
// 1. Row pass: a block a tile of 64 rows (128 at d = 128) across all d
//    columns, 4 x 16 values a thread at d = 256, two blocks an SM: the
//    rows' statistics, dxn = g @ W^T in registers (the wrapper hands W^T
//    in), then through shared memory to the pullback, a warp a row: dx and
//    the f32 xn rows out, and the tile's column sums of dxn * z and dxn.
//    No dxn in device memory.  Where the rows are few (the sort task's 512
//    rows make 8 tiles), 16-row tiles in two steps instead: dxn in 16 x 128
//    tiles into an f32 scratch (96 blocks at the sort task's shape), then
//    the pullback of each 16-row tile.
// 2. dW pass: 128 x 128 tiles of dW = xn^T @ g, 8 x 8 a thread, two blocks
//    an SM, each tile split over ranges of whole row tiles that fill whole
//    waves; the first column of tiles also adds the row pass's column sums
//    of its ranges, and the last block of each tile adds the partials in
//    range order (dscale and dbias too).  No atomics in any sum.
// The design it replaced (dxn into a [T, d] scratch in 32 x 128 tiles, 4 x
// 4 a thread, a pullback pass that read x three times and dxn twice, a 64
// x 64 dW pass that normalised x again, three reduce launches) took 16.56
// ms at the large graph's shape and 0.0775 ms at the sort task's on an
// H100 80GB HBM3 at 700 W.  f32 rows of other widths keep it.

#include <mma.h>

#include "common.cuh"
#include "f32_tile.cuh"
#include "hopper.cuh"
#include "row_stats.cuh"

using namespace nvcuda;

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kRows = 32;       // rows per block of the row pass
constexpr int kTile = 128;      // dW tile (both dims) of the dW pass
constexpr int kTk = 32;         // rows per step of the dW pass
constexpr int kLdt = kTile + 8;

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

// ---- f32 rows of another width (outside 128 .. 512) ---------------------

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

// ---- bf16 rows, d = 128 .. 512: the tensor-core passes ----------------------

constexpr int kConsumers = 256;             // two consumer warpgroups
// The row pass has no producer warp (a ninth warp would cap a thread's
// registers at 168, which the accumulators and the pullback outgrow at
// d = 384 and 512): thread 0 issues its loads.  The dW pass has one.
constexpr int kRowThreads = kConsumers;
constexpr int kWThreads = kConsumers + 32;
constexpr int kRB = 64;                     // rows of a row-pass tile

__device__ __forceinline__ void consumer_sync() {
  named_sync<1, kConsumers>();
}

template <int D>
struct RowPass {
  static constexpr int NY = D / 2;                  // dxn columns a warpgroup
  static constexpr int NCH = NY / 64;               // its 64-column chunks
  // Up to d = 256 each lane keeps the column sums of all its columns in
  // registers and adds them across its warp's rows once, at the end.
  static constexpr bool kColRegs = NCH <= 2;
  static constexpr int kStages = D == 128 ? 4 : D == 256 ? 3 : 2;
  static constexpr int kXB = D == 512 ? 1 : 2;      // x tiles in flight
  static constexpr int kG = kRB * 128;              // g chunk [64 x 64]
  static constexpr int kStage = kG + D * 128;       // and W chunk [D x 64]
  static constexpr int kXT = kRB * D * 2;           // an x tile, then dx
  static constexpr size_t kX = (size_t)kStages * kStage;
  static constexpr size_t kSt = kX + (size_t)kXB * kXT;    // [64][3] stats
  static constexpr size_t kXch = kSt + kRB * 3 * 4;  // [2][64][3] row sums
  static constexpr size_t kBars = kXch + 2 * kRB * 3 * 4;
  // full, empty [kStages]; xfull [kXB].
  static constexpr size_t kBytes = kBars + (2 * kStages + kXB) * 8 + 1024;
  static_assert((size_t)4 * D * 2 * 4 <= (size_t)kXT, "red fits");
  static_assert(kBytes <= 232448, "fits an SM's shared memory");
};

// Byte offset of the bf16 pair at (row r, even column c) of an x tile as
// TMA writes it: [64 x 64] boxes of 128-byte rows, 128-byte swizzle.
__device__ __forceinline__ int xoff(int r, int c) {
  return (c >> 6) * 8192 + swz128(r, (c >> 3) & 7) + (c & 7) * 2;
}

// Row pass: persistent blocks walk 64-row tiles.  Per tile: the row
// statistics and xn (written to device memory for the dW pass), dxn =
// g @ W^T on the tensor cores, then in registers dx and the column sums of
// dxn * z and dxn, which each lane keeps across tiles for its columns.
template <int D>
__global__ void __launch_bounds__(kRowThreads, 1)
ln_bwd_rows_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ dx,
                      __nv_bfloat16* __restrict__ xn,
                      float* __restrict__ part_rows,
                      int* __restrict__ counters, int n_counters, int T,
                      int dout) {
  using L = RowPass<D>;
  constexpr int S = L::kStages, XB = L::kXB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  float* st = reinterpret_cast<float*>(smem + L::kSt);
  float* xch = reinterpret_cast<float*>(smem + L::kXch);
  const uint32_t full = base + (uint32_t)L::kBars;
  const uint32_t empty = full + S * 8;
  const uint32_t xfull = empty + S * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (T + kRB - 1) / kRB, nk = dout / 64;

  if (blockIdx.x == 0)  // the dW pass's tile counters, for this launch
    for (int i = tid; i < n_counters; i += kRowThreads) counters[i] = 0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    for (int b = 0; b < XB; ++b) mbar_init(xfull + 8 * b, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // The loads, issued by thread 0.  The x tile of the block's tile lt
  // ([64 x 64] boxes) into x buffer lt % XB, once the tile before it in
  // that buffer is done; ring item it = lt * nk + kc: the g chunk
  // [64 rows x 64] and the W chunk [D x 64] of k-chunk kc (W is [D, dout]
  // row-major: already K-major for dxn = g @ W^T), once both warpgroups
  // have handed back the stage's previous item.
  auto issue_x = [&](int lt) {
    const int tile = blockIdx.x + lt * gridDim.x, b = lt % XB;
    if (tile >= tiles) return;
    mbar_expect_tx(xfull + 8 * b, L::kXT);
#pragma unroll
    for (int a = 0; a < D / 64; ++a)
      tma_load(base + (uint32_t)L::kX + b * L::kXT + a * 8192, &xmap,
               xfull + 8 * b, 64 * a, tile * kRB);
  };
  auto issue = [&](int it) {
    const int tile = blockIdx.x + (it / nk) * gridDim.x, kc = it % nk;
    if (tile >= tiles) return;
    const int s = it % S;
    mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
    const uint32_t fb = full + 8 * s, dst = base + s * L::kStage;
    mbar_expect_tx(fb, L::kStage);
    tma_load(dst, &gmap, fb, 64 * kc, tile * kRB);
#pragma unroll
    for (int a = 0; a < D / 64; ++a)
      tma_load(dst + L::kG + a * 8192, &wmap, fb, 64 * kc, 64 * a);
  };
  if (tid == 0) {
    for (int lt = 0; lt < XB; ++lt) issue_x(lt);
    for (int it = 0; it < S; ++it) issue(it);
  }
  __syncwarp();

  const int wg = tid >> 7, cw = wg * L::NY;
  const int lr = 16 * (warp & 3) + (lane >> 2);  // rows lr and lr + 8
  // dscale, dbias sums of this lane's columns: of column group lane / 4
  // (summed over the warp's rows), or of every group (its own rows).
  float colacc[L::NCH][4];
  float colr[L::kColRegs ? L::NCH : 1][L::kColRegs ? 8 : 1][4];
#pragma unroll
  for (int c = 0; c < L::NCH; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) colacc[c][k] = 0.f;
  if constexpr (L::kColRegs)
#pragma unroll
    for (int c = 0; c < L::NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) colr[c][j][k] = 0.f;
  int it = 0, xt = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++xt) {
    const int row0 = tile * kRB;
    unsigned char* xs = smem + L::kX + (xt % XB) * L::kXT;
    mbar_wait(xfull + 8 * (xt % XB), (xt / XB) & 1);
    // 1. Statistics and xn from the x tile (rows past T are zeros): four
    //    lanes a row, all 64 rows at once, each lane with 16-byte chunks
    //    q, q + 4, ... of its row (lane = 4 * row-in-warp + q).
    {
      constexpr int CPL = D / 32;  // chunks a lane
      const int r = 8 * warp + (lane >> 2), q = lane & 3, row = row0 + r;
      // The lane's chunk k, read again from shared memory by each of the
      // three sweeps (holding them would spill at d = 512).
      auto chunk = [&](int k) {
        const int v = q + 4 * k;
        return *reinterpret_cast<const uint4*>(xs + (v / 8) * 8192 +
                                               swz128(r, v % 8));
      };
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const uint4 raw4 = chunk(k);
        const __nv_bfloat162* p =
            reinterpret_cast<const __nv_bfloat162*>(&raw4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(p[t]);
          s0 += f.x;
          s1 += f.y;
        }
      }
      float sum = s0 + s1;
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float mean = sum / D;
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const uint4 raw4 = chunk(k);
        const __nv_bfloat162* p =
            reinterpret_cast<const __nv_bfloat162*>(&raw4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(p[t]);
          q0 += (f.x - mean) * (f.x - mean);
          q1 += (f.y - mean) * (f.y - mean);
        }
      }
      float qs = q0 + q1;
      qs += __shfl_xor_sync(0xffffffffu, qs, 1);
      qs += __shfl_xor_sync(0xffffffffu, qs, 2);
      const float var = qs / D;
      const float sd = var > 0.f ? sqrtf(var) : 0.f;
      const float sv = sd + gn::kLnEps;
      if (q == 0) {
        st[r * 3] = mean;
        st[r * 3 + 1] = sv;
        st[r * 3 + 2] = var > 0.f ? sd : 1.f;
      }
      if (row < T) {
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int v = q + 4 * k;
          const uint4 raw4 = chunk(k);
          const __nv_bfloat162* p =
              reinterpret_cast<const __nv_bfloat162*>(&raw4);
          const float4* s4 = reinterpret_cast<const float4*>(scale + v * 8);
          const float4* b4 = reinterpret_cast<const float4*>(bias + v * 8);
          const float4 sa = s4[0], sb = s4[1], ba = b4[0], bb = b4[1];
          const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
          const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
          uint4 packed;
          uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float2 f = __bfloat1622float2(p[t]);
            pk[t] = pack_bf16(
                __fadd_rn(__fmul_rn((f.x - mean) / sv, sc[2 * t]), bi[2 * t]),
                __fadd_rn(__fmul_rn((f.y - mean) / sv, sc[2 * t + 1]),
                          bi[2 * t + 1]));
          }
          *reinterpret_cast<uint4*>(xn + (size_t)row * D + v * 8) = packed;
        }
      }
    }
    consumer_sync();

    // 2. dxn = g @ W^T: this warpgroup's NY columns of the tile's 64 rows.
    float acc[L::NCH][32];
#pragma unroll
    for (int c = 0; c < L::NCH; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
      fence_regs(acc[c]);
    }
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % S;
      mbar_wait(full + 8 * s, (it / S) & 1);
      const uint32_t gs = base + s * L::kStage, ws = gs + L::kG;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          wgmma_m64n64k16<0, 0>(
              acc[c], make_desc(gs + kk * 32, 16),
              make_desc(ws + (cw + 64 * c) * 128 + kk * 32, 16));
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done
      if (kc > 0 && (tid & 127) == 0)
        mbar_arrive(empty + 8 * ((it - 1) % S));
      if (kc > 0 && tid == 0) issue(it - 1 + S);
      __syncwarp();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < L::NCH; ++c) fence_regs(acc[c]);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
    if (tid == 0) issue(it - 1 + S);
    __syncwarp();

    // 3. The LN pullback in registers.  Register i of chunk c holds row
    //    lr + 8 * ((i / 2) % 2), column cw + 64 c + 8 (i / 4) + 2 (lane % 4)
    //    + i % 2.
    //    z and the division by s take one reciprocal a row (within an ulp
    //    of the plain version's divisions; the tolerances hold dx to 2^-6
    //    and the sums to 1e-3).
    float mean[2], rs[2], sigma[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = st[(lr + 8 * h) * 3];
      rs[h] = 1.f / st[(lr + 8 * h) * 3 + 1];
      sigma[h] = st[(lr + 8 * h) * 3 + 2];
    }
    float sdz[2] = {0.f, 0.f}, sdzz[2] = {0.f, 0.f}, sz[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < L::NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cw + 64 * c + 8 * j + 2 * (lane & 3);
        const float2 sc = *reinterpret_cast<const float2*>(scale + col);
        float cs[4] = {0.f, 0.f, 0.f, 0.f};  // dxn * z and dxn, 2 columns
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  xs + xoff(lr + 8 * h, col)));
          const float z0 = (xv.x - mean[h]) * rs[h];
          const float z1 = (xv.y - mean[h]) * rs[h];
          const float d0 = acc[c][i], d1 = acc[c][i + 1];
          const float dz0 = d0 * sc.x, dz1 = d1 * sc.y;
          sdz[h] += dz0 + dz1;
          sdzz[h] += dz0 * z0 + dz1 * z1;
          sz[h] += z0 + z1;
          cs[0] += d0 * z0;
          cs[1] += d1 * z1;
          cs[2] += d0;
          cs[3] += d1;
        }
        if constexpr (L::kColRegs) {
#pragma unroll
          for (int k = 0; k < 4; ++k) colr[c][j][k] += cs[k];
        } else {
          // Over the warp's 16 rows (lanes of one lane % 4 share columns);
          // lane group j keeps column group j.
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], o);
          if ((lane >> 2) == j)
#pragma unroll
            for (int k = 0; k < 4; ++k) colacc[c][k] += cs[k];
        }
      }
    // Row sums: the quad's lanes, then the two warpgroups in order.
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sdz[h] += __shfl_xor_sync(0xffffffffu, sdz[h], o);
        sdzz[h] += __shfl_xor_sync(0xffffffffu, sdzz[h], o);
        sz[h] += __shfl_xor_sync(0xffffffffu, sz[h], o);
      }
    if ((lane & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* e = xch + (wg * kRB + lr + 8 * h) * 3;
        e[0] = sdz[h];
        e[1] = sdzz[h];
        e[2] = sz[h];
      }
    consumer_sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* e0 = xch + (lr + 8 * h) * 3;
      const float* e1 = xch + (kRB + lr + 8 * h) * 3;
      const float mean_dz = (e0[0] + e1[0]) / D;
      const float mean_z = (e0[2] + e1[2]) / D;
      const float kz = ((e0[1] + e1[1]) / D) / sigma[h];  // mean(dz z) / sg
#pragma unroll
      for (int c = 0; c < L::NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cw + 64 * c + 8 * j + 2 * (lane & 3);
          const int i = 4 * j + 2 * h;
          const float2 sc = *reinterpret_cast<const float2*>(scale + col);
          __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(
              xs + xoff(lr + 8 * h, col));
          const float2 xv = __bfloat1622float2(*px);
          const float z0 = (xv.x - mean[h]) * rs[h];
          const float z1 = (xv.y - mean[h]) * rs[h];
          const float dz0 = acc[c][i] * sc.x, dz1 = acc[c][i + 1] * sc.y;
          *px = __floats2bfloat162_rn(
              (dz0 - mean_dz) * rs[h] - (z0 - mean_z) * kz,
              (dz1 - mean_dz) * rs[h] - (z1 - mean_z) * kz);
        }
    }
    consumer_sync();
    // 4. dx out in whole rows; then the buffer takes a later x tile.
    for (int i = tid; i < kRB * (D / 8); i += kConsumers) {
      const int r = i / (D / 8), v = i % (D / 8);
      if (row0 + r < T)
        *reinterpret_cast<uint4*>(dx + (size_t)(row0 + r) * D + v * 8) =
            *reinterpret_cast<const uint4*>(xs + (v / 8) * 8192 +
                                            swz128(r, v % 8));
    }
    fence_proxy_async();  // the dx stores, before TMA rewrites the tile
    consumer_sync();      // xs, st and xch are rewritten by the next tile
    if (tid == 0) issue_x(xt + XB);
  }

  // The block's column sums: each warp's lanes hold theirs (up to d = 256
  // first added over the warp's rows, as the wider rows did per tile); the
  // four warps of a warpgroup (other rows, the same columns) are added in
  // order.
  if constexpr (L::kColRegs)
#pragma unroll
    for (int c = 0; c < L::NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            colr[c][j][k] += __shfl_xor_sync(0xffffffffu, colr[c][j][k], o);
        if ((lane >> 2) == j)
#pragma unroll
          for (int k = 0; k < 4; ++k) colacc[c][k] = colr[c][j][k];
      }
  // No x tile is in flight: the last one was issued for this block's last
  // tile.
  float* red = reinterpret_cast<float*>(smem + L::kX);  // [4][D][2]
#pragma unroll
  for (int c = 0; c < L::NCH; ++c)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = cw + 64 * c + 8 * (lane >> 2) + 2 * (lane & 3) + p;
      red[((warp & 3) * D + col) * 2] = colacc[c][p];
      red[((warp & 3) * D + col) * 2 + 1] = colacc[c][2 + p];
    }
  consumer_sync();
  for (int col = tid; col < D; col += kConsumers) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s0 += red[(w * D + col) * 2];
      s1 += red[(w * D + col) * 2 + 1];
    }
    part_rows[(size_t)(2 * blockIdx.x) * D + col] = s0;
    part_rows[(size_t)(2 * blockIdx.x + 1) * D + col] = s1;
  }
}

// dW pass: dW = xn^T @ g over row ranges (the rows are K, read MN-major
// from [64 x 64] boxes), one 128 x 128 tile of dW and one range a block.
// With `reduce`, the last block of a tile to finish (a counter a tile) adds
// the ranges' partials in range order, and the last blocks of the tiles of
// the first column also add the row pass's dscale and dbias partials of
// their 128 columns in block order: no atomics in any sum.
constexpr int kWB = 128;                  // tile rows and columns
constexpr int kWK = 64;                   // rows (k) of a stage
constexpr int kWStages = 4;
constexpr int kWHalf = kWK * 64 * 2;      // one [64 x 64] box, 8 KB
constexpr int kWStage = 4 * kWHalf;       // two boxes of xn, two of g
constexpr size_t kWBytes = (size_t)kWStages * kWStage + 2 * kWStages * 8 +
                           16 + 1024;

struct DwArgs {
  int T, d, dout, k_split, tiles_n, tiles, splits, row_blocks, reduce;
  float* part_dw;          // [splits, d, dout]
  float* dw;               // [d, dout]
  const float* part_rows;  // [row_blocks, 2, d]
  float* ds;
  float* db;
  int* counters;           // one a tile, zeroed by the row pass
};

__global__ void __launch_bounds__(kWThreads, 1)
ln_bwd_dw_tc_kernel(const __grid_constant__ CUtensorMap xnmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const DwArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + kWStages * kWStage;
  const uint32_t empty = full + kWStages * 8;
  int* last = reinterpret_cast<int*>(smem + kWStages * kWStage +
                                     2 * kWStages * 8);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x % p.tiles, split = blockIdx.x / p.tiles;
  const int m0 = (tile / p.tiles_n) * kWB, n0 = (tile % p.tiles_n) * kWB;
  const int k_begin = split * p.k_split;
  const int nk = max(0, min(p.k_split, p.T - k_begin) + kWK - 1) / kWK;

  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid != kConsumers) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kWStages;
      mbar_wait(empty + 8 * s, ((kt / kWStages) & 1) ^ 1);
      const uint32_t fb = full + 8 * s, sa = base + s * kWStage;
      mbar_expect_tx(fb, kWStage);
      const int k0 = k_begin + kt * kWK;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        tma_load(sa + b * kWHalf, &xnmap, fb, m0 + 64 * b, k0);
        tma_load(sa + (2 + b) * kWHalf, &gmap, fb, n0 + 64 * b, k0);
      }
    }
    return;
  }

  // Warpgroup wg takes rows [64 wg, 64 wg + 64) of the tile (dW rows are
  // xn's columns).  Rows of x past T arrive as zeros.
  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kWStages;
    mbar_wait(full + 8 * s, (kt / kWStages) & 1);
    const uint32_t sa = base + s * kWStage, sb = sa + 2 * kWHalf;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kWK / 16; ++j)
      wgmma_m64n128k16<1, 1>(acc,
                             make_desc(sa + wg * kWHalf + j * 2048, kWHalf),
                             make_desc(sb + j * 2048, kWHalf));
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && (tid & 127) == 0)
      mbar_arrive(empty + 8 * ((kt - 1) % kWStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const size_t sz = (size_t)p.d * p.dout;
  float* mine = p.part_dw + (size_t)split * sz;
  const int r_lo = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int c_lo = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(mine + (size_t)(r_lo + 8 * h) * p.dout +
                                 c_lo + 8 * j) =
          make_float2(acc[i], acc[i + 1]);
    }
  if (!p.reduce) return;
  __threadfence();
  consumer_sync();
  if (tid == 0) *last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  consumer_sync();
  if (!*last) return;
  __threadfence();
  for (int i = tid; i < kWB * kWB / 4; i += kConsumers) {
    const int r = i / (kWB / 4), c = (i % (kWB / 4)) * 4;
    const size_t g = (size_t)(m0 + r) * p.dout + n0 + c;
    float4 a = __ldcg(reinterpret_cast<const float4*>(p.part_dw + g));
#pragma unroll 4
    for (int k = 1; k < p.splits; ++k) {
      const float4 q =
          __ldcg(reinterpret_cast<const float4*>(p.part_dw + k * sz + g));
      a.x += q.x; a.y += q.y; a.z += q.z; a.w += q.w;
    }
    *reinterpret_cast<float4*>(p.dw + g) = a;
  }
  if (n0 == 0 && tid < kWB) {
    const int col = m0 + tid;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
    for (int b = 0; b < p.row_blocks; ++b) {
      s0 += p.part_rows[(size_t)(2 * b) * p.d + col];
      s1 += p.part_rows[(size_t)(2 * b + 1) * p.d + col];
    }
    p.ds[col] = s0;
    p.db[col] = s1;
  }
}

template <int D>
int launch_rows_tc(const CUtensorMap& xm, const CUtensorMap& gm,
                   const CUtensorMap& wm, const void* scale, const void* bias,
                   void* dx, void* xn, void* part_rows, void* counters,
                   int n_counters, int T, int dout, int row_blocks,
                   cudaStream_t s) {
  const size_t smem = RowPass<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_rows_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ln_bwd_rows_tc_kernel<D><<<row_blocks, kRowThreads, smem, s>>>(
      xm, gm, wm, (const float*)scale,
      (const float*)bias, (__nv_bfloat16*)dx, (__nv_bfloat16*)xn,
      (float*)part_rows, (int*)counters, n_counters, T, dout);
  return cudaGetLastError();
}


// ---- f32 rows, d = 128 .. 512: register-blocked tiles on the CUDA cores ----

using gn::f32t::Tile;
constexpr int kFThreads = gn::f32t::kThreads;
constexpr int kFSmall = 16;  // rows of a tile where the rows are few

// The LN pullback of a tile of rows whose dxn is in `dxr` (row r at
// dxr + r * ldd, shared or device memory), a warp a row: the row sums of
// dz, dz * z and z across the warp, dx and the f32 xn rows out, and each
// lane's column sums of dxn * z and dxn over its warp's rows, added over
// the 8 warps in order into part[0 .. 2 D) (dscale's, then dbias's).
// st: the rows' mean, s, sigma.  `red` [16][D] of shared memory may
// overlap a shared `dxr`: it is written after a barrier.
template <int D>
__device__ __forceinline__ void pullback_f32(
    const float* __restrict__ x, const float* dxr, int ldd, const float* st,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ dx, float* __restrict__ xn, float* __restrict__ part,
    int m0, int rows, float* red) {
  constexpr int kQ = D / 128;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float csz[kQ][4], csd[kQ][4];
#pragma unroll
  for (int q = 0; q < kQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) csz[q][j] = csd[q][j] = 0.f;
  for (int lr = warp; lr < rows; lr += kFThreads / 32) {
    const float mean = st[3 * lr], rs = 1.f / st[3 * lr + 1];
    const float sigma = st[3 * lr + 2];
    const size_t off = (size_t)(m0 + lr) * D + 4 * lane;
    float4 xv[kQ], dv[kQ];
    float sdz = 0.f, sdzz = 0.f, sz = 0.f;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      xv[q] = gn::load4(x + off + 128 * q);
      dv[q] = gn::load4(dxr + (size_t)lr * ldd + 4 * lane + 128 * q);
      const float4 sc = gn::load4(scale + 4 * lane + 128 * q);
      const float xs[4] = {xv[q].x, xv[q].y, xv[q].z, xv[q].w};
      const float ds[4] = {dv[q].x, dv[q].y, dv[q].z, dv[q].w};
      const float scs[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float z = (xs[j] - mean) * rs;
        const float dz = ds[j] * scs[j];
        sdz += dz;
        sdzz += dz * z;
        sz += z;
      }
    }
    const float mdz = gn::warp_sum(sdz) / D, mz = gn::warp_sum(sz) / D;
    const float k = (gn::warp_sum(sdzz) / D) / sigma;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c = 4 * lane + 128 * q;
      const float4 sc = gn::load4(scale + c), bi = gn::load4(bias + c);
      const float xs[4] = {xv[q].x, xv[q].y, xv[q].z, xv[q].w};
      const float ds[4] = {dv[q].x, dv[q].y, dv[q].z, dv[q].w};
      const float scs[4] = {sc.x, sc.y, sc.z, sc.w};
      const float bis[4] = {bi.x, bi.y, bi.z, bi.w};
      float o[4], n[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float z = (xs[j] - mean) * rs;
        const float dz = ds[j] * scs[j];
        o[j] = (dz - mdz) * rs - (z - mz) * k;
        n[j] = __fadd_rn(__fmul_rn(z, scs[j]), bis[j]);
        csz[q][j] += ds[j] * z;
        csd[q][j] += ds[j];
      }
      gn::store4(dx + off + 128 * q, make_float4(o[0], o[1], o[2], o[3]));
      gn::store4(xn + off + 128 * q, make_float4(n[0], n[1], n[2], n[3]));
    }
  }
  __syncthreads();  // a shared dxr is read: its space takes the sums
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int c = 4 * lane + 128 * q;
    gn::store4(red + (2 * warp) * D + c,
               make_float4(csz[q][0], csz[q][1], csz[q][2], csz[q][3]));
    gn::store4(red + (2 * warp + 1) * D + c,
               make_float4(csd[q][0], csd[q][1], csd[q][2], csd[q][3]));
  }
  __syncthreads();
  for (int i = tid; i < 2 * D; i += kFThreads) {
    const int which = i / D, c = i % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kFThreads / 32; ++w)
      sum += red[(2 * w + which) * D + c];
    part[i] = sum;
  }
}

// The row pass at width D where the rows are many: a block a tile of 16 RY
// rows across all D columns, RY rows and D / 16 columns a thread; two
// blocks an SM where the accumulators leave 128 registers enough (64 of
// them: d = 128, 8 x 8, and d = 256, 4 x 16).  Dynamic shared memory: the
// product's slabs, then the tile of dxn [rows][D + 4]; the rows'
// statistics [rows][3].
template <int RY, int D>
struct F32Rows {
  using Tl = Tile<RY, D / 16>;
  static constexpr int kBlocks = RY * D / 16 <= 64 ? 2 : 1;
  static constexpr int kLdd = D + 4;
  static constexpr int kMain =
      Tl::kFloats > Tl::kRows * kLdd ? Tl::kFloats : Tl::kRows * kLdd;
  static_assert(kMain >= 16 * D, "the warps' column sums fit");
  static constexpr size_t kBytes = (size_t)(kMain + 3 * Tl::kRows) * 4;
};

// Row pass, f32: the rows' statistics (mean, s, sigma) from x, dxn = g @
// W^T in registers (wt = W^T [dout, D], the row-major B), then through
// shared memory to the pullback (the accumulators are dead by then, so
// its registers do not add to theirs); part_rows[tile] = the tile's
// column sums.  Block 0 zeroes the dW pass's tile counters.
template <int RY, int D>
__global__ void __launch_bounds__(kFThreads, F32Rows<RY, D>::kBlocks)
ln_bwd_rows_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ wt,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, float* __restrict__ dx,
                       float* __restrict__ xn, float* __restrict__ part_rows,
                       int* __restrict__ counters, int n_counters, int T,
                       int dout) {
  using P = F32Rows<RY, D>;
  using Tl = typename P::Tl;
  constexpr int CW = D / 16;
  extern __shared__ __align__(16) float smf[];
  float* st = smf + P::kMain;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  if (blockIdx.x == 0)
    for (int i = tid; i < n_counters; i += kFThreads) counters[i] = 0;
  const int m0 = blockIdx.x * Tl::kRows;
  const int rows = min(Tl::kRows, T - m0);
  gn::tile_row_stats<Tl::kRows, kFThreads, true>(x, D, m0, rows, st);
  {
    float acc[RY][CW];
    Tl::zero(acc);
    Tl::template mma<false>(g, dout, wt, D, m0, 0, 0, dout, T, acc, smf,
                            gn::f32t::Plain{});
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int v = 0; v < CW / 4; ++v)
        gn::store4(smf + Tl::row(ty, r) * P::kLdd + 4 * tx + 64 * v,
                   make_float4(acc[r][4 * v], acc[r][4 * v + 1],
                               acc[r][4 * v + 2], acc[r][4 * v + 3]));
  }
  __syncthreads();
  pullback_f32<D>(x, smf, P::kLdd, st, scale, bias, dx, xn,
                  part_rows + (size_t)blockIdx.x * 2 * D, m0, rows, smf);
}

// Where the rows are few, the row pass in two steps that spread the work
// over more SMs: dxn = g @ W^T into an f32 [T, D] scratch in 16 x 128
// tiles (grid: 16-row tiles x D / 128 column blocks), then the pullback of
// each 16-row tile from it.
__global__ void __launch_bounds__(kFThreads, 2)
ln_bwd_dxn_f32_kernel(const float* __restrict__ g,
                      const float* __restrict__ wt, float* __restrict__ dxn,
                      int T, int D, int dout) {
  using Tl = Tile<1, 8>;
  __shared__ __align__(16) float sm[Tl::kFloats];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * Tl::kRows, n0 = blockIdx.y * Tl::kCols;
  float acc[1][8];
  Tl::zero(acc);
  Tl::mma<false>(g, dout, wt, D, m0, n0, 0, dout, T, acc, sm,
                 gn::f32t::Plain{});
  if (m0 + ty >= T) return;
#pragma unroll
  for (int v = 0; v < 2; ++v)
    gn::store4(dxn + (size_t)(m0 + ty) * D + n0 + 4 * tx + 64 * v,
               make_float4(acc[0][4 * v], acc[0][4 * v + 1],
                           acc[0][4 * v + 2], acc[0][4 * v + 3]));
}

template <int D>
__global__ void __launch_bounds__(kFThreads, 2)
ln_bwd_pullback_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ dxn,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           float* __restrict__ dx, float* __restrict__ xn,
                           float* __restrict__ part_rows,
                           int* __restrict__ counters, int n_counters,
                           int T) {
  __shared__ __align__(16) float red[16 * D];
  __shared__ float st[3 * kFSmall];
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < n_counters; i += kFThreads) counters[i] = 0;
  const int m0 = blockIdx.x * kFSmall;
  const int rows = min(kFSmall, T - m0);
  gn::tile_row_stats<kFSmall, kFThreads, true>(x, D, m0, rows, st);
  __syncthreads();
  pullback_f32<D>(x, dxn + (size_t)m0 * D, D, st, scale, bias, dx, xn,
                  part_rows + (size_t)blockIdx.x * 2 * D, m0, rows, red);
}

struct F32DwArgs {
  int T, d, dout, tiles_n, splits, unit, units, reduce;
  const float* xn;         // [T, d]
  const float* g;          // [T, dout]
  float* part_dw;          // [splits, d, dout]
  float* dw;               // [d, dout]
  const float* part_rows;  // [units, 2, d]: the row pass's column sums
  float* part_sd;          // [splits, 2, d]
  float* ds;
  float* db;
  int* counters;           // one a tile, zeroed by the row pass
};

// dW pass, f32: blockIdx.x a 128 x 128 tile of dW = xn^T @ g (8 x 8 a
// thread, two blocks an SM), blockIdx.y a range of rows: whole row-pass
// tiles (`unit` rows), range y = tiles [units * y / splits, units * (y +
// 1) / splits).  Each block writes its partial tile; the blocks of the
// first column of tiles also add the row pass's column sums of their
// range's tiles for their 128 columns.  The last of a tile's blocks to
// finish adds the partials in range order (and those sums, into dscale
// and dbias).  No atomics in any sum: a relaunch is bit-equal.
__global__ void __launch_bounds__(kFThreads, 2)
ln_bwd_weights_f32_kernel(const F32DwArgs p) {
  using Tl = Tile<8, 8>;
  __shared__ __align__(16) float sm[Tl::kFloats];
  __shared__ int last;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int m0 = (tile / p.tiles_n) * Tl::kRows;
  const int n0 = (tile % p.tiles_n) * Tl::kCols;
  const int u0 = (int)((long long)split * p.units / p.splits);
  const int u1 = (int)((long long)(split + 1) * p.units / p.splits);
  const int k0 = p.unit * u0, k1 = min(p.T, p.unit * u1);
  {
    float acc[8][8];
    Tl::zero(acc);
    Tl::mma<true>(p.xn, p.d, p.g, p.dout, m0, n0, k0, k1, p.d, acc, sm,
                  gn::f32t::Plain{});
    float* mine = p.part_dw + (size_t)split * p.d * p.dout;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        gn::store4(mine + (size_t)(m0 + Tl::row(ty, r)) * p.dout + n0 +
                       4 * tx + 64 * v,
                   make_float4(acc[r][4 * v], acc[r][4 * v + 1],
                               acc[r][4 * v + 2], acc[r][4 * v + 3]));
  }
  const int col = m0 + (tid & 127), which = tid >> 7;
  if (n0 == 0) {
    float sum = 0.f;
    for (int u = u0; u < u1; ++u)
      sum += p.part_rows[(size_t)(2 * u + which) * p.d + col];
    p.part_sd[(size_t)(2 * split + which) * p.d + col] = sum;
  }
  if (!p.reduce) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // 16 float4 of the tile a thread, in batches of 4 loads in flight.
  const size_t sz = (size_t)p.d * p.dout;
  const float* tile0 = p.part_dw + (size_t)m0 * p.dout + n0;
#pragma unroll 1
  for (int b = 0; b < 4; ++b) {
    int at[4];
    float4 a[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = tid + kFThreads * (4 * b + v);
      at[v] = (i / 32) * p.dout + (i % 32) * 4;
      a[v] = __ldcg(reinterpret_cast<const float4*>(tile0 + at[v]));
    }
    for (int k = 1; k < p.splits; ++k) {
      const float* part = tile0 + k * sz;
      float4 q[4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        q[v] = __ldcg(reinterpret_cast<const float4*>(part + at[v]));
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        a[v].x += q[v].x; a[v].y += q[v].y;
        a[v].z += q[v].z; a[v].w += q[v].w;
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v)
      gn::store4(p.dw + (size_t)m0 * p.dout + n0 + at[v], a[v]);
  }
  if (n0 == 0) {
    float sum = 0.f;
    for (int k = 0; k < p.splits; ++k)
      sum += __ldcg(p.part_sd + (size_t)(2 * k + which) * p.d + col);
    (which ? p.db : p.ds)[col] = sum;
  }
}

template <int RY, int D>
int launch_rows_f32(const void* x, const void* g, const void* wt,
                    const void* scale, const void* bias, void* dx, void* xn,
                    void* part_rows, void* counters, int n_counters, int T,
                    int dout, cudaStream_t s) {
  using P = F32Rows<RY, D>;
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_rows_f32_kernel<RY, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kBytes);
  if (err != cudaSuccess) return err;
  const int tiles = (T + P::Tl::kRows - 1) / P::Tl::kRows;
  ln_bwd_rows_f32_kernel<RY, D><<<tiles, kFThreads, P::kBytes, s>>>(
      (const float*)x, (const float*)g, (const float*)wt,
      (const float*)scale, (const float*)bias, (float*)dx, (float*)xn,
      (float*)part_rows, (int*)counters, n_counters, T, dout);
  return cudaGetLastError();
}

// The row pass at width D: 16-row tiles in two steps (small), else 128-row
// tiles at d = 128 and 64-row tiles above.
template <int D>
int launch_rows_f32_at(bool small, const void* x, const void* g,
                       const void* wt, const void* scale, const void* bias,
                       void* dx, void* xn, void* dxn, void* part_rows,
                       void* counters, int n_counters, int T, int dout,
                       cudaStream_t s) {
  if (!small)
    return launch_rows_f32<D == 128 ? 8 : 4, D>(x, g, wt, scale, bias, dx,
                                                xn, part_rows, counters,
                                                n_counters, T, dout, s);
  const int tiles = (T + kFSmall - 1) / kFSmall;
  ln_bwd_dxn_f32_kernel<<<dim3(tiles, D / 128), kFThreads, 0, s>>>(
      (const float*)g, (const float*)wt, (float*)dxn, T, D, dout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_pullback_f32_kernel<D><<<tiles, kFThreads, 0, s>>>(
      (const float*)x, (const float*)dxn, (const float*)scale,
      (const float*)bias, (float*)dx, (float*)xn, (float*)part_rows,
      (int*)counters, n_counters, T);
  return cudaGetLastError();
}

}  // namespace

// The bf16 rows of d = 128, 256, 384 or 512 on the tensor cores.  Runs on
// `stream` the passes selected by `passes` (1: row pass, 2: dW pass, 4:
// the fused reduction at the end of the dW pass; 7 for the gradients, the
// others only to time a pass) and returns the first launch error.
// Scratch, allocated by the Python wrapper: xn [T, d] bf16, part_rows
// [row_blocks, 2, d] and part_dw [splits, d, dout] f32, counters
// (d / 128) * (dout / 128) int.  Preconditions, checked there: bf16 x
// [T, d], g [T, dout], w [d, dout]; f32 scale, bias; contiguous and 16-byte
// aligned; T >= 1; dout % 128 == 0; 1 <= row_blocks <= ceil(T / 64);
// rows_per_split % 64 == 0, splits = ceil(T / rows_per_split).
extern "C" int gn_ln_linear_backward_tc(
    const void* x, const void* g, const void* w, const void* scale,
    const void* bias, void* dx, void* dw, void* ds, void* db, void* xn,
    void* part_rows, void* part_dw, void* counters, int T, int d, int dout,
    int row_blocks, int splits, int rows_per_split, int passes,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d % 128 || d > 512 || dout % 128 || T < 1 || rows_per_split % 64 ||
      row_blocks < 1)
    return cudaErrorInvalidValue;
  const int tiles = (d / kWB) * (dout / kWB);
  CUtensorMap xm, gm, wm, nm;
  int e;
  if ((e = make_map(&xm, x, T, d, 64)) != 0) return e;
  if ((e = make_map(&gm, g, T, dout, 64)) != 0) return e;
  if ((e = make_map(&wm, w, d, dout, 64)) != 0) return e;
  if ((e = make_map(&nm, xn, T, d, 64)) != 0) return e;
  if (passes & 1) {
    switch (d) {
      case 128: e = launch_rows_tc<128>(xm, gm, wm, scale, bias, dx, xn, part_rows, counters, tiles, T, dout, row_blocks, s); break;
      case 256: e = launch_rows_tc<256>(xm, gm, wm, scale, bias, dx, xn, part_rows, counters, tiles, T, dout, row_blocks, s); break;
      case 384: e = launch_rows_tc<384>(xm, gm, wm, scale, bias, dx, xn, part_rows, counters, tiles, T, dout, row_blocks, s); break;
      default: e = launch_rows_tc<512>(xm, gm, wm, scale, bias, dx, xn, part_rows, counters, tiles, T, dout, row_blocks, s); break;
    }
    if (e != 0) return e;
  }
  if (!(passes & 2)) return 0;
  DwArgs a;
  a.T = T;
  a.d = d;
  a.dout = dout;
  a.k_split = rows_per_split;
  a.tiles_n = dout / kWB;
  a.tiles = tiles;
  a.splits = splits;
  a.row_blocks = row_blocks;
  a.reduce = (passes & 4) != 0;
  a.part_dw = (float*)part_dw;
  a.dw = (float*)dw;
  a.part_rows = (const float*)part_rows;
  a.ds = (float*)ds;
  a.db = (float*)db;
  a.counters = (int*)counters;
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWBytes);
  if (err != cudaSuccess) return err;
  ln_bwd_dw_tc_kernel<<<tiles * splits, kWThreads, kWBytes, s>>>(nm, gm, a);
  return cudaGetLastError();
}

// The f32 rows of d = 128, 256, 384 or 512 on register-blocked CUDA-core
// tiles, true f32 multiply-adds, never TF32.  Runs on `stream` the passes
// selected by `passes` (1: row pass, 2: dW pass, 4: the dW pass's fused
// sums; 7 for the gradients, the others only to time a pass) and returns
// the first launch error.  Scratch, allocated by the Python wrapper as
// `f32_backward_plan` sizes it: xn [T, d], dxn [T, d] (16-row tiles only),
// part_rows [ceil(T / tile_rows), 2, d], part_dw [splits, d, dout] and
// part_sd [splits, 2, d] f32, counters (d / 128) * (dout / 128) int.
// Preconditions, checked there: f32 x [T, d], g [T, dout], wt = W^T
// [dout, d], scale, bias [d]; contiguous and 16-byte aligned; T >= 1;
// dout % 128 == 0; tile_rows 16, or 128 at d = 128 and 64 above;
// 1 <= splits <= ceil(T / tile_rows).
extern "C" int gn_ln_linear_backward_f32_tiles(
    const void* x, const void* g, const void* wt, const void* scale,
    const void* bias, void* dx, void* dw, void* ds, void* db, void* xn,
    void* dxn, void* part_rows, void* part_dw, void* part_sd,
    void* counters, int T, int d, int dout, int tile_rows, int splits,
    int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int big = d == 128 ? 128 : 64;
  const int units = (T + tile_rows - 1) / max(tile_rows, 1);
  if (d % 128 || d > 512 || dout % 128 || T < 1 ||
      (tile_rows != kFSmall && tile_rows != big) || splits < 1 ||
      splits > units)
    return cudaErrorInvalidValue;
  const int tiles = (d / 128) * (dout / 128);
  const bool small = tile_rows == kFSmall;
  int e = 0;
  if (passes & 1) {
    switch (d) {
      case 128: e = launch_rows_f32_at<128>(small, x, g, wt, scale, bias, dx, xn, dxn, part_rows, counters, tiles, T, dout, s); break;
      case 256: e = launch_rows_f32_at<256>(small, x, g, wt, scale, bias, dx, xn, dxn, part_rows, counters, tiles, T, dout, s); break;
      case 384: e = launch_rows_f32_at<384>(small, x, g, wt, scale, bias, dx, xn, dxn, part_rows, counters, tiles, T, dout, s); break;
      default: e = launch_rows_f32_at<512>(small, x, g, wt, scale, bias, dx, xn, dxn, part_rows, counters, tiles, T, dout, s); break;
    }
    if (e != 0) return e;
  }
  if (!(passes & 2)) return 0;
  F32DwArgs a;
  a.T = T;
  a.d = d;
  a.dout = dout;
  a.tiles_n = dout / 128;
  a.splits = splits;
  a.unit = tile_rows;
  a.units = units;
  a.reduce = (passes & 4) != 0;
  a.xn = (const float*)xn;
  a.g = (const float*)g;
  a.part_dw = (float*)part_dw;
  a.dw = (float*)dw;
  a.part_rows = (const float*)part_rows;
  a.part_sd = (float*)part_sd;
  a.ds = (float*)ds;
  a.db = (float*)db;
  a.counters = (int*)counters;
  ln_bwd_weights_f32_kernel<<<dim3(tiles, splits), kFThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// The other rows in bf16 (a width outside 128 .. 512): the row pass in
// two steps, the WMMA dW pass and three reductions, on `stream`; returns
// the first launch error.  Scratch, allocated by the Python wrapper: stats
// [T, 2], part_dw [splits, d, dout], part_ds and part_db [ceil(T / 32), d],
// dxn [T, d], all f32, where splits = ceil(T / rows_per_split).
// Preconditions, checked there: bf16 x [T, d], g [T, dout], w [d, dout];
// f32 scale, bias; contiguous; T >= 1; d % 128 == 0; dout % 128 == 0;
// rows_per_split % 32 == 0; `wide` set.
extern "C" int gn_ln_linear_backward(const void* x, const void* g,
                                     const void* w, const void* scale,
                                     const void* bias, void* dx, void* dw,
                                     void* ds, void* db, void* stats,
                                     void* part_dw, void* part_ds,
                                     void* part_db, void* dxn, int T, int d,
                                     int dout, int rows_per_split, int wide,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!wide) return cudaErrorInvalidValue;
  int err = launch_rows_wide(x, g, w, scale, dx, stats, part_ds, part_db,
                             dxn, T, d, dout, false, s);
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
