// Single-graph (G = 1) edge update in one pass, with the edge->node sum:
//
//   h[e]   = ef.dtype( ((f32(src[e]) + gb) + f32(tr[rl[e]]))
//                      + [LN](ef[e]) @ W0 )           one rounding
//   agg[n] = f32 sum of the rounded h[e] over the edges with rl[e] == n
//
// Replaces the Pallas kernel of `fused_g1_edge_update` and
// `fused_g1_edge_update_agg` (graphnets_tpu/ops/pallas/edge_update_g1.py,
// `_kernel` and `_forward`), with its arithmetic: the LN in f32 in the Flux
// convention (std = 0 where var == 0), the normalised row rounded to ef's
// type, the product accumulated in f32 (wgmma for bf16 rows; plain f32
// multiply-adds, never TF32, for f32 rows), the partials added in f32 in
// the order above.  src and tr may be bf16 or f32 independently of ef.
// h may be src itself (the caller's dead sender term, as the TPU kernel
// aliases it): every element of src is read before it is written.
//
// What bounds it on the H100: at the large-graph shape (E = 1,048,576,
// N = 65,536, 256 -> 256, bf16 rows and partials) it reads ef and src
// (0.54 GB each) and 34 MB of tr, and writes h (0.54 GB) and 67 MB of agg:
// ~1.7 GB, ~0.5 ms at 3.35 TB/s, against 137 GFLOP (~0.14 ms of bf16
// tensor-core work): memory bounds it.
//
// bf16 rows: the wgmma + TMA core of edge_wgmma.cuh.  Persistent blocks,
// one an SM, take 128 rows at a time; ef is read from device memory once
// and normalised once for all output columns; at 256 x 256, W0 (128 KB)
// is loaded once a block and stays in shared memory (wider weights stream
// through a ring).  A tile's tr rows are read directly: rl ascends, so they
// are one short window of the table, which stays in L2 (the TPU kernel's
// one-hot matmul gather is not carried over).  Rejected: the PR 4 design
// (64 x 128 WMMA tiles on a two-stage cp.async ring, ef normalised once
// per column tile and W0 re-read from L2 by every block: 2.58 ms at the
// large graph on an H100 80GB HBM3 at 700 W).
//
// f32 rows (no driven path takes them): 32 x 128 tiles of ln_gemm.cuh, ef
// streamed in k-chunks, true f32 multiply-adds.
//
// The sum.  The TPU kernel read-modify-wrote agg across its sequential
// grid.  Blocks here run concurrently, so each tile of rows (64 for bf16
// rows, 32 for f32) sums its rounded h by node, column by column in row
// order: a node whose edges lie wholly inside the tile gets its complete sum
// written to agg, and the runs that touch the tile's first and last rows go
// to two partial rows of the tile, which a second kernel adds in tile
// order: deterministic, no atomics, and a hub node that spans many tiles
// costs one partial row a tile.  Nodes with no edges keep the zeros the
// wrapper fills agg with.  Ids outside [0, N) read a zero tr row and join
// no sum.

#include <type_traits>

#include "edge_wgmma.cuh"
#include "ln_gemm.cuh"

namespace {

constexpr int kThreadsF = gn::kGemmThreads;
constexpr int kColsF = gn::kTileCols;

enum Part { kF32 = 1, kBf16 = 2 };

__device__ __forceinline__ float4 part4(const void* p, int kind, size_t row,
                                        int dout, int c) {
  if (kind == kF32)
    return gn::load4(static_cast<const float*>(p) + row * dout + c);
  return gn::load4(static_cast<const __nv_bfloat16*>(p) + row * dout + c);
}

// The single graph's partials for the wgmma core, added in the TPU
// kernel's order: ((src + gb) + tr[rl]) + product.  The partials' types
// are template arguments (no branch in the unrolled epilogue).  A bf16 src
// is staged through the staging tile by TMA; with a bf16 tr as well, the
// first three terms are added while the products run, otherwise after
// them (holding f32 loads beside the accumulators would spill).
template <bool kSrcF32, bool kTrF32>
struct Single {
  using SrcT = typename std::conditional<kSrcF32, float, __nv_bfloat16>::type;
  using TrT = typename std::conditional<kTrF32, float, __nv_bfloat16>::type;
  const SrcT* src;  // [E, dout]; may be h itself
  const TrT* tr;    // [N, dout]
  const float* gb;
  const int* rl;
  int N;

  static constexpr bool kStaged = !kSrcF32;
  static constexpr bool kStagedF32 = false;
  static constexpr bool kOutF32 = false;
  static constexpr bool kPreSum = kStaged && !kTrF32;

  struct Row {
    const SrcT* s;
    const TrT* t;   // a valid row of tr (row 0 for an id outside [0, N))
    bool valid;
  };
  __device__ __forceinline__ int receiver(int e) const { return rl[e]; }
  __device__ __forceinline__ Row row(int e, int dout) const {
    const int n = rl[e];
    const bool valid = n >= 0 && n < N;
    return {src + (size_t)e * dout, tr + (size_t)(valid ? n : 0) * dout,
            valid};
  }
  // (((src + gb) + tr) + product) at columns c, c + 1.
  __device__ __forceinline__ float2 apply(const Row& w, int c, float a0,
                                          float a1, float2 staged) const {
    const float2 p = pre(w, c, staged);
    return make_float2(p.x + a0, p.y + a1);
  }
  // ((src + gb) + tr) at columns c, c + 1; `staged`: src's pair from the
  // staging tile (kStaged).
  __device__ __forceinline__ float2 pre(const Row& w, int c,
                                        float2 staged) const {
    float2 s = staged;
    if constexpr (!kStaged) s = two(w.s + c);
    const float2 g = *reinterpret_cast<const float2*>(gb + c);
    const float2 t0 = two(w.t + c);
    const float2 t = w.valid ? t0 : make_float2(0.f, 0.f);
    return make_float2((s.x + g.x) + t.x, (s.y + g.y) + t.y);
  }

 private:
  __device__ __forceinline__ static float2 two(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ static float2 two(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

template <bool kSrcF32, bool kTrF32>
int launch_single(const void* ef, const void* w0, const void* scale,
                  const void* bias, const void* src, const void* tr,
                  const void* rl, const void* gb, void* h, void* agg,
                  void* part_first, void* part_last, int E, int N, int de,
                  int dout, int has_ln, cudaStream_t s) {
  using Epi = Single<kSrcF32, kTrF32>;
  const Epi epi{(const typename Epi::SrcT*)src, (const typename Epi::TrT*)tr,
                (const float*)gb, (const int*)rl, N};
  return gn::edge::launch(epi, ef, w0, scale, bias,
                          Epi::kStaged ? src : nullptr, h, agg, part_first,
                          part_last, (const int*)rl, E, N, de, dout, has_ln,
                          s);
}

// f32 rows: the epilogue of one [kTileRowsF x 128] tile held in Cs: add the
// partials, write h, and (with agg) sum by node.
__device__ __forceinline__ void finish_tile_f32(
    float* Cs, int* rls, const void* src, int src_kind, const void* tr,
    int tr_kind, const int* rl, const float* gb, float* h, float* agg,
    float* part_first, float* part_last, int E, int N, int dout, int row0,
    int c0) {
  constexpr int kRows = gn::kTileRowsF;
  const int tid = threadIdx.x;
  const int rows = min(kRows, E - row0);
  for (int r = tid; r < kRows; r += kThreadsF)
    rls[r] = r < rows ? rl[row0 + r] : -1;
  __syncthreads();
  for (int i = tid; i < rows * (kColsF / 4); i += kThreadsF) {
    const int r = i / (kColsF / 4), q = (i % (kColsF / 4)) * 4;
    const size_t row = (size_t)row0 + r;
    const int c = c0 + q, n = rls[r];
    const float4 p = *reinterpret_cast<const float4*>(Cs + r * gn::kLdc + q);
    const float4 s = part4(src, src_kind, row, dout, c);
    const float4 g4 = gn::load4(gb + c);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n >= 0 && n < N) t = part4(tr, tr_kind, (size_t)n, dout, c);
    float4 v;
    v.x = ((s.x + g4.x) + t.x) + p.x;
    v.y = ((s.y + g4.y) + t.y) + p.y;
    v.z = ((s.z + g4.z) + t.z) + p.z;
    v.w = ((s.w + g4.w) + t.w) + p.w;
    gn::store4(h + row * dout + c, v);
    if (agg != nullptr)
      *reinterpret_cast<float4*>(Cs + r * gn::kLdc + q) = v;
  }
  if (agg == nullptr) return;
  __syncthreads();
  if (tid >= kColsF) return;
  // Column c0 + tid: runs of equal ids, in row order.
  const int c = c0 + tid;
  const size_t tile = (size_t)blockIdx.x;
  float sum = 0.f;
  int cur = rls[0];
  bool is_first = true;
  for (int r = 0; r < rows; ++r) {
    const int n = rls[r];
    if (n != cur) {
      if (is_first) part_first[tile * dout + c] = sum;
      else if (cur >= 0 && cur < N) agg[(size_t)cur * dout + c] = sum;
      is_first = false;
      cur = n;
      sum = 0.f;
    }
    sum += Cs[r * gn::kLdc + tid];
  }
  // The run that reaches the tile's last row.
  if (is_first) part_first[tile * dout + c] = sum;
  else part_last[tile * dout + c] = sum;
}

template <bool kLn>
__global__ void __launch_bounds__(kThreadsF)
g1_edge_update_f32_kernel(const float* __restrict__ ef,
                          const float* __restrict__ w0,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const void* src, int src_kind,
                          const void* __restrict__ tr, int tr_kind,
                          const int* __restrict__ rl,
                          const float* __restrict__ gb, float* h,
                          float* __restrict__ agg,
                          float* __restrict__ part_first,
                          float* __restrict__ part_last, int E, int N, int de,
                          int dout) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int rls[gn::kTileRowsF];
  const int row0 = blockIdx.x * gn::kTileRowsF, c0 = blockIdx.y * kColsF;
  float acc[4][4];
  gn::ln_gemm_tile_f32<kLn>(ef, w0, scale, bias, E, de, dout, row0, c0, smem,
                            acc);
  float* Cs = gn::tile_cs_f32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(Cs + (warp * 4 + i) * gn::kLdc + lane * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  finish_tile_f32(Cs, rls, src, src_kind, tr, tr_kind, rl, gb, h, agg,
                  part_first, part_last, E, N, dout, row0, c0);
}

}  // namespace

// Rows of ef a partial row of the edge->node sum covers.
extern "C" int gn_g1_edge_update_tile_rows(int is_f32) {
  return is_f32 ? gn::kTileRowsF : gn::edge::kRows;
}

// Launches the kernel (and, with agg, the boundary pass) on `stream` and
// returns the first launch error.  `src_kind` / `tr_kind`: 1 f32, 2 bf16.
// h may equal src (bf16 rows and partials).  With agg: agg [N, dout] f32
// zero-filled by the caller, part_first and part_last
// [ceil(E / tile_rows), dout] f32 scratch.  Preconditions, checked by the
// Python wrapper: ef [E, de] and w0 [de, dout] of one type (bf16, or f32
// with is_f32), h [E, dout] of that type, src [E, dout], tr [N, dout], rl
// [E] int32 ascending, f32 scale, bias [de] and gb [dout]; contiguous and
// 16-byte aligned; E >= 1; de % 128 == 0; dout % 128 == 0.
extern "C" int gn_g1_edge_update(const void* ef, const void* w0,
                                 const void* scale, const void* bias,
                                 const void* src, int src_kind,
                                 const void* tr, int tr_kind, const void* rl,
                                 const void* gb, void* h, void* agg,
                                 void* part_first, void* part_last, int E,
                                 int N, int de, int dout, int is_f32,
                                 int has_ln, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_f32) {
    const bool s32 = src_kind == kF32, t32 = tr_kind == kF32;
    if (s32 && t32)
      return launch_single<true, true>(ef, w0, scale, bias, src, tr, rl, gb, h, agg, part_first, part_last, E, N, de, dout, has_ln, s);
    if (s32)
      return launch_single<true, false>(ef, w0, scale, bias, src, tr, rl, gb, h, agg, part_first, part_last, E, N, de, dout, has_ln, s);
    if (t32)
      return launch_single<false, true>(ef, w0, scale, bias, src, tr, rl, gb, h, agg, part_first, part_last, E, N, de, dout, has_ln, s);
    return launch_single<false, false>(ef, w0, scale, bias, src, tr, rl, gb, h, agg, part_first, part_last, E, N, de, dout, has_ln, s);
  }
  const int tile_rows = gn::kTileRowsF;
  const int tiles = (E + tile_rows - 1) / tile_rows;
  const size_t smem = gn::kTileBytesF;
  const dim3 grid(tiles, dout / kColsF);
  auto kernel = has_ln ? g1_edge_update_f32_kernel<true>
                       : g1_edge_update_f32_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsF, smem, s>>>(
      (const float*)ef, (const float*)w0, (const float*)scale,
      (const float*)bias, src, src_kind, tr, tr_kind, (const int*)rl,
      (const float*)gb, (float*)h, (float*)agg, (float*)part_first,
      (float*)part_last, E, N, de, dout);
  err = cudaGetLastError();
  if (err != cudaSuccess || agg == nullptr) return err;
  gn::edge::edge_agg_boundary_kernel<<<tiles, 256, 0, s>>>(
      (const int*)rl, (const float*)part_first, (const float*)part_last,
      (float*)agg, E, N, dout, tile_rows, tiles);
  return cudaGetLastError();
}
