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
// type, the product accumulated in f32 (WMMA for bf16 rows; plain f32
// multiply-adds, never TF32, for f32 rows), the partials added in f32 in
// the order above.  src and tr may be bf16 or f32 independently of ef.
//
// What bounds it on the H100: at the large-graph shape (E = 1,048,576,
// N = 65,536, 256 -> 256, bf16 rows and partials) it reads ef and src
// (0.54 GB each) and 34 MB of tr, and writes h (0.54 GB) and 67 MB of agg:
// ~1.7 GB, ~0.5 ms at 3.35 TB/s, against 137 GFLOP (~0.14 ms of bf16
// tensor-core work): memory bounds it.
//
// What the design does about it: ef, src and h are streamed once per
// 128-column tile (ef again from L2 for the second column tile), the
// normalised rows and the f32 sum never reach device memory, and a tile's
// tr rows are read directly: rl ascends, so a tile's rows are one short
// window of the table, which stays in L2 (the TPU kernel's one-hot matmul
// gather is not carried over).  The ef operand streams through in k-chunks
// (ln_gemm.cuh), so shared memory does not depend on the widths.
//
// The sum.  The TPU kernel read-modify-wrote agg across its sequential
// grid.  Blocks here run concurrently, so: every thread of a tile's first
// 128 owns a column and walks the tile's rows in order.  A node whose edges
// lie wholly inside the tile gets its complete sum written to agg.  The run
// that touches the tile's first row and the run that touches its last row
// may continue in the neighbouring tiles: their sums go to two partial rows
// of the tile.  A second kernel then adds, for every node that touches a
// tile boundary, the partial rows in tile order: deterministic, no atomics,
// and a hub node that spans many tiles costs one partial row a tile.  Nodes
// with no edges keep the zeros the wrapper fills agg with.  Ids outside
// [0, N) read a zero tr row and join no sum.

#include "ln_gemm.cuh"

namespace {

constexpr int kThreads = gn::kGemmThreads;
constexpr int kCols = gn::kTileCols;

enum Part { kF32 = 1, kBf16 = 2 };

__device__ __forceinline__ float4 part4(const void* p, int kind, size_t row,
                                        int dout, int c) {
  if (kind == kF32)
    return gn::load4(static_cast<const float*>(p) + row * dout + c);
  return gn::load4(static_cast<const __nv_bfloat16*>(p) + row * dout + c);
}

__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// The epilogue of one [kRows x 128] tile held in Cs: add the partials, round
// once, write h, and (with agg) leave the rounded values in Cs and sum them
// by node.
template <typename TE, int kRows>
__device__ __forceinline__ void finish_tile(
    float* Cs, int* rls, const void* src, int src_kind, const void* tr,
    int tr_kind, const int* rl, const float* gb, TE* h, float* agg,
    float* part_first, float* part_last, int E, int N, int dout, int row0,
    int c0) {
  const int tid = threadIdx.x;
  const int rows = min(kRows, E - row0);
  for (int r = tid; r < kRows; r += kThreads)
    rls[r] = r < rows ? rl[row0 + r] : -1;
  __syncthreads();
  for (int i = tid; i < rows * (kCols / 4); i += kThreads) {
    const int r = i / (kCols / 4), q = (i % (kCols / 4)) * 4;
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
    if (agg != nullptr) {
      const TE* tag = nullptr;
      v.x = round_to(v.x, tag); v.y = round_to(v.y, tag);
      v.z = round_to(v.z, tag); v.w = round_to(v.w, tag);
      *reinterpret_cast<float4*>(Cs + r * gn::kLdc + q) = v;
    }
  }
  if (agg == nullptr) return;
  __syncthreads();
  if (tid >= kCols) return;
  // Column c0 + tid: runs of equal ids, in row order.
  const int c = c0 + tid;
  const size_t tile = (size_t)blockIdx.x;
  const int first = rls[0];
  float sum = 0.f;
  int cur = first;
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
__global__ void __launch_bounds__(kThreads, 3)
g1_edge_update_bf16_kernel(const __nv_bfloat16* __restrict__ ef,
                           const __nv_bfloat16* __restrict__ w0,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const void* __restrict__ src, int src_kind,
                           const void* __restrict__ tr, int tr_kind,
                           const int* __restrict__ rl,
                           const float* __restrict__ gb,
                           __nv_bfloat16* __restrict__ h,
                           float* __restrict__ agg,
                           float* __restrict__ part_first,
                           float* __restrict__ part_last, int E, int N,
                           int de, int dout) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int rls[gn::kTileRows];
  const int row0 = blockIdx.x * gn::kTileRows, c0 = blockIdx.y * kCols;
  gn::ln_gemm_tile_bf16<kLn>(ef, w0, scale, bias, E, de, dout, row0, c0,
                             smem);
  finish_tile<__nv_bfloat16, gn::kTileRows>(
      gn::tile_cs(smem), rls, src, src_kind, tr, tr_kind, rl, gb, h, agg,
      part_first, part_last, E, N, dout, row0, c0);
}

template <bool kLn>
__global__ void __launch_bounds__(kThreads)
g1_edge_update_f32_kernel(const float* __restrict__ ef,
                          const float* __restrict__ w0,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const void* __restrict__ src, int src_kind,
                          const void* __restrict__ tr, int tr_kind,
                          const int* __restrict__ rl,
                          const float* __restrict__ gb, float* __restrict__ h,
                          float* __restrict__ agg,
                          float* __restrict__ part_first,
                          float* __restrict__ part_last, int E, int N, int de,
                          int dout) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int rls[gn::kTileRowsF];
  const int row0 = blockIdx.x * gn::kTileRowsF, c0 = blockIdx.y * kCols;
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
  finish_tile<float, gn::kTileRowsF>(Cs, rls, src, src_kind, tr, tr_kind, rl,
                                     gb, h, agg, part_first, part_last, E, N,
                                     dout, row0, c0);
}

// The node sums that cross tile boundaries.  Block t looks at tile t's
// first run (if it does not continue the previous tile's last run) and at
// its last run (if the tile holds more than one run): for each it adds this
// tile's partial row and the first-run partial rows of the following tiles
// for as long as they belong to the same node, in tile order.
__global__ void __launch_bounds__(256)
g1_agg_boundary_kernel(const int* __restrict__ rl,
                       const float* __restrict__ part_first,
                       const float* __restrict__ part_last,
                       float* __restrict__ agg, int E, int N, int dout,
                       int tile_rows, int tiles) {
  const int t = blockIdx.x;
  auto first_of = [&](int u) { return rl[(size_t)u * tile_rows]; };
  auto last_of = [&](int u) {
    return rl[min((size_t)E, (size_t)(u + 1) * tile_rows) - 1];
  };
  const int first = first_of(t), last = last_of(t);
  for (int which = 0; which < 2; ++which) {
    int node;
    const float* mine;
    if (which == 0) {
      if (t > 0 && last_of(t - 1) == first) continue;  // an earlier tile's
      node = first;
      mine = part_first;
    } else {
      if (last == first) continue;  // one run only: handled as the first
      node = last;
      mine = part_last;
    }
    if (node < 0 || node >= N) continue;
    // The tiles after t that the node's run reaches: up to the one that
    // holds its last row (tile t itself when the run ends inside it).
    const int e1 = gn::lower_bound(rl, E, node + 1);
    const int until = (e1 - 1) / tile_rows + 1;
    for (int c = threadIdx.x; c < dout; c += blockDim.x) {
      float sum = mine[(size_t)t * dout + c];
      // A hub or pad node spans hundreds of tiles: unrolled, so that the
      // independent loads are in flight together; the adds stay in order.
#pragma unroll 8
      for (int u = t + 1; u < until; ++u)
        sum += part_first[(size_t)u * dout + c];
      agg[(size_t)node * dout + c] = sum;
    }
  }
}

}  // namespace

extern "C" size_t gn_g1_edge_update_smem(int is_f32) {
  return is_f32 ? gn::kTileBytesF : gn::kTileBytes;
}

// Rows of ef a block takes (the tiling of the partial rows).
extern "C" int gn_g1_edge_update_tile_rows(int is_f32) {
  return is_f32 ? gn::kTileRowsF : gn::kTileRows;
}

// Launches the kernel (and, with agg, the boundary pass) on `stream` and
// returns the first launch error.  `src_kind` / `tr_kind`: 1 f32, 2 bf16.
// With agg: agg [N, dout] f32 zero-filled by the caller, part_first and
// part_last [ceil(E / tile_rows), dout] f32 scratch.  Preconditions,
// checked by the Python wrapper: ef [E, de] and w0 [de, dout] of one type
// (bf16, or f32 with is_f32), h [E, dout] of that type, src [E, dout],
// tr [N, dout], rl [E] int32 ascending, f32 scale, bias [de] and gb [dout];
// contiguous and 16-byte aligned; E >= 1; de % 128 == 0; dout % 128 == 0.
extern "C" int gn_g1_edge_update(const void* ef, const void* w0,
                                 const void* scale, const void* bias,
                                 const void* src, int src_kind,
                                 const void* tr, int tr_kind, const void* rl,
                                 const void* gb, void* h, void* agg,
                                 void* part_first, void* part_last, int E,
                                 int N, int de, int dout, int is_f32,
                                 int has_ln, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tile_rows = gn_g1_edge_update_tile_rows(is_f32);
  const int tiles = (E + tile_rows - 1) / tile_rows;
  const size_t smem = gn_g1_edge_update_smem(is_f32);
  const dim3 grid(tiles, dout / kCols);
#define GN_LAUNCH(KERNEL, TE)                                                \
  do {                                                                       \
    cudaError_t err = cudaFuncSetAttribute(                                  \
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);     \
    if (err != cudaSuccess) return err;                                      \
    KERNEL<<<grid, kThreads, smem, s>>>(                                     \
        (const TE*)ef, (const TE*)w0, (const float*)scale,                   \
        (const float*)bias, src, src_kind, tr, tr_kind, (const int*)rl,      \
        (const float*)gb, (TE*)h, (float*)agg, (float*)part_first,           \
        (float*)part_last, E, N, de, dout);                                  \
  } while (0)
  if (is_f32) {
    if (has_ln) GN_LAUNCH(g1_edge_update_f32_kernel<true>, float);
    else GN_LAUNCH(g1_edge_update_f32_kernel<false>, float);
  } else {
    if (has_ln) GN_LAUNCH(g1_edge_update_bf16_kernel<true>, __nv_bfloat16);
    else GN_LAUNCH(g1_edge_update_bf16_kernel<false>, __nv_bfloat16);
  }
#undef GN_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || agg == nullptr) return err;
  g1_agg_boundary_kernel<<<tiles, 256, 0, s>>>(
      (const int*)rl, (const float*)part_first, (const float*)part_last,
      (float*)agg, E, N, dout, tile_rows, tiles);
  return cudaGetLastError();
}
