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
// f32 rows, the JAX package's default precision (the large graph's f32
// step, phase F(b) of chip_smoke.py, takes them three times in its forward
// and three in its step): true f32 multiply-adds on the CUDA cores, never
// TF32.  What bounds them is 2 E de dout f32 operations at 67 TFLOP/s
// (2.05 ms at E = 1,048,576, N = 65,536, 256 -> 256, f32 partials; 0.128
// ms at E = 65,536) against ~3.4 GB of rows (1.0 ms).  A block takes 64
// rows across 256 output columns (128 where 256 do not divide dout) on the
// register-blocked tile of f32_tile.cuh, 4 x 16 values a thread, two
// blocks an SM: ef is normalised once, on its way into shared memory, W0
// (256 KB, too large to stay) streams through the tile's double-buffered
// slabs from L2, and the partials are added to the registers.  The design
// it replaced (32 x 128 tiles, 4 x 4 a thread, every ef row normalised
// once per 128 output columns, one chunk fetched ahead) took 5.67 ms at
// the large shape and 0.465 ms at E = 65,536, N = 4096 on an H100 80GB
// HBM3 at 700 W.
//
// The sum.  The TPU kernel read-modify-wrote agg across its sequential
// grid.  Blocks here run concurrently, so each tile of 64 rows sums its
// rounded h by node, column by column in row order: a node whose edges lie wholly inside the tile gets its complete sum
// written to agg, and the runs that touch the tile's first and last rows go
// to two partial rows of the tile, which a second kernel adds in tile
// order: deterministic, no atomics, and a hub node that spans many tiles
// costs one partial row a tile.  Nodes with no edges keep the zeros the
// wrapper fills agg with.  Ids outside [0, N) read a zero tr row and join
// no sum.

#include <type_traits>

#include "edge_wgmma.cuh"
#include "f32_tile.cuh"
#include "row_stats.cuh"

namespace {

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

// ---- f32 rows ----------------------------------------------------------------

constexpr int kFThreads = gn::f32t::kThreads;
constexpr int kRowsF = 64;  // rows of an f32 tile

// ((x - mean) / s) * scale + bias on ef's way into shared memory, with
// one division a float4 ((x - mean) times 1 / s) and no fused
// multiply-add.
struct LnRows {
  const float* st;  // [rows][2]: mean, s
  const float* scale;
  const float* bias;
  __device__ __forceinline__ float4 operator()(float4 v, int r, int k) const {
    const float mean = st[2 * r], rs = 1.f / st[2 * r + 1];
    const float4 sc = gn::load4(scale + k), bi = gn::load4(bias + k);
    v.x = __fadd_rn(__fmul_rn(__fmul_rn(v.x - mean, rs), sc.x), bi.x);
    v.y = __fadd_rn(__fmul_rn(__fmul_rn(v.y - mean, rs), sc.y), bi.y);
    v.z = __fadd_rn(__fmul_rn(__fmul_rn(v.z - mean, rs), sc.z), bi.z);
    v.w = __fadd_rn(__fmul_rn(__fmul_rn(v.w - mean, rs), sc.w), bi.w);
    return v;
  }
};

// A tile of 64 rows across 16 CW output columns, 4 x CW a thread.
// Dynamic shared memory: the product's slabs, then the tile of h for the
// node sums; the rows' statistics [64][2]; their receivers [64].
template <int CW>
struct G1F32 {
  using Tl = gn::f32t::Tile<kRowsF / 16, CW>;
  static constexpr int kLdc = Tl::kCols + 4;
  static constexpr int kMain =
      Tl::kFloats > kRowsF * kLdc ? Tl::kFloats : kRowsF * kLdc;
  static constexpr size_t kBytes = (size_t)(kMain + 3 * kRowsF) * 4;
};

// f32 rows: [LN](ef) @ W0 for one tile in registers (ef normalised once,
// on its way into shared memory), the partials added in the TPU kernel's
// order, h written, and with agg the node sums of the tile's rows.
template <bool kLn, int CW>
__global__ void __launch_bounds__(kFThreads, 2)
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
  using P = G1F32<CW>;
  using Tl = typename P::Tl;
  extern __shared__ __align__(16) float smf[];
  float* Cs = smf;  // the tile of h, over the slabs once the product is done
  float* st = smf + P::kMain;
  int* rls = reinterpret_cast<int*>(st + 2 * kRowsF);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * kRowsF, c0 = blockIdx.y * Tl::kCols;
  const int rows = min(kRowsF, E - m0);
  for (int r = tid; r < kRowsF; r += kFThreads)
    rls[r] = r < rows ? rl[m0 + r] : -1;
  if (kLn) gn::tile_row_stats<kRowsF, kFThreads>(ef, de, m0, rows, st);
  __syncthreads();
  float acc[kRowsF / 16][CW];
  Tl::zero(acc);
  if constexpr (kLn)
    Tl::template mma<false>(ef, de, w0, dout, m0, c0, 0, de, E, acc, smf,
                            LnRows{st, scale, bias});
  else
    Tl::template mma<false>(ef, de, w0, dout, m0, c0, 0, de, E, acc, smf,
                            gn::f32t::Plain{});
  // h = ((src + gb) + tr[rl]) + product; src is read before h is written
  // (h may be src itself).
#pragma unroll
  for (int v = 0; v < CW / 4; ++v) {
    const int q = 4 * tx + 64 * v, c = c0 + q;
    const float4 g4 = gn::load4(gb + c);
#pragma unroll
    for (int r = 0; r < kRowsF / 16; ++r) {
      const int lr = Tl::row(ty, r);
      if (lr >= rows) continue;
      const size_t row = (size_t)m0 + lr;
      const int n = rls[lr];
      const float4 s = part4(src, src_kind, row, dout, c);
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n >= 0 && n < N) t = part4(tr, tr_kind, (size_t)n, dout, c);
      float4 o;
      o.x = ((s.x + g4.x) + t.x) + acc[r][4 * v];
      o.y = ((s.y + g4.y) + t.y) + acc[r][4 * v + 1];
      o.z = ((s.z + g4.z) + t.z) + acc[r][4 * v + 2];
      o.w = ((s.w + g4.w) + t.w) + acc[r][4 * v + 3];
      gn::store4(h + row * dout + c, o);
      if (agg != nullptr) gn::store4(Cs + lr * P::kLdc + q, o);
    }
  }
  if (agg == nullptr) return;
  __syncthreads();
  if (tid >= Tl::kCols) return;
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
    sum += Cs[r * P::kLdc + tid];
  }
  // The run that reaches the tile's last row.
  if (is_first) part_first[tile * dout + c] = sum;
  else part_last[tile * dout + c] = sum;
}

template <int CW>
int launch_f32(const void* ef, const void* w0, const void* scale,
               const void* bias, const void* src, int src_kind,
               const void* tr, int tr_kind, const void* rl, const void* gb,
               void* h, void* agg, void* part_first, void* part_last, int E,
               int N, int de, int dout, int has_ln, cudaStream_t s) {
  using P = G1F32<CW>;
  const int tiles = (E + kRowsF - 1) / kRowsF;
  const dim3 grid(tiles, dout / P::Tl::kCols);
  auto kernel = has_ln ? g1_edge_update_f32_kernel<true, CW>
                       : g1_edge_update_f32_kernel<false, CW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFThreads, P::kBytes, s>>>(
      (const float*)ef, (const float*)w0, (const float*)scale,
      (const float*)bias, src, src_kind, tr, tr_kind, (const int*)rl,
      (const float*)gb, (float*)h, (float*)agg, (float*)part_first,
      (float*)part_last, E, N, de, dout);
  err = cudaGetLastError();
  if (err != cudaSuccess || agg == nullptr) return err;
  gn::edge::edge_agg_boundary_kernel<<<tiles, 256, 0, s>>>(
      (const int*)rl, (const float*)part_first, (const float*)part_last,
      (float*)agg, E, N, dout, kRowsF, tiles);
  return cudaGetLastError();
}

}  // namespace

// Rows of ef a partial row of the edge->node sum covers.
extern "C" int gn_g1_edge_update_tile_rows(int is_f32) {
  return is_f32 ? kRowsF : gn::edge::kRows;
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
  // Output columns in blocks of 256 where they divide, else of 128.
  if (dout % 256 == 0)
    return launch_f32<16>(ef, w0, scale, bias, src, src_kind, tr, tr_kind, rl, gb, h, agg, part_first, part_last, E, N, de, dout, has_ln, s);
  return launch_f32<8>(ef, w0, scale, bias, src, src_kind, tr, tr_kind, rl, gb, h, agg, part_first, part_last, E, N, de, dout, has_ln, s);
}
