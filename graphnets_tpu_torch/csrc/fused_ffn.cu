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
// What bounds it on the H100: 4 * T * d * 4d operations (1.1 TFLOP at
// T = 1,048,576, d = 256: ~1.1 ms at 989 TFLOP/s bf16) against 3 * T * d
// * 2 bytes of rows (1.6 GB, ~0.5 ms): the tensor cores bound it.
//
// bf16 rows: wgmma fed by TMA.  A block of two warpgroups takes a tile of
// rows; one thread issues the TMA loads (a dedicated producer warp would
// cap the registers of a thread at 168, below what the accumulators
// need).  The x tile arrives in a 128-byte-swizzled bf16 tile in shared
// memory, which the warps normalise in place into xn, laid out as wgmma's
// K-major A operand.  A ring of weight slices follows, each stage refilled
// as soon as both warpgroups hand it back (completion and hand-back on
// one mbarrier each a stage): W1[:, j:j+64] and
// W2[j:j+64, :] in turn, each [d x 64] or [64 x d] in [64 x 64] boxes,
// read by wgmma MN-major (their columns along the 128-byte rows), so the
// row-major weights need no transpose.  Per hidden slice of 64 each
// consumer warpgroup forms
//
//   hp = xn @ W1[:, j:j+64]          wgmma m64n64k16, A and B in shared
//   h  = bf16(relu(hp + b1))         in registers
//   y += h @ W2[j:j+64, :]           wgmma m64n64k16, A from registers
//
// the hidden slice never leaves the registers: the f32 accumulator of the
// first product, rounded to bf16 pairs, is already the register layout of
// the second product's A operand.  The y accumulator (f32) is the binding
// resource: up to d = 256 the tile is 128 rows, 64 a warpgroup, each
// holding a [64 x d] accumulator (128 registers a thread at d = 256); at
// d = 384 and 512 the tile is 64 rows and the two warpgroups split y's
// columns, each forming the (same) hidden slice for itself: 1.5x the
// tensor-core work of the products, against an accumulator that would
// not fit.  The epilogue stages the f32 tile in shared memory and writes
// whole rows: y = bf16(xf + ((acc + b2) + extra)).  Rows past T arrive as
// zeros, are normalised to zeros and are never written.
//
// Few row tiles (T = 1024, 1056 or 8 on the node and graph sets) leave
// most SMs idle, so up to 8 blocks split the hidden dimension of a row tile
// and the last to finish (a counter a tile) adds their f32 partials in a
// fixed order before the epilogue.
//
// Rejected: the PR 1 design (WMMA fragments fed by a two-stage cp.async
// ring, the hidden slice through shared memory twice, loading,
// synchronising and multiplying in turn: 13.68 ms at T = 1,048,576,
// d = 256 on an H100 80GB HBM3 at 700 W); persistent blocks and 2-CTA
// clusters that multicast the weight slices are not built yet.
//
// f32 rows, the JAX package's default precision (Policy() computes in
// f32; the headline forward and the large graph's step run them, phase F
// of chip_smoke.py): the same function, `_fwd_kernel` / `_fused_forward`
// on f32 tiles.  True-f32 multiply-adds on the CUDA cores, never TF32, so
// what bounds it is 4 * T * d * 4d f32 operations at 67 TFLOP/s (0.58 ms
// at T = 16384, d = 384; 16.4 ms at T = 1,048,576, d = 256) against
// 3 * T * d * 4 bytes of rows (0.08 ms; 1.0 ms).  Reaching the FMA pipes
// takes many multiply-adds a shared-memory load and loads that overlap
// them, so the design (F32Tile) is register-blocked:
//
// - a block takes BM = 32768 / d rows (64 at d = 384) and keeps its f32
//   y accumulator in registers, 8 rows x d / TX columns a thread (at most
//   128 registers);
// - the rows are normalised once into xn^T in shared memory (k-major, so
//   a thread's 8 rows at one k are two float4 loads);
// - per hidden slice of HS = d / 4 (128 at d = 384 and 512) the thread
//   forms an 8 x 4 piece of hp = xn @ W1[:, slice] (12 loads for 32
//   multiply-adds a k), writes relu(hp + b1) to h^T in shared memory, and
//   adds h @ W2[slice, :] into its 8 x CY piece of y (2 + CY / 4 float4
//   loads for 8 CY multiply-adds a k);
// - W1 and W2 slices stream through a ring of 3 stages of 16 or 24 KB
//   filled by 16-byte cp.async copies, one barrier a stage: the copy of
//   stage j + 2 overlaps the multiply-adds of stage j;
// - with few row tiles (the node and graph sets) up to 16 blocks split
//   the hidden slices of a tile, and the last to finish adds the f32
//   partials in split order (bit-equal from launch to launch);
// - sums of multiply-adds run in order of k, rows past T are normalised
//   as zeros and never written.
//
// Each block reads W1 and W2 once from L2 (2 MiB at d = 256): 16 GiB at
// T = 1,048,576 against 64 GiB for the 32-row blocks of the first f32
// kernel, which loaded a slice, synchronised and multiplied in turn and
// issued one shared-memory load for every 2 multiply-adds (3.10 ms at
// T = 16384, d = 384 and 78.0 ms at T = 1,048,576, d = 256 on an H100
// 80GB HBM3 at 700 W; PERF.md has the new times).
//
// `extra` is read and the result goes to a separate buffer: the kernel
// does not alias `extra` into the output as the TPU kernel does.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kSlice = 64;                  // hidden columns of a step
// Two warpgroups and no producer warp: a ninth warp would cut the
// registers a thread may hold from 255 to 168, which the y accumulator
// and a hidden slice outgrow at d = 256.  Thread 0 issues the loads.
constexpr int kThreads = 256;

// Rows of a bf16 block at width D.
constexpr int rows_for(int D) { return D > 256 ? 64 : 128; }

template <int D>
struct Fwd {
  static constexpr int BM = rows_for(D);
  static constexpr bool kSplitCols = D > 256;  // warpgroups split y's columns
  static constexpr int NY = kSplitCols ? D / 2 : D;  // y columns a warpgroup
  static constexpr int NCH = NY / 64;               // its 64-column chunks
  static constexpr int kStages = D == 384 ? 3 : D == 512 ? 2 : 4;
  static constexpr int kBuf = D * kSlice * 2;  // one W1 or W2 slice
  static constexpr int kAtom = BM * 128;       // xn: 64 columns of its rows
  static constexpr int kLdy = D + 8;           // staged f32 rows
  static constexpr size_t kRing = (size_t)BM * D * 2;
  static constexpr size_t kBars = kRing + (size_t)kStages * kBuf;
  // full[kStages], empty[kStages], the x tile's barrier, the split flag.
  static constexpr size_t kBytes = kBars + 2 * kStages * 8 + 8 + 16 + 1024;
  static_assert((size_t)BM * kLdy * 4 <= kBars, "staged rows fit");
  static_assert(kBytes <= 232448, "fits an SM's shared memory");
};


template <int D>
__global__ void __launch_bounds__(kThreads, 1)
ln_ffn_residual_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap w1map,
                       const __grid_constant__ CUtensorMap w2map,
                       const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ extra,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ b1,
                       const float* __restrict__ b2,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partial,
                       int* __restrict__ counters, int T) {
  using L = Fwd<D>;
  constexpr int S = L::kStages;
  constexpr int kSteps = 4 * D / kSlice;
  const int splits = gridDim.y;  // blocks sharing one row tile (split-K)
  const int n_steps = kSteps / splits;
  const int s_begin = blockIdx.y * n_steps;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + (uint32_t)L::kBars;
  const uint32_t empty = full + S * 8;
  const uint32_t xbar = empty + S * 8;
  int* last = reinterpret_cast<int*>(smem + L::kBars + 2 * S * 8 + 8);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * L::BM;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Ring item `it`: the W1 slice of step it / 2 for even it, its W2 slice
  // for odd; issued by thread 0 once both warpgroups have handed back the
  // stage's previous item.
  const int items = 2 * n_steps;
  auto issue = [&](int it) {
    const int s = it % S;
    mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
    const uint32_t fb = full + 8 * s;
    const uint32_t dst = base + (uint32_t)L::kRing + s * L::kBuf;
    mbar_expect_tx(fb, L::kBuf);
    const int j0 = (s_begin + it / 2) * kSlice;
#pragma unroll
    for (int b = 0; b < D / 64; ++b) {
      if (it & 1)  // W2 rows j0 .. j0 + 64, columns 64 b ..
        tma_load(dst + b * 8192, &w2map, fb, 64 * b, j0);
      else         // W1 rows 64 b .., columns j0 .. j0 + 64
        tma_load(dst + b * 8192, &w1map, fb, j0, 64 * b);
    }
  };
  if (tid == 0) {
    // The x tile into the xn tile's place, then the first S items.
    mbar_expect_tx(xbar, L::BM * D * 2);
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
      tma_load(base + b * L::kAtom, &xmap, xbar, 64 * b, row0);
    for (int it = 0; it < min(S, items); ++it) issue(it);
  }
  __syncwarp();
  // 1. xn = bf16(LN(x)) of the tile's rows, one warp a row, in place in
  //    the swizzled A tile (rows past T arrive as zeros): 16-byte chunk v
  //    of a row lies in 64-column atom v / 8 at chunk v % 8.
  mbar_wait(xbar, 0);
  for (int r = warp; r < L::BM; r += kThreads / 32) {
    const int row = row0 + r;
    float v[2][8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int vi = lane + 32 * j;
#pragma unroll
      for (int t = 0; t < 8; ++t) v[j][t] = 0.f;
      if (vi < D / 8) {
        const uint4 raw4 = *reinterpret_cast<const uint4*>(
            smem + (vi / 8) * L::kAtom + swz128(r, vi % 8));
        const __nv_bfloat162* p =
            reinterpret_cast<const __nv_bfloat162*>(&raw4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(p[t]);
          v[j][2 * t] = f.x;
          v[j][2 * t + 1] = f.y;
          sum += f.x + f.y;
        }
      }
    }
    const float mean = gn::warp_sum(sum) / D;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (lane + 32 * j < D / 8)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float c = v[j][t] - mean;
          q += c * c;
        }
    const float var = gn::warp_sum(q) / D;
    const float den = (var > 0.f ? sqrtf(var) : 0.f) + gn::kLnEps;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int vi = lane + 32 * j;
      if (vi >= D / 8) continue;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (row < T) {
        uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = vi * 8 + 2 * t;
          pk[t] = pack_bf16(
              __fadd_rn(__fmul_rn((v[j][2 * t] - mean) / den, scale[c]),
                        bias[c]),
              __fadd_rn(__fmul_rn((v[j][2 * t + 1] - mean) / den,
                                  scale[c + 1]),
                        bias[c + 1]));
        }
      }
      *reinterpret_cast<uint4*>(smem + (vi / 8) * L::kAtom +
                                swz128(r, vi % 8)) = packed;
    }
  }
  fence_proxy_async();  // the xn stores, before wgmma reads them
  __syncthreads();

  // 2. The hidden dimension, a slice of 64 a step.
  const int wg = tid >> 7;
  const int rw = L::kSplitCols ? 0 : 64 * wg;   // the warpgroup's rows
  const int cw = L::kSplitCols ? wg * L::NY : 0;  // and y columns
  const uint32_t xa = base + rw * 128;
  float y[L::NCH][32];
#pragma unroll
  for (int c = 0; c < L::NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) y[c][i] = 0.f;
    fence_regs(y[c]);
  }
  for (int t = 0; t < n_steps; ++t) {
    const int it = 2 * t;
    const int s1 = it % S, s2 = (it + 1) % S;
    mbar_wait(full + 8 * s1, (it / S) & 1);
    const uint32_t w1s = base + (uint32_t)L::kRing + s1 * L::kBuf;
    float hp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hp[i] = 0.f;
    fence_regs(hp);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_m64n64k16<0, 1>(
          hp, make_desc(xa + (k / 4) * L::kAtom + (k % 4) * 32, 16),
          make_desc(w1s + k * 2048, 8192));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(hp);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * s1);
    if (tid == 0 && it + S < items) issue(it + S);
    __syncwarp();

    // h = bf16(relu(hp + b1)), packed as the A fragments of 4 k16 steps.
    const int j0 = (s_begin + t) * kSlice;
    uint32_t a[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = 8 * q + 2 * p;
        const float2 bb = *reinterpret_cast<const float2*>(
            b1 + j0 + 8 * (i / 4) + 2 * (lane & 3));
        const float h0 = hp[i] + bb.x, h1 = hp[i + 1] + bb.y;
        a[q][p] = pack_bf16(h0 > 0.f ? h0 : 0.f, h1 > 0.f ? h1 : 0.f);
      }

    mbar_wait(full + 8 * s2, ((it + 1) / S) & 1);
    const uint32_t w2s = base + (uint32_t)L::kRing + s2 * L::kBuf;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < L::NCH; ++c)
        wgmma_m64n64k16_rs<1>(
            y[c], a[q],
            make_desc(w2s + (cw / 64 + c) * 8192 + q * 2048, 8192));
    wgmma_commit();
    // The A registers are read asynchronously: nothing may reuse them
    // before the products are done.  The other warpgroup keeps the tensor
    // cores busy meanwhile.
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < L::NCH; ++c) fence_regs(y[c]);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * s2);
    if (tid == 0 && it + 1 + S < items) issue(it + 1 + S);
    __syncwarp();
  }

  // 3. Stage the f32 tile over xn and the ring (every warpgroup is done
  //    with both) and finish whole rows.
  __syncthreads();
  float* Ys = reinterpret_cast<float*>(smem);
  {
    const int lr = rw + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int c = 0; c < L::NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half;
          const int col = cw + 64 * c + 8 * j + 2 * (lane & 3);
          *reinterpret_cast<float2*>(Ys + (lr + 8 * half) * L::kLdy + col) =
              make_float2(y[c][i], y[c][i + 1]);
        }
  }
  __syncthreads();
  const int rows = min(L::BM, T - row0);

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
    if (tid == 0) *last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int i = tid; i < rows * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const size_t g = (size_t)(row0 + r) * D + c;
      float4 acc = __ldcg(reinterpret_cast<const float4*>(partial + g));
      for (int k = 1; k < splits; ++k) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(
            partial + (size_t)k * T * D + g));
        acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
      }
      *reinterpret_cast<float4*>(Ys + r * L::kLdy + c) = acc;
    }
    __syncthreads();
  }

  // Epilogue: y = bf16(xf + ((acc + b2) + extra)) with xf re-read from x.
#pragma unroll 4
  for (int i = tid; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const size_t g = (size_t)(row0 + r) * D + c;
    const float4 acc = *reinterpret_cast<const float4*>(Ys + r * L::kLdy + c);
    const float4 bb = *reinterpret_cast<const float4*>(b2 + c);
    float4 t = make_float4(acc.x + bb.x, acc.y + bb.y, acc.z + bb.z,
                           acc.w + bb.w);
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

constexpr int kThreadsF32 = 256;
constexpr int kStagesF32 = 3;     // the weight ring

// Tile of the f32 kernel at width D.  A block takes BM = 32768 / D rows
// (64 at D = 384) and walks the hidden dimension in slices of HS columns.
// Its 256 threads form a TY x TX grid: a thread holds rows
// 4 ty + i + 4 TY u (i < 4, u < 2) of hp (columns 4 tx .. 4 tx + 3 of the
// slice) and of y (columns 4 tx + j + 4 TX v, j < 4, v < CY / 4).  Each
// product of a slice streams its weights through the ring in Q stages of
// F floats: W1[q BK1 .. + BK1, j0 .. j0 + HS] or W2[j0 + q BK2 .. + BK2, :].
template <int D>
struct F32Tile {
  static constexpr int BM = D == 128 ? 256 : D == 256 ? 128 : 64;
  static constexpr int HS = 8192 / BM;            // hp: 32 values a thread
  static constexpr int TY = BM / 8, TX = kThreadsF32 / TY;
  static constexpr int CY = D / TX;               // y columns a thread
  static constexpr int kSlices = 4 * D / HS;
  static constexpr int F = D == 384 ? 6144 : 4096;
  static constexpr int BK1 = F / HS, BK2 = F / D;
  static constexpr int Q = D / BK1;               // = HS / BK2
  static constexpr int kLd = BM + 4;              // xn^T and h^T rows
  static constexpr size_t kH = (size_t)D * kLd * 4;
  static constexpr size_t kRing = kH + (size_t)HS * kLd * 4;
  static constexpr size_t kFlag = kRing + (size_t)kStagesF32 * F * 4;
  static constexpr size_t kBytes = kFlag + 16;
  static_assert(TY * TX == kThreadsF32 && HS == 4 * TX && CY % 4 == 0,
                "thread tile");
  static_assert(Q * BK1 == D && Q * BK2 == HS, "stages of a product");
  static_assert(kBytes <= 232448, "fits an SM's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreadsF32, 1)
ln_ffn_residual_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ extra,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2,
                           float* __restrict__ out,
                           float* __restrict__ partial,
                           int* __restrict__ counters, int T) {
  using L = F32Tile<D>;
  constexpr int S = kStagesF32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);             // xn^T [D][kLd]
  float* hs = reinterpret_cast<float*>(smem + L::kH);     // h^T [HS][kLd]
  float* ring = reinterpret_cast<float*>(smem + L::kRing);
  int* last = reinterpret_cast<int*>(smem + L::kFlag);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = tid / L::TX, tx = tid % L::TX;
  const int row0 = blockIdx.x * L::BM;
  const int splits = gridDim.y;  // blocks sharing one row tile (split-K)
  const int n_slices = L::kSlices / splits;
  const int slice0 = blockIdx.y * n_slices;
  const int items = n_slices * 2 * L::Q;

  // Ring item it: stage it % Q of product (it / Q) % 2 of the block's
  // slice it / (2 Q), 16-byte copies in flight while earlier items run.
  auto issue = [&](int it) {
    float* dst = ring + (it % S) * L::F;
    const int j0 = (slice0 + it / (2 * L::Q)) * L::HS;
    const int q = it % L::Q;
    if ((it / L::Q) % 2 == 0) {
#pragma unroll
      for (int i = tid; i < L::F / 4; i += kThreadsF32) {
        const int r = i / (L::HS / 4), c = (i % (L::HS / 4)) * 4;
        gn::cp_async16(dst + r * L::HS + c,
                       w1 + (size_t)(q * L::BK1 + r) * (4 * D) + j0 + c);
      }
    } else {
      const float* src = w2 + (size_t)(j0 + q * L::BK2) * D;
#pragma unroll
      for (int i = tid; i < L::F / 4; i += kThreadsF32)
        gn::cp_async16(dst + 4 * i, src + 4 * i);
    }
  };
#pragma unroll
  for (int it = 0; it < S - 1; ++it) {
    if (it < items) issue(it);
    gn::cp_async_commit();
  }

  // LN of each row in f32, one warp a row, into xn^T (rows past T are
  // zeros): the plain version's ((x - mean) / (std + eps)) * scale + bias.
  for (int r = warp; r < L::BM; r += kThreadsF32 / 32) {
    const int row = row0 + r;
    if (row >= T) {
#pragma unroll
      for (int i = 0; i < D / 32; ++i) xs[(lane + 32 * i) * L::kLd + r] = 0.f;
      continue;
    }
    const float* xr = x + (size_t)row * D;
    float v[D / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      v[i] = xr[lane + 32 * i];
      s += v[i];
    }
    const float mean = gn::warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const float c = v[i] - mean;
      q += c * c;
    }
    const float var = gn::warp_sum(q) / D;
    const float den = (var > 0.f ? sqrtf(var) : 0.f) + gn::kLnEps;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = lane + 32 * i;
      xs[c * L::kLd + r] =
          __fadd_rn(__fmul_rn((v[i] - mean) / den, scale[c]), bias[c]);
    }
  }

  // Stage `it` of the ring is ready for every thread (and the stage that
  // the next load overwrites is free) after the wait and the barrier.
  auto begin = [&](int it) {
    gn::cp_async_wait<S - 2>();
    __syncthreads();
    if (it + S - 1 < items) issue(it + S - 1);
    gn::cp_async_commit();
  };

  float y[8][L::CY];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < L::CY; ++c) y[r][c] = 0.f;

  int it = 0;
  for (int sl = 0; sl < n_slices; ++sl) {
    // hp = xn @ W1[:, j0 .. j0 + HS], the thread's 8 x 4 piece.
    float hp[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) hp[r][c] = 0.f;
    for (int q = 0; q < L::Q; ++q, ++it) {
      begin(it);
      const float* w = ring + (it % S) * L::F + 4 * tx;
      const float* a = xs + q * L::BK1 * L::kLd + 4 * ty;
#pragma unroll 16
      for (int k = 0; k < L::BK1; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + k * L::kLd);
        const float4 a1 =
            *reinterpret_cast<const float4*>(a + k * L::kLd + 4 * L::TY);
        const float4 b = *reinterpret_cast<const float4*>(w + k * L::HS);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) hp[r][c] = fmaf(ar[r], br[c], hp[r][c]);
      }
    }
    // h = relu(hp + b1), transposed into h^T; read after the next barrier.
    {
      const int j0 = (slice0 + sl) * L::HS;
      const float4 bb = *reinterpret_cast<const float4*>(b1 + j0 + 4 * tx);
      const float bc[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float t = hp[4 * u + i][c] + bc[c];
            v[i] = t > 0.f ? t : 0.f;
          }
          *reinterpret_cast<float4*>(hs + (4 * tx + c) * L::kLd + 4 * ty +
                                     4 * L::TY * u) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
    }
    // y += h @ W2[j0 .. j0 + HS, :], the thread's 8 x CY piece.
    for (int q = 0; q < L::Q; ++q, ++it) {
      begin(it);
      const float* w = ring + (it % S) * L::F + 4 * tx;
      const float* a = hs + q * L::BK2 * L::kLd + 4 * ty;
#pragma unroll
      for (int k = 0; k < L::BK2; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + k * L::kLd);
        const float4 a1 =
            *reinterpret_cast<const float4*>(a + k * L::kLd + 4 * L::TY);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float br[L::CY];
#pragma unroll
        for (int v = 0; v < L::CY / 4; ++v) {
          const float4 b =
              *reinterpret_cast<const float4*>(w + k * D + 4 * L::TX * v);
          br[4 * v] = b.x;
          br[4 * v + 1] = b.y;
          br[4 * v + 2] = b.z;
          br[4 * v + 3] = b.w;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < L::CY; ++c) y[r][c] = fmaf(ar[r], br[c], y[r][c]);
      }
    }
  }
  gn::cp_async_wait<0>();

  // The thread's rows and columns.
  auto row_of = [&](int r) { return row0 + 4 * ty + (r & 3) + 4 * L::TY * (r >> 2); };
  auto col_of = [&](int v) { return 4 * tx + 4 * L::TX * v; };

  if (splits > 1) {
    // Split-K over the hidden dimension: publish this block's partial sum;
    // the last of the row tile's blocks to arrive adds the partials in
    // split order (deterministic) and finishes the rows.
    float* mine = partial + (size_t)blockIdx.y * T * D;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = row_of(r);
      if (row >= T) continue;
#pragma unroll
      for (int v = 0; v < L::CY / 4; ++v)
        *reinterpret_cast<float4*>(mine + (size_t)row * D + col_of(v)) =
            make_float4(y[r][4 * v], y[r][4 * v + 1], y[r][4 * v + 2],
                        y[r][4 * v + 3]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = row_of(r);
      if (row >= T) continue;
#pragma unroll
      for (int v = 0; v < L::CY / 4; ++v) {
        const size_t g = (size_t)row * D + col_of(v);
        float4 acc = __ldcg(reinterpret_cast<const float4*>(partial + g));
        for (int k = 1; k < splits; ++k) {
          const float4 p = __ldcg(reinterpret_cast<const float4*>(
              partial + (size_t)k * T * D + g));
          acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
        }
        y[r][4 * v] = acc.x;
        y[r][4 * v + 1] = acc.y;
        y[r][4 * v + 2] = acc.z;
        y[r][4 * v + 3] = acc.w;
      }
    }
  }

  // Epilogue: y = xf + ((acc + b2) + extra), whole float4s of a row.
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row_of(r);
    if (row >= T) continue;
#pragma unroll
    for (int v = 0; v < L::CY / 4; ++v) {
      const int c = col_of(v);
      const size_t g = (size_t)row * D + c;
      const float4 bb = *reinterpret_cast<const float4*>(b2 + c);
      float4 t = make_float4(y[r][4 * v] + bb.x, y[r][4 * v + 1] + bb.y,
                             y[r][4 * v + 2] + bb.z, y[r][4 * v + 3] + bb.w);
      if (extra != nullptr) {
        const float4 e = *reinterpret_cast<const float4*>(extra + g);
        t.x += e.x; t.y += e.y; t.z += e.z; t.w += e.w;
      }
      const float4 xv = *reinterpret_cast<const float4*>(x + g);
      *reinterpret_cast<float4*>(out + g) =
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
    using L = F32Tile<D>;
    if (splits < 1 || L::kSlices % splits) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ln_ffn_residual_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((T + L::BM - 1) / L::BM, splits);
    ln_ffn_residual_f32_kernel<D><<<grid, kThreadsF32, L::kBytes, stream>>>(
        (const float*)x, (const float*)extra, (const float*)scale,
        (const float*)bias, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (float*)out, (float*)partial,
        (int*)counters, T);
    return cudaGetLastError();
  }
  if (splits < 1 || (4 * D / kSlice) % splits) return cudaErrorInvalidValue;
  CUtensorMap mx, m1, m2;
  int e;
  if ((e = make_map(&mx, x, T, D, Fwd<D>::BM)) != 0) return e;
  if ((e = make_map(&m1, w1, D, 4 * D, 64)) != 0) return e;
  if ((e = make_map(&m2, w2, 4 * D, D, 64)) != 0) return e;
  const size_t smem = Fwd<D>::kBytes;
  err = cudaFuncSetAttribute(ln_ffn_residual_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + Fwd<D>::BM - 1) / Fwd<D>::BM, splits);
  ln_ffn_residual_kernel<D><<<grid, kThreads, smem, stream>>>(
      mx, m1, m2, (const __nv_bfloat16*)x, (const __nv_bfloat16*)extra,
      (const float*)scale, (const float*)bias, (const float*)b1,
      (const float*)b2, (__nv_bfloat16*)out, (float*)partial, (int*)counters,
      T);
  return cudaGetLastError();
}

}  // namespace

// Rows of one bf16 block at width d (the split-K counters count row tiles).
extern "C" int gn_ln_ffn_residual_rows(int d) { return rows_for(d); }

// Rows of one f32 block at width d, and the hidden slices it walks (the
// split over the hidden dimension divides them); 0 for another width.
extern "C" int gn_ln_ffn_residual_f32_rows(int d) {
  switch (d) {
    case 128: return F32Tile<128>::BM;
    case 256: return F32Tile<256>::BM;
    case 384: return F32Tile<384>::BM;
    case 512: return F32Tile<512>::BM;
    default: return 0;
  }
}
extern "C" int gn_ln_ffn_residual_f32_slices(int d) {
  switch (d) {
    case 128: return F32Tile<128>::kSlices;
    case 256: return F32Tile<256>::kSlices;
    case 384: return F32Tile<384>::kSlices;
    case 512: return F32Tile<512>::kSlices;
    default: return 0;
  }
}

// Launches the kernel on `stream` and returns cudaGetLastError().
// `extra` may be null.  `splits` blocks share each row tile of
// gn_ln_ffn_residual_rows(d) rows (f32 rows, is_f32 = 1:
// gn_ln_ffn_residual_f32_rows(d)), each taking 1/splits of the hidden
// dimension; with splits > 1, `partial` is f32 scratch of splits * T * d
// and `counters` holds one zeroed int a row tile.
// Preconditions, checked by the Python wrapper: x/extra/w1/w2/out all of
// the rows' type, f32 scale/bias/b1/b2, contiguous and 16-byte aligned,
// T >= 1, d in {128, 256, 384, 512}, and splits dividing 4d / 64 (f32
// rows: gn_ln_ffn_residual_f32_slices(d)).
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
