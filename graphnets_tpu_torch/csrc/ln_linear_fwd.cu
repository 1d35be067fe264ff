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
// against 4.8 GFLOP (~5 us of bf16 tensor-core work), so memory bounds it
// (without the addend 38.1 MB, ~11.4 us, the f32 product written out).
// At the sort task's shape (T = 512, d = dout = 384, f32) it is 0.15 GFLOP
// of f32 work on the CUDA cores (~2.3 us) against 2.9 MB: operations bound
// it, and launch latency is of the same size.
//
// bf16 rows: the wgmma + TMA core of edge_wgmma.cuh with a policy of its
// own (no receivers, no edge->node sum).  Persistent blocks of two
// warpgroups take 128 rows at a time; x arrives by TMA, is read from device
// memory once and normalised once in place for all of dout, and the next
// tile's rows arrive under the last pass's epilogue; W streams through a
// TMA ring (or stays resident where it fits); rows wider than shared memory
// holds are taken in pieces (the JAX gate reaches d = 2816 at dout = 128).
// The addend arrives by TMA into the staging tile during the products, in
// its stored type (f32: 32 KB a warpgroup, its stages taken from the W
// ring); the result leaves by TMA store, bf16, or f32 without an addend.
//
// f32 rows: true-f32 multiply-adds in order of k on the CUDA cores, never
// TF32, each thread a 4 x 4 piece of its block's tile; the block takes its
// rows' statistics from device memory, then x and W chunks of 32 k arrive
// by cp.async into a two-stage ring (scale, bias and the first chunk
// stream in while the statistics are taken), the x chunk is normalised in
// shared memory (one reciprocal a row and a fused-multiply-add correction,
// as on the bf16 rows), and the products read x and W four k at a time
// with 16-byte loads.  (With scale and bias read from device memory and
// a division a value, the normalisation was the largest part of the time
// at the sort task's shape.)  Tiles of 32 x 128, or of 16 x 64
// where those would leave SMs idle (the sort task's T = 512, dout = 384:
// 192 blocks instead of 48); the host's plan chooses.
//
// Rejected: the earlier design (64 x 128 WMMA tiles, x normalised once
// per 128-column tile and read 2 x dout / 128 times, W re-read by every
// block, loading, multiplying and storing in turn; 32 x 128 f32 tiles):
// 0.0861 ms at the bucketed headline with the addend, 0.0834 without, and
// 0.0291 ms at the sort task's f32 shape (chip_smoke.py, H100 80GB HBM3,
// 700 W).

#include "edge_wgmma.cuh"
#include "row_stats.cuh"

namespace {

enum Addend { kNone = 0, kF32 = 1, kBf16 = 2 };

// ln_matmul's epilogue on the edge core: product (+ addend), no receivers
// and no edge->node sum.
template <int kAdd>
struct LnMatmul {
  static constexpr bool kPreSum = false;
  static constexpr bool kStaged = kAdd == kBf16;
  static constexpr bool kStagedF32 = kAdd == kF32;
  static constexpr bool kOutF32 = kAdd == kNone;

  struct Row {};
  __device__ __forceinline__ int receiver(int) const { return -1; }
  __device__ __forceinline__ Row row(int, int) const { return {}; }
  __device__ __forceinline__ float2 apply(const Row&, int, float a0, float a1,
                                          float2 staged) const {
    if constexpr (kAdd == kNone)
      return make_float2(a0, a1);
    else
      return make_float2(a0 + staged.x, a1 + staged.y);
  }
};

template <int kAdd>
int launch_bf16(const void* x, const void* w, const void* scale,
                const void* bias, const void* addend, void* out, int T, int d,
                int dout, cudaStream_t s) {
  return gn::edge::launch(LnMatmul<kAdd>{}, x, w, scale, bias,
                          kAdd == kNone ? nullptr : addend, out, nullptr,
                          nullptr, nullptr, nullptr, T, 0, d, dout, 1, s);
}

// ---- f32 rows --------------------------------------------------------------

constexpr int kChunkK = 32;  // k of a ring stage
constexpr int kStagesF = 2;  // ring stages

template <int RM, int CN>
struct F32Tile {
  static constexpr int kThreads = (RM / 4) * (CN / 4);  // 4 x 4 a thread
  static constexpr int kLdx = kChunkK + 4;  // 16-byte rows for cp.async
  static constexpr int kLdw = CN + 4;
  static constexpr int kStage = RM * kLdx + kChunkK * kLdw;  // floats
  // The ring, the row statistics, then scale and bias ([d] each).
  static size_t smem(int d) {
    return (kStagesF * (size_t)kStage + 2 * RM + 2 * (size_t)d) * 4;
  }
};

// Four addend values of row `row` at column `c`, as f32.
__device__ __forceinline__ float4 addend4(const void* addend, int kind,
                                          size_t row, int dout, int c) {
  if (kind == kF32)
    return gn::load4(static_cast<const float*>(addend) + row * dout + c);
  return gn::load4(static_cast<const __nv_bfloat16*>(addend) + row * dout + c);
}

template <int RM, int CN>
__global__ void __launch_bounds__(F32Tile<RM, CN>::kThreads)
ln_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const void* __restrict__ addend, int kind,
                     float* __restrict__ out, int T, int d, int dout) {
  using L = F32Tile<RM, CN>;
  extern __shared__ __align__(16) float sm[];
  float* st = sm + kStagesF * L::kStage;
  float* sc = st + 2 * RM;
  float* bi = sc + d;
  const int tid = threadIdx.x, tx = tid % (CN / 4), ty = tid / (CN / 4);
  const int row0 = blockIdx.x * RM, c0 = blockIdx.y * CN;
  const int rows = min(RM, T - row0);

  // Chunk k0 of x and W into ring stage `stage` (rows past T: zeros).
  auto issue = [&](int k0, int stage) {
    float* xs = sm + stage * L::kStage;
    float* ws = xs + RM * L::kLdx;
    for (int i = tid; i < RM * (kChunkK / 4); i += L::kThreads) {
      const int r = i / (kChunkK / 4), v = (i % (kChunkK / 4)) * 4;
      if (r < rows)
        gn::cp_async16(xs + r * L::kLdx + v,
                       x + (size_t)(row0 + r) * d + k0 + v);
      else
        *reinterpret_cast<float4*>(xs + r * L::kLdx + v) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < kChunkK * (CN / 4); i += L::kThreads) {
      const int k = i / (CN / 4), v = (i % (CN / 4)) * 4;
      gn::cp_async16(ws + k * L::kLdw + v,
                     w + (size_t)(k0 + k) * dout + c0 + v);
    }
    gn::cp_async_commit();
  };

  // Scale and bias, then the first chunk, stream in while the statistics
  // are taken.
  for (int i = tid; i < d / 4; i += L::kThreads) {
    gn::cp_async16(sc + 4 * i, scale + 4 * i);
    gn::cp_async16(bi + 4 * i, bias + 4 * i);
  }
  const int nk = d / kChunkK;
  for (int k = 0; k < kStagesF - 1; ++k) {
    if (k < nk) issue(k * kChunkK, k);
    else gn::cp_async_commit();
  }
  gn::tile_row_stats<RM, L::kThreads>(x, d, row0, rows, st);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    const int stage = kc % kStagesF, ahead = kc + kStagesF - 1;
    if (ahead < nk) issue(ahead * kChunkK, ahead % kStagesF);
    else gn::cp_async_commit();  // an empty group keeps the count
    gn::cp_async_wait<kStagesF - 1>();
    __syncthreads();  // chunk kc (and the statistics) landed
    float* xs = sm + stage * L::kStage;
    const float* ws = xs + RM * L::kLdx;
    {
      // A thread normalises kPer consecutive values of one row: one
      // reciprocal, and the quotient correctly rounded (normal range) by a
      // fused-multiply-add correction (Markstein), as the bf16 rows' core.
      constexpr int kPer = kChunkK * RM / L::kThreads;  // 8 or 4
      const int r = tid / (kChunkK / kPer), k = (tid % (kChunkK / kPer)) * kPer;
      if (r < rows) {
        const float m = st[2 * r], dn = st[2 * r + 1], rd = __frcp_rn(dn);
        float* p = xs + r * L::kLdx + k;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int c = kc * kChunkK + k + u;
          const float v = p[u] - m;
          const float q0 = __fmul_rn(v, rd);
          const float q1 = fmaf(fmaf(-q0, dn, v), rd, q0);
          p[u] = __fadd_rn(__fmul_rn(q1, sc[c]), bi[c]);
        }
      }
    }
    __syncthreads();
    // Four k at a time: 16-byte loads of four x rows and four W rows,
    // then 64 multiply-adds, each accumulator in order of k.
#pragma unroll 2
    for (int k = 0; k < kChunkK; k += 4) {
      float a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(xs + (ty * 4 + i) * L::kLdx + k);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        const float4 u = *reinterpret_cast<const float4*>(
            ws + (k + i) * L::kLdw + tx * 4);
        b[i][0] = u.x; b[i][1] = u.y; b[i][2] = u.z; b[i][3] = u.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
    }
    __syncthreads();  // the stage is refilled by the next iteration
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) break;
    const size_t row = (size_t)row0 + r;
    const int c = c0 + tx * 4;
    float4 a = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (kind != kNone) {
      const float4 v = addend4(addend, kind, row, dout, c);
      a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
    }
    gn::store4(out + row * dout + c, a);
  }
}

template <int RM, int CN>
int launch_f32(const void* x, const void* w, const void* scale,
               const void* bias, const void* addend, int kind, void* out,
               int T, int d, int dout, cudaStream_t s) {
  using L = F32Tile<RM, CN>;
  auto kernel = ln_matmul_f32_kernel<RM, CN>;
  const size_t smem = L::smem(d);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + RM - 1) / RM, dout / CN);
  kernel<<<grid, L::kThreads, smem, s>>>(
      (const float*)x, (const float*)w, (const float*)scale,
      (const float*)bias, addend, kind, (float*)out, T, d, dout);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns the first launch error.
// `addend_kind`: 0 none (out is the f32 partial), 1 f32, 2 bf16 (out has x's
// type).  `tile_rows` (f32 rows): 32 for 32 x 128 tiles, 16 for 16 x 64.
// Preconditions, checked by the Python wrapper: x [T, d] and w [d, dout]
// of one type (bf16, or f32 with is_f32), f32 scale and bias, addend and
// out [T, dout], all contiguous and 16-byte aligned; T >= 1; d % 128 == 0;
// dout % 128 == 0.
extern "C" int gn_ln_matmul(const void* x, const void* w, const void* scale,
                            const void* bias, const void* addend, void* out,
                            int T, int d, int dout, int is_f32,
                            int addend_kind, int tile_rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32)
    return tile_rows == 16
               ? launch_f32<16, 64>(x, w, scale, bias, addend, addend_kind,
                                    out, T, d, dout, s)
               : launch_f32<32, 128>(x, w, scale, bias, addend, addend_kind,
                                     out, T, d, dout, s);
  switch (addend_kind) {
    case kNone:
      return launch_bf16<kNone>(x, w, scale, bias, addend, out, T, d, dout, s);
    case kF32:
      return launch_bf16<kF32>(x, w, scale, bias, addend, out, T, d, dout, s);
    default:
      return launch_bf16<kBf16>(x, w, scale, bias, addend, out, T, d, dout,
                                s);
  }
}
