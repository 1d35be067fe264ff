// Backward of the fused LayerNorm -> FeedForward -> residual
//
//   y = x [+ extra] + (relu(LN(x) @ W1 + b1) @ W2 + b2)
//
// for the cotangent g of y: dx, dscale, dbias, dW1, db1, dW2, db2.
//
// Replaces the Pallas kernel of `_fused_backward`
// (graphnets_tpu/ops/pallas/fused_ffn.py, `_bwd_kernel`), with its
// arithmetic: only x is kept from the forward; the LN statistics (Flux
// convention, std = 0 and sigma = 1 where var == 0), the normalised rows
// xn = T(z * scale + bias) and the hidden activation are recomputed, and
//
//   hp  = xn @ W1 + b1 (f32),   h = T(relu(hp))
//   db2 = sum_rows f32(g),      dW2 = h^T @ g
//   dh  = g @ W2^T,             dhp = dh where hp > 0 else 0 (mask from f32)
//   db1 = sum_rows dhp,         dW1 = xn^T @ T(dhp)
//   dxn = T(dhp) @ W1^T,        dscale = sum_rows dxn * z,
//                               dbias = sum_rows dxn
//   dz  = dxn * scale
//   dx  = T( (dz - mean(dz)) / s - (z - mean(z)) * (mean(dz * z) / sigma)
//            + f32(g) )
//
// for rows of type T (bf16 or f32), every product accumulated in f32.
//
// What bounds it on the H100: the five products of T x d x 4d that the
// function needs, 10 * T * d * 4d operations (2.75 TFLOP at T = 1,048,576,
// d = 256: ~2.8 ms at 989 TFLOP/s bf16) against 3 * T * d * 2 bytes of
// rows (1.6 GB, ~0.5 ms): the tensor cores bound it.
//
// What the design does about it.  The TPU kernel kept both weight
// gradients (2 x d x 4d f32) resident across its sequential grid and
// recomputed hp and dh once.  On the H100 the five products run as three
// tensor-core passes of one warp-specialised kernel, and the [T, 4d]
// hidden activation and its cotangent make one round trip through device
// memory in x's type instead of being recomputed by a second pass:
//
// 0. prep: one warp a row writes xn and the row statistics.
// 1. hidden pass (hp and dh, K = d): per [128 rows, 128 hidden] tile it
//    forms hp = xn @ W1 and dh = g @ W2^T, writes h and T(dhp) and the
//    tile's column sums of the f32 dhp (for db1).
// 2. dxn pass (K = 4d): dxn = T(dhp) @ W1^T into f32 [T, d].
// 3. post: one warp a row gives dx from dxn, x and the statistics; the
//    column sums of dxn * z, dxn and g are added tile after tile.
// 4. weight pass (K = T, split over row ranges): dW2 = h^T @ g and
//    dW1 = xn^T @ T(dhp), the row dimension read MN-major.
// 5. the partials of the passes are added in a fixed order: no atomics,
//    deterministic.
//
// bf16 rows: each pass is a block of two consumer warpgroups (64 rows
// each) and one producer warp.  The producer keeps a four-stage ring of
// [128 x 64] operand tiles full with TMA loads (cp.async.bulk.tensor,
// 128-byte swizzle, completion on an mbarrier per stage); the consumers run
// wgmma.mma_async m64n128k16 on the stage that has arrived, keep one
// group in flight, and hand the previous stage back through its "empty"
// mbarrier.  Rows past T arrive as zeros (the tensor map's bounds) and are
// never written.
//
// f32 rows, the JAX package's default precision (the large graph's f32
// step, phase F(b) of chip_smoke.py, runs them 6 times): the same passes
// with true-f32 products on the CUDA cores, never TF32.  What bounds them
// is 10 * T * d * 4d f32 operations at 67 TFLOP/s (2.56 ms at T = 65,536,
// d = 256; 41.0 ms at T = 1,048,576) against 3 * T * d * 4 bytes of rows;
// h and dhp make one round trip in f32 (16 * T * 4d bytes, 0.6 ms at
// T = 65,536).  Every product runs on one register-blocked tile
// (f32_gemm): 128 x 128 outputs a block of 256 threads, 8 x 8 a thread
// (16 multiply-adds a float4 load from shared memory), k in slabs of 16
// through a double-buffered pair of k-major slabs: B and a row-major A by
// 16-byte cp.async copies, a K-major A (xn, g, dhp) by 16-byte loads into
// registers stored transposed; the next slab is in flight while this one's
// multiply-adds run, one barrier a slab, two blocks an SM.  The wrapper
// hands W1^T and W2^T in, so every B is row-major.  The hidden pass keeps
// the relu mask in 64 bits between its two products; the weight pass
// splits T into ranges so that tiles x ranges >= 2 x 132 (two blocks an
// SM), added in order by the reduction.  The first f32 passes (64 x 64
// tiles, 4 x 4 a thread, operands loaded element by element with the
// transposes in the scalar stores, two barriers a slab, no double buffer)
// took 8.66 ms at T = 65,536, d = 256 and 136.6 ms at T = 1,048,576 on an
// H100 80GB HBM3 at 700 W.
//
// The rejected design (the first one): a row pass and a split-K weight
// pass that each recomputed hp and dh with WMMA, loading, synchronising
// and multiplying in turn (7 products; 60.7 ms at T = 1,048,576, d = 256
// on an H100 80GB HBM3 at 700 W).

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;                   // rows (M) of a tile
constexpr int kBN = 128;                   // columns (N) of a tile
constexpr int kBK = 64;                    // k of a stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kTileBytes = kBM * kBK * 2;  // 16 KB: one operand of a stage
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kGemmThreads = kConsumers + 32;
// The hidden pass stages its bf16 h and dhp tiles here before writing
// them out in whole rows (two [64, kBN + 8] tiles a consumer warpgroup).
constexpr int kLdo = kBN + 8;
constexpr int kOutBytes = 2 * 2 * 64 * kLdo * 2;
constexpr size_t kGemmSmem = (size_t)kStages * kStageBytes + kOutBytes +
                             1024 + (size_t)8 * kBN * 4 + 2 * kStages * 8;

enum Mode { kHidden = 0, kDxn = 1, kWeights = 2 };

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---- the tensor-core passes (bf16 rows) ------------------------------------

struct GemmArgs {
  int T, d;
  int nk;               // k-steps of the block (kWeights: of a full split)
  int k_split;          // kWeights: rows of a split (a multiple of kBK)
  int tiles0;           // kWeights: tiles of the first problem (dW2)
  int tiles_n0, tiles_n1;  // column tiles (of each problem for kWeights)
  int items;            // work items: output tiles (x splits for kWeights)
  const float* b1;      // kHidden
  __nv_bfloat16* h;     // kHidden: [T, 4d]
  __nv_bfloat16* dhp;   // kHidden: [T, 4d]
  float* part_db1;      // kHidden: [ceil(T / 128), 4d]
  float* c;             // kDxn: dxn [T, d]
  float* part_dw2;      // kWeights: [splits, 4d, d]
  float* part_dw1;      // kWeights: [splits, d, 4d]
};

// kHidden: A0 = xn, B0 = W1^T, A1 = g, B1 = W2 (all K-major, K = d).
// kDxn:    A0 = T(dhp), B0 = W1 (K-major, K = 4d).
// kWeights: A0 = h, B0 = g (dW2); A1 = xn, B1 = T(dhp) (dW1); MN-major,
//           K = the rows.
template <int MODE>
__global__ void __launch_bounds__(kGemmThreads, 1)
ffn_bwd_gemm_kernel(__grid_constant__ const CUtensorMap a0,
                    __grid_constant__ const CUtensorMap b0,
                    __grid_constant__ const CUtensorMap a1,
                    __grid_constant__ const CUtensorMap b1,
                    const GemmArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  __nv_bfloat16* outs =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStageBytes);
  float* red =
      reinterpret_cast<float*>(smem + kStages * kStageBytes + kOutBytes);
  const uint32_t full =
      base + kStages * kStageBytes + kOutBytes + 8 * kBN * 4;
  const uint32_t empty = full + kStages * 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work item -> output tile and k range.  Persistent blocks walk the
  // items with a grid stride; the ring's stage and phase run on across
  // items, so the producer loads the next tile while the consumers finish
  // this one.
  auto decode = [&](int item, int& m0, int& n0, int& k_begin, int& nk,
                    int& prob) {
    if (MODE == kWeights) {
      const int per_split = 2 * p.tiles0;
      int t = item % per_split;
      prob = t >= p.tiles0;
      if (prob) t -= p.tiles0;
      const int tn = prob ? p.tiles_n1 : p.tiles_n0;
      m0 = (t / tn) * kBM;
      n0 = (t % tn) * kBN;
      k_begin = (item / per_split) * p.k_split;
      nk = max(0, min(p.nk, (p.T - k_begin + kBK - 1) / kBK));
    } else {
      n0 = (item % p.tiles_n0) * kBN;
      m0 = (item / p.tiles_n0) * kBM;
      k_begin = 0;
      nk = p.nk;
      prob = 0;
    }
  };
  const int nk0 = MODE == kHidden ? p.d / kBK : p.nk;

  if (threadIdx.x >= kConsumers) {
    // Producer warp: one thread issues every load.
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      int m0, n0, k_begin, nk, prob;
      decode(item, m0, n0, k_begin, nk, prob);
      const CUtensorMap* ma = prob ? &a1 : &a0;
      const CUtensorMap* mb = prob ? &b1 : &b0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t fb = full + 8 * s;
        mbar_expect_tx(fb, kStageBytes);
        const uint32_t sa = base + s * kStageBytes, sb = sa + kTileBytes;
        if (MODE == kWeights) {
          const int k0 = k_begin + kt * kBK;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            tma_load(sa + b * (kTileBytes / 2), ma, fb, m0 + 64 * b, k0);
            tma_load(sb + b * (kTileBytes / 2), mb, fb, n0 + 64 * b, k0);
          }
        } else {
          const bool second = MODE == kHidden && kt >= nk0;
          const int k0 = (second ? kt - nk0 : kt) * kBK;
          tma_load(sa, second ? &a1 : ma, fb, k0, m0);
          tma_load(sb, second ? &b1 : mb, fb, k0, n0);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes rows [64 wg, 64 wg + 64) of the tile.
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5,
            lane = tid & 31;
  constexpr int kMn = MODE == kWeights ? 1 : 0;
  int it = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    int m0, n0, k_begin, nk, prob;
    decode(item, m0, n0, k_begin, nk, prob);
    float acc[64], acc2[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = acc2[i] = 0.f;
    fence_regs(acc);
    fence_regs(acc2);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t sa = base + s * kStageBytes, sb = sa + kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        // K-major: a k16 step is 32 bytes along the row; MN-major: two 8-k
        // groups of 1024 bytes.
        const uint32_t koff = kMn ? j * 2048 : j * 32;
        const uint64_t da = make_desc(sa + wg * (kTileBytes / 2) + koff,
                                      kMn ? kTileBytes / 2 : 16);
        const uint64_t db = make_desc(sb + koff, kMn ? kTileBytes / 2 : 16);
        if (MODE == kHidden && kt >= nk0)
          wgmma_m64n128k16<0, 0>(acc2, da, db);
        else
          wgmma_m64n128k16<kMn, kMn>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-step's products are done
      if (kt > 0 && (tid & 127) == 0)
        mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(acc2);
    if (nk > 0 && (tid & 127) == 0)
      mbar_arrive(empty + 8 * ((it - 1) % kStages));

    // Accumulator layout (m64nNk16, f32): register i holds row
    // 16 * warp + lane / 4 + 8 * ((i / 2) % 2) and column
    // 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the warpgroup's 64 rows.
    const int r_lo = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
    const int c_lo = n0 + 2 * (lane & 3);

    if (MODE == kHidden) {
      const int DH = 4 * p.d;
      // This warpgroup's h and dhp tiles in shared memory.
      __nv_bfloat16* hs = outs + wg * 2 * 64 * kLdo;
      __nv_bfloat16* ds = hs + 64 * kLdo;
      const int lr = 16 * (warp & 3) + (lane >> 2);  // local row
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c_lo + 8 * j;
        const float bb0 = p.b1[c], bb1 = p.b1[c + 1];
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r_lo + 8 * half;
          const int i = 4 * j + 2 * half;
          const float hp0 = acc[i] + bb0, hp1 = acc[i + 1] + bb1;
          const float g0 = hp0 > 0.f ? acc2[i] : 0.f;
          const float g1 = hp1 > 0.f ? acc2[i + 1] : 0.f;
          const int o = (lr + 8 * half) * kLdo + c - n0;
          *reinterpret_cast<__nv_bfloat162*>(hs + o) = __floats2bfloat162_rn(
              hp0 > 0.f ? hp0 : 0.f, hp1 > 0.f ? hp1 : 0.f);
          *reinterpret_cast<__nv_bfloat162*>(ds + o) =
              __floats2bfloat162_rn(g0, g1);
          if (r < p.T) {
            sum0 += g0;
            sum1 += g1;
          }
        }
        // Column sums over the warp's 16 rows, in a fixed order.
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
        }
        if (lane < 4) {
          red[warp * kBN + 8 * j + 2 * lane] = sum0;
          red[warp * kBN + 8 * j + 2 * lane + 1] = sum1;
        }
      }
      consumer_sync();
      if (tid < kBN) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += red[w * kBN + tid];
        p.part_db1[(size_t)(m0 / kBM) * DH + n0 + tid] = s;
      }
      // Whole rows out: 16 threads a row, 16 bytes each.
      const int t = tid & 127;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int lrow = 8 * q + t / 16, col = 8 * (t % 16);
        const int row = m0 + 64 * wg + lrow;
        if (row < p.T) {
          const size_t o = (size_t)row * DH + n0 + col;
          *reinterpret_cast<uint4*>(p.h + o) =
              *reinterpret_cast<const uint4*>(hs + lrow * kLdo + col);
          *reinterpret_cast<uint4*>(p.dhp + o) =
              *reinterpret_cast<const uint4*>(ds + lrow * kLdo + col);
        }
      }
      consumer_sync();  // red and the tiles are rewritten by the next item
      continue;
    }

    // kDxn: dxn rows [T, d]; kWeights: this split's partial [M, N] tile.
    float* out;
    int ldc, rows;
    if (MODE == kDxn) {
      out = p.c;
      ldc = p.d;
      rows = p.T;
    } else {
      const size_t sz = (size_t)p.d * 4 * p.d;
      out = (prob ? p.part_dw1 : p.part_dw2) + (k_begin / p.k_split) * sz;
      ldc = prob ? 4 * p.d : p.d;
      rows = prob ? p.d : 4 * p.d;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r_lo + 8 * half;
        const int i = 4 * j + 2 * half;
        if (r < rows)
          *reinterpret_cast<float2*>(out + (size_t)r * ldc + c_lo + 8 * j) =
              make_float2(acc[i], acc[i + 1]);
      }
    }
  }  // items
}

// ---- the CUDA-core passes (f32 rows) ----------------------------------------

constexpr int kFT = 128;            // tile rows and columns
constexpr int kFK = 16;             // k of a slab
constexpr int kFThreads = 256;
constexpr int kFLd = kFT + 4;       // a slab's rows in shared memory
constexpr int kFSlab = kFK * kFLd;  // floats of one operand slab

// 16-byte copy that reads `gmem` when `ok` and writes zeros otherwise.
__device__ __forceinline__ void cp_async16_or_zero(float* smem,
                                                   const float* gmem,
                                                   bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}

// acc += A[m0 : m0 + 128, kb : ke] @ B[kb : ke, n0 : n0 + 128] for the
// thread's 8 x 8 piece: acc[4 u + i][4 v + j] at row 4 ty + i + 64 u and
// column 4 tx + j + 64 v (ty = tid / 16, tx = tid % 16).
// A(m, k) = a[m * lda + k] (KMAJOR) or a[k * lda + m]; B(k, n) =
// b[k * ldb + n].  Rows m >= M (KMAJOR) and k >= ke read as zeros; a
// row-major A needs M to be whole tiles, a K-major one ke - kb a multiple
// of 4.  Both operands pass through shared memory k-major ([k][m], [k][n])
// in slabs of 16 k, double-buffered: B and a row-major A by cp.async,
// a K-major A by 16-byte loads into registers stored transposed; the next
// slab is in flight while this one's multiply-adds run, one barrier a
// slab.  Multiply-adds in order of k.
template <bool KMAJOR>
__device__ __forceinline__ void f32_gemm(const float* __restrict__ a,
                                         int lda,
                                         const float* __restrict__ b,
                                         int ldb, int m0, int n0, int kb,
                                         int ke, int M, float (&acc)[8][8],
                                         float* sm) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float* As = sm;               // [2][kFK][kFLd]
  float* Bs = sm + 2 * kFSlab;  // [2][kFK][kFLd]
  const int nk = (ke - kb + kFK - 1) / kFK;
  if (nk <= 0) return;
  float4 staged[2];
  auto load_async = [&](int kt, int buf) {
    const int k0 = kb + kt * kFK;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = tid + kFThreads * p, r = c >> 5, c4 = (c & 31) * 4;
      const bool ok = k0 + r < ke;
      cp_async16_or_zero(Bs + buf * kFSlab + r * kFLd + c4,
                         ok ? b + (size_t)(k0 + r) * ldb + n0 + c4 : b, ok);
      if (!KMAJOR)
        cp_async16_or_zero(As + buf * kFSlab + r * kFLd + c4,
                           ok ? a + (size_t)(k0 + r) * lda + m0 + c4 : a, ok);
    }
    gn::cp_async_commit();
  };
  auto load_regs = [&](int kt) {
    const int k0 = kb + kt * kFK;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = tid + kFThreads * p, r = c >> 2, k = k0 + (c & 3) * 4;
      staged[p] = m0 + r < M && k < ke
                      ? *reinterpret_cast<const float4*>(
                            a + (size_t)(m0 + r) * lda + k)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_regs = [&](int buf) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = tid + kFThreads * p;
      float* d = As + buf * kFSlab + (c & 3) * 4 * kFLd + (c >> 2);
      d[0] = staged[p].x;
      d[kFLd] = staged[p].y;
      d[2 * kFLd] = staged[p].z;
      d[3 * kFLd] = staged[p].w;
    }
  };

  load_async(0, 0);
  if (KMAJOR) {
    load_regs(0);
    store_regs(0);
  }
  gn::cp_async_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_async(kt + 1, cur ^ 1);
      if (KMAJOR) load_regs(kt + 1);
    }
    const float* as = As + cur * kFSlab + 4 * ty;
    const float* bs = Bs + cur * kFSlab + 4 * tx;
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kFLd);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kFLd + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kFLd);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kFLd + 64);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
    if (more) {
      if (KMAJOR) store_regs(cur ^ 1);
      gn::cp_async_wait<0>();
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero8x8(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

// Hidden pass, f32: a [128 rows, 128 hidden] tile a block (grid: hidden
// tiles x row tiles).  hp = xn @ W1 first: h = relu(hp + b1) goes out and
// the relu mask stays in 64 bits; then dh = g @ W2^T (W2^T [d, 4d] given):
// dhp = dh where hp > 0 goes out with the tile's column sums (for db1),
// added over the thread's rows, then over the 16 thread rows in order.
__global__ void __launch_bounds__(kFThreads, 2)
ffn_bwd_hidden_f32_kernel(const float* __restrict__ xn,
                          const float* __restrict__ g,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ w2t,
                          float* __restrict__ h, float* __restrict__ dhp,
                          float* __restrict__ part_db1, int T, int d) {
  __shared__ __align__(16) float sm[4 * kFSlab];
  __shared__ float red[16][kFT];
  const int DH = 4 * d, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * kFT, m0 = blockIdx.y * kFT;
  float acc[8][8];
  zero8x8(acc);
  f32_gemm<true>(xn, d, w1, DH, m0, n0, 0, d, T, acc, sm);
  unsigned long long pos = 0ull;  // bit 8 r + c: hp > 0
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + 4 * ty + (r & 3) + 64 * (r >> 2);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int col = n0 + 4 * tx + 64 * v;
      const float4 bb = *reinterpret_cast<const float4*>(b1 + col);
      const float bc[4] = {bb.x, bb.y, bb.z, bb.w};
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float hp = acc[r][4 * v + j] + bc[j];
        if (hp > 0.f) pos |= 1ull << (8 * r + 4 * v + j);
        o[j] = hp > 0.f ? hp : 0.f;
      }
      if (row < T)
        *reinterpret_cast<float4*>(h + (size_t)row * DH + col) =
            make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  zero8x8(acc);
  f32_gemm<true>(g, d, w2t, DH, m0, n0, 0, d, T, acc, sm);
  float sums[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) sums[c] = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + 4 * ty + (r & 3) + 64 * (r >> 2);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * v + j;
        o[j] = (pos >> (8 * r + c)) & 1ull ? acc[r][c] : 0.f;
        if (row < T) sums[c] += o[j];
      }
      if (row < T)
        *reinterpret_cast<float4*>(dhp + (size_t)row * DH + n0 + 4 * tx +
                                   64 * v) =
            make_float4(o[0], o[1], o[2], o[3]);
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) red[ty][4 * tx + (c & 3) + 64 * (c >> 2)] = sums[c];
  __syncthreads();
  if (tid < kFT) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) s += red[q][tid];
    part_db1[(size_t)blockIdx.y * DH + n0 + tid] = s;
  }
}

// dxn pass (WEIGHTS false: dxn [T, d] = dhp @ W1^T, W1^T [4d, d] given)
// or weight pass (WEIGHTS: blockIdx.x a tile of dW2 = h^T @ g [4d, d],
// then of dW1 = xn^T @ dhp [d, 4d]; blockIdx.y a range of k_split rows,
// whose partial goes to part_dw2 / part_dw1), f32.  One instance a pass,
// so that each keeps the registers of two blocks an SM.
template <bool WEIGHTS>
__global__ void __launch_bounds__(kFThreads, 2)
ffn_bwd_gemm_f32_kernel(const float* __restrict__ xn,
                        const float* __restrict__ g,
                        const float* __restrict__ w1t,
                        const float* __restrict__ h,
                        const float* __restrict__ dhp, float* __restrict__ dxn,
                        float* __restrict__ part_dw2,
                        float* __restrict__ part_dw1, int T, int d,
                        int k_split) {
  __shared__ __align__(16) float sm[4 * kFSlab];
  const int DH = 4 * d, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
  zero8x8(acc);
  float* out;
  int ldc, M;
  if constexpr (!WEIGHTS) {
    const int n0 = blockIdx.x * kFT, m0 = blockIdx.y * kFT;
    f32_gemm<true>(dhp, DH, w1t, d, m0, n0, 0, DH, T, acc, sm);
    out = dxn + (size_t)m0 * d + n0;
    ldc = d;
    M = T - m0;
  } else {
    const int tiles0 = (DH / kFT) * (d / kFT);
    int t = blockIdx.x;
    const int prob = t >= tiles0;
    if (prob) t -= tiles0;
    const int tn = prob ? DH / kFT : d / kFT;
    const int m0 = (t / tn) * kFT, n0 = (t % tn) * kFT;
    const int k0 = blockIdx.y * k_split, k1 = min(T, k0 + k_split);
    if (prob)  // dW1[d, 4d] = xn^T @ dhp
      f32_gemm<false>(xn, d, dhp, DH, m0, n0, k0, k1, d, acc, sm);
    else       // dW2[4d, d] = h^T @ g
      f32_gemm<false>(h, DH, g, d, m0, n0, k0, k1, DH, acc, sm);
    ldc = prob ? DH : d;
    out = (prob ? part_dw1 : part_dw2) + blockIdx.y * (size_t)d * DH +
          (size_t)m0 * ldc + n0;
    M = kFT;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int lr = 4 * ty + (r & 3) + 64 * (r >> 2);
    if (lr >= M) continue;
#pragma unroll
    for (int v = 0; v < 2; ++v)
      *reinterpret_cast<float4*>(out + (size_t)lr * ldc + 4 * tx + 64 * v) =
          make_float4(acc[r][4 * v], acc[r][4 * v + 1], acc[r][4 * v + 2],
                      acc[r][4 * v + 3]);
  }
}

// ---- the row passes (both row types) ----------------------------------------

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;

// xn = T(((x - mean) / s) * scale + bias) and the statistics (mean, s,
// sigma) of every row, one warp a row, the row read once into registers
// (kChunks = d / 128 chunks of 4 values a lane).
template <typename T, int kChunks>
__global__ void __launch_bounds__(kRowThreads)
ffn_bwd_prep_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ xn,
                    float* __restrict__ stats, int rows, int d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* xr = x + (size_t)r * d;
  float4 v[kChunks];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = 4 * lane + 128 * k;
    v[k] = c < d ? gn::load4(xr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  }
  const float mean = gn::warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (4 * lane + 128 * k >= d) continue;
    const float a = v[k].x - mean, b = v[k].y - mean, e = v[k].z - mean,
                f = v[k].w - mean;
    q += (a * a + b * b) + (e * e + f * f);
  }
  const float var = gn::warp_sum(q) / d;
  const float sd = var > 0.f ? sqrtf(var) : 0.f;
  const float sv = sd + gn::kLnEps;
  if (lane == 0) {
    stats[(size_t)r * 3] = mean;
    stats[(size_t)r * 3 + 1] = sv;
    stats[(size_t)r * 3 + 2] = var > 0.f ? sd : 1.f;
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = 4 * lane + 128 * k;
    if (c >= d) continue;
    const float4 sc = *reinterpret_cast<const float4*>(scale + c);
    const float4 bi = *reinterpret_cast<const float4*>(bias + c);
    gn::store4(xn + (size_t)r * d + c,
               make_float4(
                   __fadd_rn(__fmul_rn((v[k].x - mean) / sv, sc.x), bi.x),
                   __fadd_rn(__fmul_rn((v[k].y - mean) / sv, sc.y), bi.y),
                   __fadd_rn(__fmul_rn((v[k].z - mean) / sv, sc.z), bi.z),
                   __fadd_rn(__fmul_rn((v[k].w - mean) / sv, sc.w), bi.w)));
  }
}

// dx from dxn (the LN pullback plus the residual passthrough), one warp a
// row with the row's x, dxn and g in registers; each lane also adds the
// column sums of dxn * z, dxn and g over the warp's rows (rows
// blockIdx.x * 8 + warp, then a grid stride on), and the block's 8 warps'
// sums are added in warp order into one partial row of each.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kRowThreads)
ffn_bwd_post_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ dxn,
                    const float* __restrict__ stats,
                    const float* __restrict__ scale, T* __restrict__ dx,
                    float* __restrict__ part, int rows, int d) {
  __shared__ float red[kRowWarps][kChunks * 128];
  static_assert(kChunks >= 1 && kChunks <= 4, "d in 128 .. 512");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float4 sds[kChunks], sdb[kChunks], sg[kChunks];
  float4 sc[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    sds[k] = sdb[k] = sg[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int c = 4 * lane + 128 * k;
    sc[k] = c < d ? *reinterpret_cast<const float4*>(scale + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int r = blockIdx.x * kRowWarps + warp; r < rows;
       r += gridDim.x * kRowWarps) {
    const size_t o = (size_t)r * d;
    const float mean = stats[(size_t)r * 3], sv = stats[(size_t)r * 3 + 1],
                sigma = stats[(size_t)r * 3 + 2];
    float z[kChunks][4], dz[kChunks][4], dv[kChunks][4], gv[kChunks][4];
    float sdz = 0.f, sdzz = 0.f, sz = 0.f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = 4 * lane + 128 * k;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), dd = xv, gg = xv;
      if (c < d) {
        xv = gn::load4(x + o + c);
        dd = *reinterpret_cast<const float4*>(dxn + o + c);
        gg = gn::load4(g + o + c);
      }
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ss[4] = {sc[k].x, sc[k].y, sc[k].z, sc[k].w};
      dv[k][0] = dd.x; dv[k][1] = dd.y; dv[k][2] = dd.z; dv[k][3] = dd.w;
      gv[k][0] = gg.x; gv[k][1] = gg.y; gv[k][2] = gg.z; gv[k][3] = gg.w;
      if (c >= d) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        z[k][t] = (xs[t] - mean) / sv;
        dz[k][t] = dv[k][t] * ss[t];
        sdz += dz[k][t];
        sdzz += dz[k][t] * z[k][t];
        sz += z[k][t];
      }
    }
    const float mean_dz = gn::warp_sum(sdz) / d;
    const float mean_dzz = gn::warp_sum(sdzz) / d;
    const float mean_z = gn::warp_sum(sz) / d;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = 4 * lane + 128 * k;
      if (c >= d) continue;
      float out[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        out[t] = (dz[k][t] - mean_dz) / sv -
                 (z[k][t] - mean_z) * (mean_dzz / sigma) + gv[k][t];
      gn::store4(dx + o + c, make_float4(out[0], out[1], out[2], out[3]));
      sds[k].x += dv[k][0] * z[k][0]; sds[k].y += dv[k][1] * z[k][1];
      sds[k].z += dv[k][2] * z[k][2]; sds[k].w += dv[k][3] * z[k][3];
      sdb[k].x += dv[k][0]; sdb[k].y += dv[k][1];
      sdb[k].z += dv[k][2]; sdb[k].w += dv[k][3];
      sg[k].x += gv[k][0]; sg[k].y += gv[k][1];
      sg[k].z += gv[k][2]; sg[k].w += gv[k][3];
    }
  }
  // The warps' sums, added in warp order: dscale, dbias, then db2.
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const float4 v = q == 0 ? sds[k] : q == 1 ? sdb[k] : sg[k];
      *reinterpret_cast<float4*>(&red[warp][4 * lane + 128 * k]) = v;
    }
    __syncthreads();
    for (int c = tid; c < d; c += kRowThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) t += red[w][c];
      part[((size_t)q * gridDim.x + blockIdx.x) * d + c] = t;
    }
    __syncthreads();
  }
}

// out[i] = sum over p of part[p * n + i], in a fixed order: lane group j
// adds the partials p = j, j + 8, ... in turn, then the 8 sums are added in
// order of j.
__global__ void __launch_bounds__(kRowThreads)
reduce_partials_kernel(const float* __restrict__ part, int parts, int n,
                       float* __restrict__ out) {
  __shared__ float sums[kRowThreads / 32][32];
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (i < n)
    for (int p = j; p < parts; p += kRowThreads / 32)
      acc += part[(size_t)p * n + i];
  sums[j][lane] = acc;
  __syncthreads();
  if (j == 0 && i < n) {
    float t = sums[0][lane];
#pragma unroll
    for (int q = 1; q < kRowThreads / 32; ++q) t += sums[q][lane];
    out[i] = t;
  }
}

int reduce(const float* part, int parts, int n, float* out,
           cudaStream_t stream) {
  reduce_partials_kernel<<<(n + 31) / 32, kRowThreads, 0, stream>>>(
      part, parts, n, out);
  return cudaGetLastError();
}

// ---- host side -------------------------------------------------------------

template <int MODE>
int launch_gemm(const void* a0, int ra0, int ca0, const void* b0,
                int rb0, int cb0, const void* a1, int ra1, int ca1,
                const void* b1, int rb1, int cb1, const GemmArgs& args,
                cudaStream_t s) {
  // K-major operands load [128, 64] boxes; MN-major ones [64, 64] boxes.
  const int box = MODE == kWeights ? 64 : 128;
  CUtensorMap m[4];
  int e;
  if ((e = make_map(&m[0], a0, ra0, ca0, box)) != 0) return e;
  if ((e = make_map(&m[1], b0, rb0, cb0, box)) != 0) return e;
  if ((e = make_map(&m[2], a1 ? a1 : a0, a1 ? ra1 : ra0, a1 ? ca1 : ca0,
                    box)) != 0)
    return e;
  if ((e = make_map(&m[3], b1 ? b1 : b0, b1 ? rb1 : rb0, b1 ? cb1 : cb0,
                    box)) != 0)
    return e;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  // Persistent blocks: one an SM (the ring takes 133 KB), at most one an
  // item.
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  ffn_bwd_gemm_kernel<MODE>
      <<<min(args.items, sms), kGemmThreads, kGemmSmem, s>>>(
          m[0], m[1], m[2], m[3], args);
  return cudaGetLastError();
}

// The prep pass (post = false) or the post pass at width d.
template <typename T, int kChunks>
int row_pass_at(bool post, const void* x, const void* g, const void* scale,
                const void* bias, void* xn, void* stats, const void* dxn,
                void* dx, void* part, int rows, int d, int blocks,
                cudaStream_t s) {
  if (post)
    ffn_bwd_post_kernel<T, kChunks><<<blocks, kRowThreads, 0, s>>>(
        (const T*)x, (const T*)g, (const float*)dxn, (const float*)stats,
        (const float*)scale, (T*)dx, (float*)part, rows, d);
  else
    ffn_bwd_prep_kernel<T, kChunks>
        <<<(rows + kRowWarps - 1) / kRowWarps, kRowThreads, 0, s>>>(
            (const T*)x, (const float*)scale, (const float*)bias, (T*)xn,
            (float*)stats, rows, d);
  return cudaGetLastError();
}

template <typename T>
int row_pass(bool post, const void* x, const void* g, const void* scale,
             const void* bias, void* xn, void* stats, const void* dxn,
             void* dx, void* part, int rows, int d, int blocks,
             cudaStream_t s) {
#define GN_ROW_PASS(C)                                                    \
  row_pass_at<T, C>(post, x, g, scale, bias, xn, stats, dxn, dx, part, rows, \
                    d, blocks, s)
  switch (d / 128) {
    case 1: return GN_ROW_PASS(1);
    case 2: return GN_ROW_PASS(2);
    case 3: return GN_ROW_PASS(3);
    default: return GN_ROW_PASS(4);
  }
#undef GN_ROW_PASS
}

int launch_bf16(const void* x, const void* g, const void* scale,
                const void* bias, const void* w1, const void* w1t,
                const void* b1, const void* w2, void* dx, void* xn,
                void* stats, void* h, void* dhp, void* dxn, void* part_db1,
                void* part_rows, void* part_dw1, void* part_dw2, int T, int d,
                int post_blocks, int splits, int rows_per_split,
                cudaStream_t s) {
  const int DH = 4 * d;
  const int mt = (T + kBM - 1) / kBM;
  int e;
  if ((e = row_pass<__nv_bfloat16>(false, x, g, scale, bias, xn, stats,
                                   nullptr, nullptr, nullptr, T, d, 0, s)) != 0)
    return e;
  GemmArgs a = {};
  a.T = T;
  a.d = d;
  a.b1 = (const float*)b1;
  a.h = (__nv_bfloat16*)h;
  a.dhp = (__nv_bfloat16*)dhp;
  a.part_db1 = (float*)part_db1;
  a.c = (float*)dxn;
  a.part_dw1 = (float*)part_dw1;
  a.part_dw2 = (float*)part_dw2;
  // 1. hp and dh (K = d): xn @ (W1^T)^T and g @ W2^T.
  a.nk = 2 * d / kBK;
  a.tiles_n0 = DH / kBN;
  a.items = a.tiles_n0 * mt;
  if ((e = launch_gemm<kHidden>(xn, T, d, w1t, DH, d, g,
                                T, d, w2, DH, d, a, s)) != 0)
    return e;
  // 2. dxn = T(dhp) @ W1^T (K = 4d).
  a.nk = DH / kBK;
  a.tiles_n0 = d / kBN;
  a.items = a.tiles_n0 * mt;
  if ((e = launch_gemm<kDxn>(dhp, T, DH, w1, d, DH,
                             nullptr, 0, 0, nullptr, 0, 0, a, s)) != 0)
    return e;
  // 3. dx and the [d] sums.
  if ((e = row_pass<__nv_bfloat16>(true, x, g, scale, bias, xn, stats, dxn,
                                   dx, part_rows, T, d, post_blocks, s)) != 0)
    return e;
  // 4. dW2 = h^T @ g and dW1 = xn^T @ T(dhp), split over row ranges.
  a.nk = rows_per_split / kBK;
  a.k_split = rows_per_split;
  a.tiles_n0 = d / kBN;
  a.tiles_n1 = DH / kBN;
  a.tiles0 = (DH / kBM) * a.tiles_n0;
  a.items = 2 * a.tiles0 * splits;
  return launch_gemm<kWeights>(h, T, DH, g, T, d,
                               xn, T, d, dhp, T, DH, a, s);
}

int launch_f32(const void* x, const void* g, const void* scale,
               const void* bias, const void* w1, const void* w1t,
               const void* w2t, const void* b1, void* dx, void* xn,
               void* stats, void* h, void* dhp, void* dxn, void* part_db1,
               void* part_rows, void* part_dw1, void* part_dw2, int T, int d,
               int post_blocks, int splits, int rows_per_split,
               cudaStream_t s) {
  const int DH = 4 * d;
  const int mt = (T + kFT - 1) / kFT;
  int e;
  if ((e = row_pass<float>(false, x, g, scale, bias, xn, stats, nullptr,
                           nullptr, nullptr, T, d, 0, s)) != 0)
    return e;
  ffn_bwd_hidden_f32_kernel<<<dim3(DH / kFT, mt), kFThreads, 0, s>>>(
      (const float*)xn, (const float*)g, (const float*)w1, (const float*)b1,
      (const float*)w2t, (float*)h, (float*)dhp, (float*)part_db1, T, d);
  if ((e = cudaGetLastError()) != 0) return e;
  ffn_bwd_gemm_f32_kernel<false><<<dim3(d / kFT, mt), kFThreads, 0, s>>>(
      (const float*)xn, (const float*)g, (const float*)w1t, (const float*)h,
      (const float*)dhp, (float*)dxn, nullptr, nullptr, T, d, 0);
  if ((e = cudaGetLastError()) != 0) return e;
  if ((e = row_pass<float>(true, x, g, scale, bias, xn, stats, dxn, dx,
                           part_rows, T, d, post_blocks, s)) != 0)
    return e;
  const int tiles = 2 * (DH / kFT) * (d / kFT);
  ffn_bwd_gemm_f32_kernel<true><<<dim3(tiles, splits), kFThreads, 0, s>>>(
      (const float*)xn, (const float*)g, (const float*)w1t, (const float*)h,
      (const float*)dhp, nullptr, (float*)part_dw2, (float*)part_dw1, T, d,
      rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// Rows of a hidden-pass tile (the db1 partials are one row a tile).
extern "C" int gn_ln_ffn_backward_tile_rows(int is_f32) {
  return is_f32 ? kFT : kBM;
}

// Runs the passes on `stream` and returns the first launch error.
// Outputs: dx [T, d] of the rows' type; ds, db, db2 [d], dw1 [d, 4d],
// db1 [4d], dw2 [4d, d] in f32.  Scratch, allocated by the Python wrapper:
// xn [T, d] of the rows' type, stats [T, 3] f32, h and dhp [T, 4d] of the
// rows' type, dxn [T, d] f32, part_db1 [ceil(T / tile_rows), 4d],
// part_rows [3, post_blocks, d], part_dw1 [splits, d, 4d], part_dw2
// [splits, 4d, d], all f32.  w1t is W1^T [4d, d]; w2t is W2^T [d, 4d]
// (f32 rows only; null for bf16).
// Preconditions, checked there: x, g [T, d], w1 [d, 4d], w2 [4d, d] of the
// rows' type (bf16, or f32 with is_f32 = 1); f32 scale, bias [d] and
// b1 [4d]; contiguous and 16-byte aligned; T >= 1; d in {128, 256, 384,
// 512}; splits = ceil(T / rows_per_split), rows_per_split % 64 == 0.
extern "C" int gn_ln_ffn_backward(
    const void* x, const void* g, const void* scale, const void* bias,
    const void* w1, const void* w1t, const void* w2t, const void* b1,
    const void* w2, void* dx, void* ds, void* db, void* dw1, void* db1,
    void* dw2, void* db2, void* xn, void* stats, void* h, void* dhp,
    void* dxn, void* part_db1, void* part_rows, void* part_dw1,
    void* part_dw2, int T, int d, int is_f32, int post_blocks, int splits,
    int rows_per_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d % 128 || d > 512 || T < 1 || rows_per_split % 64)
    return cudaErrorInvalidValue;
  const int DH = 4 * d;
  int e = is_f32 ? launch_f32(x, g, scale, bias, w1, w1t, w2t, b1, dx, xn,
                              stats, h, dhp, dxn, part_db1, part_rows,
                              part_dw1, part_dw2, T, d, post_blocks, splits,
                              rows_per_split, s)
                 : launch_bf16(x, g, scale, bias, w1, w1t, b1, w2, dx, xn,
                               stats, h, dhp, dxn, part_db1, part_rows,
                               part_dw1, part_dw2, T, d, post_blocks, splits,
                               rows_per_split, s);
  if (e != 0) return e;
  const int mt = (T + gn_ln_ffn_backward_tile_rows(is_f32) - 1) /
                 gn_ln_ffn_backward_tile_rows(is_f32);
  const float* pr = (const float*)part_rows;
  if ((e = reduce(pr, post_blocks, d, (float*)ds, s)) != 0) return e;
  if ((e = reduce(pr + (size_t)post_blocks * d, post_blocks, d, (float*)db,
                  s)) != 0)
    return e;
  if ((e = reduce(pr + (size_t)2 * post_blocks * d, post_blocks, d,
                  (float*)db2, s)) != 0)
    return e;
  if ((e = reduce((const float*)part_db1, mt, DH, (float*)db1, s)) != 0)
    return e;
  if ((e = reduce((const float*)part_dw1, splits, d * DH, (float*)dw1, s)) != 0)
    return e;
  return reduce((const float*)part_dw2, splits, DH * d, (float*)dw2, s);
}
