// A register-blocked f32 tile on the CUDA cores, for the f32 rows of the
// LN->matmul backward (ln_linear_bwd.cu) and of the single-graph edge
// update (edge_update_g1.cu).
//
// What bounds those rows on the H100 is f32 multiply-adds (67 TFLOP/s
// outside the tensor cores; never TF32), and what keeps a kernel from that
// rate is the shared-memory load in front of each multiply-add.  Here a
// block of 256 threads (16 x 16) holds a [16 RY x 16 CW] tile of the
// product in registers, RY x CW values a thread: register row r is tile
// row RY ty + r (4 ty + (r & 3) + 64 (r >> 2) for RY = 8), register column
// c is tile column 4 tx + (c & 3) + 64 (c >> 2), ty = tid / 16, tx = tid %
// 16.  Both operands pass through shared memory k-major ([k][m], [k][n]),
// so one k step reads RY / 4 float4 of A and CW / 4 float4 of B for RY x
// CW multiply-adds (16 at 8 x 8 and 4 x 16, 21 at 8 x 16); the 16 lanes of
// a half-warp read 16 neighbouring float4 of B (two wavefronts, no bank
// conflict) and a broadcast of A.  k runs in slabs of 16 through a double
// buffer: B, and an A stored k-major in device memory, by 16-byte cp.async
// copies; an A stored row-major (the rows of x, g or ef) by 16-byte loads
// into registers, stored transposed after the slab's multiply-adds, so the
// next slab is in flight while this one multiplies; one barrier a slab.
// The A rows may be transformed on their way into shared memory (the
// edge update normalises ef there).  Multiply-adds run in order of k, so
// a relaunch is bit-equal.
#pragma once

#include "common.cuh"

namespace gn {
namespace f32t {

constexpr int kThreads = 256;
constexpr int kK = 16;  // k of a slab

// 16-byte copy that reads `gmem` when `ok` and writes zeros otherwise.
__device__ __forceinline__ void cp_async16_or_zero(float* smem,
                                                   const float* gmem,
                                                   bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}

// The A rows as they are.
struct Plain {
  __device__ __forceinline__ float4 operator()(float4 v, int, int) const {
    return v;
  }
};

template <int RY, int CW>
struct Tile {
  static_assert(RY == 1 || RY == 2 || RY == 4 || RY == 8, "rows a thread");
  static_assert(CW % 4 == 0 && CW >= 4, "columns a thread, in float4");
  static constexpr int kRows = 16 * RY;
  static constexpr int kCols = 16 * CW;
  static constexpr int kLdA = kRows + 4;
  static constexpr int kLdB = kCols + 4;
  static constexpr int kSlabA = kK * kLdA;
  static constexpr int kSlabB = kK * kLdB;
  static constexpr int kFloats = 2 * (kSlabA + kSlabB);  // both buffers

  __device__ static __forceinline__ int row(int ty, int r) {
    return RY == 8 ? 4 * ty + (r & 3) + 64 * (r >> 2) : RY * ty + r;
  }

  __device__ static __forceinline__ void zero(float (&acc)[RY][CW]) {
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;
  }

  // acc += A[m0 : m0 + kRows, kb : ke] @ B[kb : ke, n0 : n0 + kCols].
  // kKMajorA false: A(m, k) = a[m * lda + k], rows m >= M read as zeros and
  // xf(v, m - m0, k) applied to the float4 of k .. k + 3 of each real row
  // (ke - kb a multiple of 4).  kKMajorA true: A(m, k) = a[k * lda + m], m0
  // + kRows <= M.  B(k, n) = b[k * ldb + n].  k >= ke reads as zeros.
  // `sm`: kFloats floats, 16-byte aligned.  Ends with a barrier, after
  // which `sm` is free.
  template <bool kKMajorA, typename Xf>
  __device__ static __forceinline__ void mma(
      const float* __restrict__ a, int lda, const float* __restrict__ b,
      int ldb, int m0, int n0, int kb, int ke, int M, float (&acc)[RY][CW],
      float* sm, const Xf& xf) {
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    float* As = sm;               // [2][kK][kLdA]
    float* Bs = sm + 2 * kSlabA;  // [2][kK][kLdB]
    const int nk = (ke - kb + kK - 1) / kK;
    if (nk <= 0) return;
    constexpr int kAV = kRows * kK / 4;  // float4 of an A slab
    constexpr int kAP = (kAV + kThreads - 1) / kThreads;
    constexpr int kBP = kK * kCols / 4 / kThreads;  // CW / 4
    float4 staged[kAP];
    auto load_async = [&](int kt, int buf) {
      const int k0 = kb + kt * kK;
#pragma unroll
      for (int p = 0; p < kBP; ++p) {
        const int c = tid + kThreads * p;
        const int r = c / (kCols / 4), c4 = (c % (kCols / 4)) * 4;
        const bool ok = k0 + r < ke;
        cp_async16_or_zero(Bs + buf * kSlabB + r * kLdB + c4,
                           ok ? b + (size_t)(k0 + r) * ldb + n0 + c4 : b, ok);
      }
      if constexpr (kKMajorA) {
#pragma unroll
        for (int p = 0; p < kAP; ++p) {
          const int c = tid + kThreads * p;
          if (kAV % kThreads == 0 || c < kAV) {
            const int r = c / (kRows / 4), c4 = (c % (kRows / 4)) * 4;
            const bool ok = k0 + r < ke;
            cp_async16_or_zero(
                As + buf * kSlabA + r * kLdA + c4,
                ok ? a + (size_t)(k0 + r) * lda + m0 + c4 : a, ok);
          }
        }
      }
      gn::cp_async_commit();
    };
    // Row-major A: float4 p of a slab is row c / 4, k (c % 4) * 4.
    auto load_regs = [&](int kt) {
      const int k0 = kb + kt * kK;
#pragma unroll
      for (int p = 0; p < kAP; ++p) {
        const int c = tid + kThreads * p, r = c >> 2, k = k0 + (c & 3) * 4;
        const bool ok = (kAV % kThreads == 0 || c < kAV) && m0 + r < M &&
                        k < ke;
        staged[p] = ok ? *reinterpret_cast<const float4*>(
                             a + (size_t)(m0 + r) * lda + k)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    auto store_regs = [&](int kt, int buf) {
      const int k0 = kb + kt * kK;
#pragma unroll
      for (int p = 0; p < kAP; ++p) {
        const int c = tid + kThreads * p;
        if (kAV % kThreads == 0 || c < kAV) {
          const int r = c >> 2, kq = (c & 3) * 4;
          float4 v = staged[p];
          if (m0 + r < M && k0 + kq < ke) v = xf(v, r, k0 + kq);
          float* d = As + buf * kSlabA + kq * kLdA + r;
          d[0] = v.x;
          d[kLdA] = v.y;
          d[2 * kLdA] = v.z;
          d[3 * kLdA] = v.w;
        }
      }
    };

    load_async(0, 0);
    if constexpr (!kKMajorA) {
      load_regs(0);
      store_regs(0, 0);
    }
    gn::cp_async_wait<0>();
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < nk;
      if (more) {
        load_async(kt + 1, cur ^ 1);
        if constexpr (!kKMajorA) load_regs(kt + 1);
      }
      const float* as = As + cur * kSlabA;
      const float* bs = Bs + cur * kSlabB + 4 * tx;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        float ar[RY], br[CW];
        const float* ak = as + k * kLdA;
        if constexpr (RY == 8) {
          const float4 a0 = *reinterpret_cast<const float4*>(ak + 4 * ty);
          const float4 a1 =
              *reinterpret_cast<const float4*>(ak + 4 * ty + 64);
          ar[0] = a0.x; ar[1] = a0.y; ar[2] = a0.z; ar[3] = a0.w;
          ar[4] = a1.x; ar[5] = a1.y; ar[6] = a1.z; ar[7] = a1.w;
        } else if constexpr (RY == 4) {
          const float4 a0 = *reinterpret_cast<const float4*>(ak + 4 * ty);
          ar[0] = a0.x; ar[1] = a0.y; ar[2] = a0.z; ar[3] = a0.w;
        } else if constexpr (RY == 2) {
          const float2 a0 = *reinterpret_cast<const float2*>(ak + 2 * ty);
          ar[0] = a0.x; ar[1] = a0.y;
        } else {
          ar[0] = ak[ty];
        }
#pragma unroll
        for (int v = 0; v < CW / 4; ++v) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(bs + k * kLdB + 64 * v);
          br[4 * v] = b4.x;
          br[4 * v + 1] = b4.y;
          br[4 * v + 2] = b4.z;
          br[4 * v + 3] = b4.w;
        }
#pragma unroll
        for (int r = 0; r < RY; ++r)
#pragma unroll
          for (int c = 0; c < CW; ++c)
            acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
      }
      if (more) {
        if constexpr (!kKMajorA) store_regs(kt + 1, cur ^ 1);
        gn::cp_async_wait<0>();
      }
      __syncthreads();
    }
  }
};

}  // namespace f32t
}  // namespace gn
