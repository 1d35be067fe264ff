// Fused edge update with the edge->node sum, for uniform slot layouts.
//
// Replaces the Pallas kernel `fused_edge_update_agg`
// (graphnets_tpu/ops/pallas/edge_update.py, `_kernel` and `_forward`):
//
//   h[e]   = bf16( f32(bf16(LN(ef[e])) @ W0) + ts[s[e]] + tr[r[e]]
//                  + tg[e / e_slots] + b )
//   agg[n] = f32 sum of the ROUNDED h[e] over the edges with r[e] == n
//
// What bounds it on the H100: at the main-path shape (E = 16384,
// de = dout = 384, N = 1024) it moves ~30 MB (read ef, write h, read the
// f32 partial tables, write agg) for 4.8 GFLOP, so the bound is the
// memory: ~9 us at 3.35 TB/s against ~5 us of bf16 tensor-core work.
//
// What the design does about it: every input row is read from device
// memory once per output column tile and h is written once; the LN'd row,
// the f32 product and the rounded h stay in shared memory.  The TPU
// kernel's one-hot MXU gathers and hi/lo bf16 split are gone: the f32
// partial rows ts[s], tr[r], tg[g] are read directly with 16-byte loads
// (a graph's node window, 128 x 384 x 4 B, sits in L2).  The edge->node
// sum needs no atomics: receivers are ascending, so a block owns a range
// of whole receiver segments (its edge range comes from a binary search),
// walks its edges in order and writes each agg row once, zero rows
// included.  The result is deterministic.  The product runs on the tensor
// cores through WMMA (bf16 in, f32 accumulate); a TMA/wgmma pipeline is
// later work.
//
// The W0 tile and each chunk of edge rows arrive by cp.async (many 16-byte
// copies in flight per thread, not a chain of dependent loads).
//
// Block: 256 threads, `nodes_per_block` receivers x 128 output columns.
// Shared memory: the W0 column tile [de x 128] bf16 (resident for the
// block), one chunk of 64 LN'd edge rows [64 x de] bf16, the f32 result
// chunk [64 x 128] and the chunk's sender/receiver ids.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kChunk = 64;   // edge rows per product step
constexpr int kCols = 128;   // output columns per block
constexpr int kThreads = 256;
constexpr int kLdw = kCols + 8;
constexpr int kLdc = kCols + 4;

__device__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
edge_update_agg_kernel(const __nv_bfloat16* __restrict__ ef,
                       const __nv_bfloat16* __restrict__ w0,
                       const float* __restrict__ ts,
                       const float* __restrict__ tr,
                       const float* __restrict__ tg,
                       const float* __restrict__ b,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const int* __restrict__ senders,
                       const int* __restrict__ receivers,
                       __nv_bfloat16* __restrict__ h,
                       float* __restrict__ agg,
                       int E, int N, int de, int dout, int e_slots,
                       int nodes_per_block, int use_ln) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = de + 8;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* As = Ws + de * kLdw;
  float* Cs = reinterpret_cast<float*>(As + kChunk * lda);
  int* snd = reinterpret_cast<int*>(Cs + kChunk * kLdc);
  int* rcv = snd + kChunk;
  int* bounds = rcv + kChunk;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * nodes_per_block;
  const int n1 = min(N, n0 + nodes_per_block);
  const int c0 = blockIdx.y * kCols;

  // The W0 tile streams in (cp.async) while two threads binary-search the
  // block's edge range.
  for (int i = tid; i < de * (kCols / 8); i += kThreads) {
    const int k = i / (kCols / 8), v = i % (kCols / 8);
    gn::cp_async16(Ws + k * kLdw + v * 8, w0 + (size_t)k * dout + c0 + v * 8);
  }
  gn::cp_async_commit();
  if (tid == 0) bounds[0] = lower_bound(receivers, E, n0);
  if (tid == 1) bounds[1] = lower_bound(receivers, E, n1);
  gn::cp_async_wait<0>();
  __syncthreads();
  const int e0 = bounds[0], e1 = bounds[1];

  // Column owner state for the edge->node sum (threads < kCols).
  int cur = n0;
  float run = 0.f;
  const int rb = warp & 3, ch = warp >> 2;  // 16-row block, 64-col half

  for (int ce = e0; ce < e1; ce += kChunk) {
    const int rows = min(kChunk, e1 - ce);
    if (tid < kChunk) {
      snd[tid] = tid < rows ? senders[ce + tid] : 0;
      rcv[tid] = tid < rows ? receivers[ce + tid] : 0;
    }
    gn::cp_async_rows(As, lda, ef + (size_t)ce * de, rows, de, tid,
                      kThreads);
    gn::cp_async_commit();
    for (int i = rows * de + tid; i < kChunk * de; i += kThreads)
      As[(i / de) * lda + i % de] = __float2bfloat16_rn(0.f);
    gn::cp_async_wait<0>();
    __syncthreads();
    if (use_ln) {
      for (int r = warp; r < rows; r += kThreads / 32)
        gn::ln_row_inplace(As + r * lda, de, scale, bias, lane);
      __syncthreads();
    }

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k = 0; k < de; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + rb * 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Ws + k * kLdw + ch * 64 + j * 16, kLdw);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + rb * 16 * kLdc + ch * 64 + j * 16, acc[j],
                              kLdc, wmma::mem_row_major);
    __syncthreads();

    // Epilogue: add the gathered f32 partials in the TPU kernel's order,
    // round once, write h, and keep the rounded value for the sum.
#pragma unroll
    for (int it = 0; it < kChunk * (kCols / 4) / kThreads; ++it) {
      const int i = it * kThreads + tid;
      const int r = i / (kCols / 4), q = i % (kCols / 4);
      if (r >= rows) break;
      const int e = ce + r, c = c0 + q * 4;
      float4 a = *reinterpret_cast<float4*>(Cs + r * kLdc + q * 4);
      const float4 vs = *reinterpret_cast<const float4*>(ts + (size_t)snd[r] * dout + c);
      const float4 vr = *reinterpret_cast<const float4*>(tr + (size_t)rcv[r] * dout + c);
      const float4 vg = *reinterpret_cast<const float4*>(tg + (size_t)(e / e_slots) * dout + c);
      const float4 vb = *reinterpret_cast<const float4*>(b + c);
      a.x = (((a.x + vs.x) + vr.x) + vg.x) + vb.x;
      a.y = (((a.y + vs.y) + vr.y) + vg.y) + vb.y;
      a.z = (((a.z + vs.z) + vr.z) + vg.z) + vb.z;
      a.w = (((a.w + vs.w) + vr.w) + vg.w) + vb.w;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z, a.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(h + (size_t)e * dout + c) = packed;
      const float2 flo = __bfloat1622float2(lo), fhi = __bfloat1622float2(hi);
      *reinterpret_cast<float4*>(Cs + r * kLdc + q * 4) =
          make_float4(flo.x, flo.y, fhi.x, fhi.y);
    }
    __syncthreads();

    // Edge->node sum: thread t owns column c0 + t and walks the chunk's
    // edges in order; a finished segment is written once, and receivers
    // with no edges get a zero row.
    if (tid < kCols) {
      for (int r = 0; r < rows; ++r) {
        const int node = rcv[r];
        if (node != cur) {
          agg[(size_t)cur * dout + c0 + tid] = run;
          for (int n = cur + 1; n < node; ++n)
            agg[(size_t)n * dout + c0 + tid] = 0.f;
          cur = node;
          run = 0.f;
        }
        run += Cs[r * kLdc + tid];
      }
    }
    __syncthreads();
  }
  if (tid < kCols && n0 < n1) {
    agg[(size_t)cur * dout + c0 + tid] = run;
    for (int n = cur + 1; n < n1; ++n) agg[(size_t)n * dout + c0 + tid] = 0.f;
  }
}

}  // namespace

extern "C" size_t gn_edge_update_agg_smem(int de) {
  return (size_t)de * kLdw * 2 + (size_t)kChunk * (de + 8) * 2 +
         (size_t)kChunk * kLdc * 4 + (2 * kChunk + 2) * sizeof(int);
}

// Launches the kernel on `stream` and returns cudaGetLastError().
// Preconditions, checked by the Python wrapper: bf16 ef/w0, f32 partials,
// scale, bias and b, int32 ids with ascending receivers, de % 128 == 0,
// dout % 128 == 0, contiguous row-major tensors.
extern "C" int gn_edge_update_agg(const void* ef, const void* w0,
                                  const void* ts, const void* tr,
                                  const void* tg, const void* b,
                                  const void* scale, const void* bias,
                                  const void* senders, const void* receivers,
                                  void* h, void* agg, int E, int N, int de,
                                  int dout, int e_slots, int nodes_per_block,
                                  int use_ln, void* stream) {
  const size_t smem = gn_edge_update_agg_smem(de);
  cudaError_t err = cudaFuncSetAttribute(
      edge_update_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + nodes_per_block - 1) / nodes_per_block, dout / kCols);
  edge_update_agg_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)ef, (const __nv_bfloat16*)w0, (const float*)ts,
      (const float*)tr, (const float*)tg, (const float*)b,
      (const float*)scale, (const float*)bias, (const int*)senders,
      (const int*)receivers, (__nv_bfloat16*)h, (float*)agg, E, N, de, dout,
      e_slots, nodes_per_block, use_ln);
  return cudaGetLastError();
}
