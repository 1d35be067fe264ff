// AdamW / Adam update of many f32 tensors in one launch.
//
// Replaces no TPU kernel: the JAX package leaves `optax.adamw` to XLA,
// which fuses the whole update of every parameter into a few loops.  In
// the port, torch's capturable foreach AdamW made ~9 passes over device
// memory a parameter and, dividing lists of matrices by lists of 0-d
// tensors, one kernel a tensor for two of them: 163 graph nodes a step of
// the sort recipe's 72 tensors, ~0.45 us of gap before each.
//
// What bounds it on the H100: bytes.  Each value reads p, g, m, v and
// writes p, m, v, 28 bytes (24 where the gradient is zero and not read):
// 297 MB for the sort model's 10.6 M values, ~89 us at 3.35 TB/s.
//
// What the design does about it: one grid over the concatenated values of
// every tensor in the table, each block a fixed 1024 units of one tensor
// (a unit is 16 bytes of each array where the tensor's four addresses
// agree modulo 16, else one value), so a large matrix and a 2-value bias
// share one launch with blocks balanced by element count.  A thread loads
// its four units of each array before it computes, and every value is
// read once and written once.  A tensor's misaligned head and tail (at
// most three values each) go to its first block's first threads.  A
// tensor of 0 values has no block.
//
// The arithmetic is torch's capturable foreach AdamW (decoupled decay),
// op for op in f32: p *= 1 - lr wd; m = lerp(m, g, 1 - b1);
// v = b2 v + (1 - b2) g g; p += m / ((sqrt(v) / sqrt(1 - b2^t) + eps) /
// (lr / (b1^t - 1))), with t the step count after its increment.
//
// Step counts: the wrapper advances every tensor's count (one foreach add
// before the launch, as torch's capturable path does), and each block
// reads its tensor's advanced count.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;
constexpr int kUnitsPerBlock = kThreads * kUnitsPerThread;
constexpr int kMaxTensors = 80;

// Passed by value: a CUDA-graph capture keeps the table it was given.
// Kernel arguments are limited to 4 KB, so the wrapper splits a longer
// list of tensors over launches (ops/kernels/adamw.py mirrors the layout).
struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];  // nullptr: a zero gradient
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  float* step[kMaxTensors];
  int numel[kMaxTensors];
  int block_start[kMaxTensors + 1];
  // Values before the 16-byte body; -1: no body (one value a unit).
  signed char head[kMaxTensors];
  int n;
  const float* lr_ptr;  // the rate as a 0-d tensor, or nullptr: lr
  float lr, decay, beta1, beta2, one_minus_beta1, one_minus_beta2, eps, wd;
};
static_assert(sizeof(Table) <= 4096, "kernel arguments are limited to 4 KB");

struct Coef {
  float decay, w1, beta2, w2, bc2_sqrt, eps, step_size;
};

// torch's lerp (ATen/native/Lerp.h).
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return fabsf(w) < 0.5f ? a + w * (b - a) : b - (b - a) * (1.0f - w);
}

// torch's passes one by one: where torch rounds between two of its
// kernels (p * decay, then p + m / den; v * b2, then the addcmul) the
// product is rounded here too, not contracted into one fma.
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Coef& c) {
  p = __fmul_rn(p, c.decay);
  m = lerp(m, g, c.w1);
  v = __fmul_rn(v, c.beta2);
  v = v + c.w2 * (g * g);
  float den = sqrtf(v) / c.bc2_sqrt;
  den = den + c.eps;
  den = den / c.step_size;
  p = p + m / den;
}

__device__ __forceinline__ void update4(float4& p, float4 g, float4& m,
                                        float4& v, const Coef& c) {
  update(p.x, g.x, m.x, v.x, c);
  update(p.y, g.y, m.y, v.y, c);
  update(p.z, g.z, m.z, v.z, c);
  update(p.w, g.w, m.w, v.w, c);
}

__device__ __forceinline__ void update_at(const Table& t, int i, long long e,
                                          const Coef& c) {
  float p = t.p[i][e], m = t.m[i][e], v = t.v[i][e];
  update(p, t.g[i] ? t.g[i][e] : 0.0f, m, v, c);
  t.p[i][e] = p;
  t.m[i][e] = m;
  t.v[i][e] = v;
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Table t) {
  // This block's tensor: the last i with block_start[i] <= blockIdx.x.
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const int i = lo;

  // The bias corrections from the advanced count, in f32 as torch's.
  const float count = *t.step[i];
  const float lr = t.lr_ptr ? *t.lr_ptr : t.lr;
  Coef c;
  c.decay = t.lr_ptr ? __fsub_rn(1.0f, __fmul_rn(lr, t.wd)) : t.decay;
  c.w1 = t.one_minus_beta1;
  c.beta2 = t.beta2;
  c.w2 = t.one_minus_beta2;
  c.bc2_sqrt = sqrtf(-(powf(t.beta2, count) - 1.0f));
  c.eps = t.eps;
  c.step_size = 1.0f / ((powf(t.beta1, count) - 1.0f) / lr);

  const int n = t.numel[i];
  const int block = blockIdx.x - t.block_start[i];
  const int head = t.head[i];
  const long long u0 = (long long)block * kUnitsPerBlock + threadIdx.x;
  if (head < 0) {
#pragma unroll
    for (int k = 0; k < kUnitsPerThread; ++k) {
      const long long e = u0 + k * kThreads;
      if (e < n) update_at(t, i, e, c);
    }
    return;
  }

  const long long units = (n - head) / 4;
  if (block == 0 && threadIdx.x < 8) {
    // The scalar head [0, head) and tail [head + 4 units, n).
    const long long e = threadIdx.x < 4 ? threadIdx.x
                                        : head + 4 * units + threadIdx.x - 4;
    if ((threadIdx.x < 4 && e < head) || (threadIdx.x >= 4 && e < n))
      update_at(t, i, e, c);
  }
  float4* p4 = reinterpret_cast<float4*>(t.p[i] + head);
  const float4* g4 =
      t.g[i] ? reinterpret_cast<const float4*>(t.g[i] + head) : nullptr;
  float4* m4 = reinterpret_cast<float4*>(t.m[i] + head);
  float4* v4 = reinterpret_cast<float4*>(t.v[i] + head);
  float4 p[kUnitsPerThread], g[kUnitsPerThread], m[kUnitsPerThread],
      v[kUnitsPerThread];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kUnitsPerThread; ++k) {
    const long long u = u0 + k * kThreads;
    if (u < units) {
      p[k] = p4[u];
      g[k] = g4 ? __ldcs(g4 + u) : zero;
      m[k] = m4[u];
      v[k] = v4[u];
    }
  }
#pragma unroll
  for (int k = 0; k < kUnitsPerThread; ++k) {
    const long long u = u0 + k * kThreads;
    if (u < units) {
      update4(p[k], g[k], m[k], v[k], c);
      p4[u] = p[k];
      m4[u] = m[k];
      v4[u] = v[k];
    }
  }
}

}  // namespace

extern "C" int gn_adamw_table_bytes() { return (int)sizeof(Table); }
extern "C" int gn_adamw_max_tensors() { return kMaxTensors; }
extern "C" int gn_adamw_units_per_block() { return kUnitsPerBlock; }

// Launches the kernel on `stream` over `blocks` blocks (the table's
// block_start[n]) and returns cudaGetLastError().  Preconditions, checked
// by the Python wrapper: 1 <= n <= kMaxTensors; every array f32 and
// contiguous on one device, p, g, m, v of each tensor of numel values
// (numel < 2^31); head and block_start as the wrapper's plan makes them;
// every step count already advanced.
extern "C" int gn_adamw(const void* table, int blocks, void* stream) {
  adamw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      *static_cast<const Table*>(table));
  return cudaGetLastError();
}
