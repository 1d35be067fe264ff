// Sorted row gather: out[e] = table[idx[e]], zeros for ids outside
// [0, N); and its fused form out[e] = table[idx[e]] + addend[e].
//
// Replaces the Pallas kernel of `sorted_gather` and `sorted_gather_add`
// (graphnets_tpu/ops/pallas/gather.py, `_kernel` and `_forward`; the second
// starts the tile's accumulator from the addend block).  The TPU
// kernel walked each output tile's table window and gathered with one-hot
// matmuls on the MXU (exact: one product per value).  Here the gather is a
// copy: no arithmetic, so the output is bit-equal to the table rows.
//
// What bounds it on the H100: at the main-path shape (table [1024, 384]
// bf16, 16384 ids) it reads 0.8 MB of table and 64 KB of ids and writes
// 12.6 MB, ~4.0 us at 3.35 TB/s.  Each thread copies 16 bytes; neighbouring
// threads copy neighbouring 16-byte pieces of one row, so loads and stores
// are coalesced.  The ids ascend, so consecutive output rows read the same
// or neighbouring table rows, which stay in L2.
//
// The fused form adds in f32 and rounds once to the wider of the two
// types.  At the bucketed headline shape (table [1056, 384] f32, 16384
// ids, f32 addend) it reads 1.6 + 25.2 MB and writes 25.2 MB, ~15.5 us at
// 3.35 TB/s for 6.3 MFLOP of adds: memory bounds it, so the addend and the
// output are streamed once, four values a thread, and the table rows come
// from L2.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sorted_gather_kernel(const uint4* __restrict__ table,
                     const int* __restrict__ idx, uint4* __restrict__ out,
                     int E, int N, int vecs_per_row) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)E * vecs_per_row) return;
  const int e = (int)(i / vecs_per_row), v = (int)(i % vecs_per_row);
  const int r = idx[e];
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (r >= 0 && r < N) val = table[(size_t)r * vecs_per_row + v];
  out[i] = val;
}

// out[e] = table[idx[e]] (zeros for ids outside [0, N)) + addend[e], four
// columns a thread, summed in f32 and rounded once to TO.
template <typename TT, typename TA, typename TO>
__global__ void __launch_bounds__(kThreads)
sorted_gather_add_kernel(const TT* __restrict__ table,
                         const int* __restrict__ idx,
                         const TA* __restrict__ addend, TO* __restrict__ out,
                         int E, int N, int D) {
  const int per_row = D / 4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)E * per_row) return;
  const int e = (int)(i / per_row), c = (int)(i % per_row) * 4;
  const int r = idx[e];
  float4 a = gn::load4(addend + (size_t)e * D + c);
  if (r >= 0 && r < N) {
    const float4 t = gn::load4(table + (size_t)r * D + c);
    a.x += t.x; a.y += t.y; a.z += t.z; a.w += t.w;
  }
  gn::store4(out + (size_t)e * D + c, a);
}

template <typename TT, typename TA, typename TO>
int launch_add(const void* table, const void* idx, const void* addend,
               void* out, int E, int N, int D, cudaStream_t stream) {
  const long long total = (long long)E * (D / 4);
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  sorted_gather_add_kernel<TT, TA, TO><<<blocks, kThreads, 0, stream>>>(
      (const TT*)table, (const int*)idx, (const TA*)addend, (TO*)out, E, N,
      D);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError().
// Preconditions, checked by the Python wrapper: table [N, row_bytes / es]
// and out [E, ...] contiguous and 16-byte aligned, row_bytes % 16 == 0,
// int32 ids.
extern "C" int gn_sorted_gather(const void* table, const void* idx, void* out,
                                int E, int N, int row_bytes, void* stream) {
  const int vecs = row_bytes / 16;
  const long long total = (long long)E * vecs;
  if (total == 0) return cudaSuccess;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  sorted_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)idx, (uint4*)out, E, N, vecs);
  return cudaGetLastError();
}

// The fused form.  Preconditions, checked by the Python wrapper: table
// [N, D], addend and out [E, D] contiguous and 16-byte aligned, D % 4 == 0,
// int32 ids; table and addend bf16 or f32 (the flags), out f32 unless both
// are bf16.
extern "C" int gn_sorted_gather_add(const void* table, const void* idx,
                                    const void* addend, void* out, int E,
                                    int N, int D, int table_bf16,
                                    int addend_bf16, void* stream) {
  if (E == 0 || D == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (table_bf16 && addend_bf16)
    return launch_add<bf16, bf16, bf16>(table, idx, addend, out, E, N, D, s);
  if (table_bf16)
    return launch_add<bf16, float, float>(table, idx, addend, out, E, N, D, s);
  if (addend_bf16)
    return launch_add<float, bf16, float>(table, idx, addend, out, E, N, D, s);
  return launch_add<float, float, float>(table, idx, addend, out, E, N, D, s);
}
