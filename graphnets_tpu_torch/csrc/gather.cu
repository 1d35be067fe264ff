// Sorted row gather: out[e] = table[idx[e]], zeros for ids outside
// [0, N).
//
// Replaces the Pallas kernel of `sorted_gather`
// (graphnets_tpu/ops/pallas/gather.py, `_kernel` and `_forward`).  The TPU
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
