// Random row gather: out[e] = table[idx[e]] for ids in any order.
//
// Replaces the Pallas kernel of `random_gather`
// (graphnets_tpu/ops/pallas/random_gather.py, `_kernel` and `_forward`):
// the TPU kernel issued one row-sized DMA per output row, all of a tile in
// flight together, and touched the data with no compute unit.  Its
// contract holds here too: ids are not checked and must lie in [0, N).
//
// What bounds it on the H100: at the measured shape (table [65,536, 256]
// bf16, 1,048,576 ids) it reads 34 MB of table (each row once, counted as
// the bound counts it) and 4 MB of ids and writes 537 MB: ~0.17 ms at
// 3.35 TB/s.  Unlike the sorted gather (gather.cu) consecutive rows read
// unrelated table rows, so what the loads find in L2 (the table fits its
// 50 MB) decides how close it comes.
//
// What the design does about it: a warp moves kRowsPerWarp output rows at
// a time; it reads their ids first, then issues every 16-byte load of
// those rows before the first store, so a warp keeps several independent
// row reads in flight rather than one latency per row.  Lanes copy
// neighbouring 16-byte pieces of one row, so loads and stores coalesce.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 4;

__global__ void __launch_bounds__(kThreads)
random_gather_kernel(const uint4* __restrict__ table,
                     const int* __restrict__ idx, uint4* __restrict__ out,
                     int E, int vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const long long e0 = warp * kRowsPerWarp;
  if (e0 >= E) return;
  int rows[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
    rows[j] = e0 + j < E ? idx[e0 + j] : 0;
  for (int v = lane; v < vecs_per_row; v += 32) {
    uint4 val[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
      val[j] = table[(size_t)rows[j] * vecs_per_row + v];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
      if (e0 + j < E) out[(size_t)(e0 + j) * vecs_per_row + v] = val[j];
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError().
// Preconditions, checked by the Python wrapper: table [N, row_bytes / es]
// and out [E, ...] contiguous and 16-byte aligned, row_bytes % 16 == 0,
// idx [E] int32 with every id in [0, N) (unchecked, as in the TPU kernel),
// E >= 1.
extern "C" int gn_random_gather(const void* table, const void* idx, void* out,
                                int E, int row_bytes, void* stream) {
  const long long warps = ((long long)E + kRowsPerWarp - 1) / kRowsPerWarp;
  const int blocks = (int)((warps + kThreads / 32 - 1) / (kThreads / 32));
  random_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)idx, (uint4*)out, E, row_bytes / 16);
  return cudaGetLastError();
}
