// Sorted and windowed segment sums with f32 accumulation.
//
// Replaces the Pallas kernel of graphnets_tpu/ops/pallas/segment_sum.py
// (`_kernel` and `_forward`, reached by `sorted_segment_sum` and
// `windowed_segment_sum`):
//
//   out[n] = x.dtype( f32 sum of x[e] over the rows e with seg[e] == n )
//
// every output row written once (zero rows included), rounded once.
//
// What bounds it on the H100: at the main-path shape (x [16384, 384] bf16
// into 1024 segments) it reads 12.6 MB and writes 0.8 MB for ~6 MFLOP of
// adds, so memory bounds it: ~4.0 us at 3.35 TB/s.  The TPU kernel turned
// the scatter into one-hot matmuls on the MXU; here each row is read once
// with 8- or 16-byte loads and added on the CUDA cores, with no atomics, so
// the result is deterministic.
//
// Sorted ids (receivers, ascending): one warp owns one segment, finds its
// edge range by binary search and walks it in order, each lane holding up
// to four 4-column f32 accumulators in registers.  A segment of more than
// kLong rows (a hub node of a power-law graph; the pad node of a sampled
// subgraph, which collects every pad edge) would leave one warp walking
// tens of thousands of rows while the card idles, so its warp skips it and
// blocks take it instead: the rows are cut into chunks of kLong, a block
// per chunk (further blocks of the same launch) sums the part of a long
// segment that lies in its chunk (a long segment always holds a chunk's
// first or last row), and in a second small launch the block whose chunk
// holds the segment's first row adds the parts in chunk order.  Still no
// atomics, and the order of the sums depends only on the ids.  A chunk
// block first reads two ids that a long segment would have to hold
// (maybe_long) and ends there, before any search, if neither matches: with
// no long segment the chunk blocks cost two loads each.
//
// Windowed ids (senders: unsorted within a graph but local to it, with
// [G+1] node and edge offsets): a block owns a tile of kTile segments and
// kCols columns; its edge window is the edge range of the graphs that the
// tile meets (a tile may span graphs).  The window is split into kWarps
// contiguous parts, one a warp; each warp sums its part in edge order into
// its own f32 accumulator in shared memory (each lane owns one column, so
// no two threads touch one address), and the warps' accumulators are then
// added in warp order.  The summation order is fixed: no atomics.  Each
// warp loads kAhead edges' ids and values before it adds any of them, so
// the loads are in flight together rather than one latency per edge.  At
// the main path a tile is one graph's 2,048-edge window, and every edge row
// is read once.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 4;   // 128-column chunks a lane holds at once
constexpr int kLong = 256;   // rows above which a segment leaves its warp

// Whether the segment `n` that holds row r may have more than kLong rows:
// such a segment holds row r - kLong / 2 or row r + kLong / 2 (if it starts
// after the first it has kLong + 1 rows from there on, which reach past the
// second).
__device__ __forceinline__ bool maybe_long(const int* seg, int E, int r,
                                           int n) {
  constexpr int kHalf = kLong / 2;
  return (r >= kHalf && seg[r - kHalf] == n) ||
         (r + kHalf < E && seg[r + kHalf] == n);
}

// The rows [*r0, *r1) of chunk `b` that belong to the long segment holding
// the chunk's first (which = 0) or last (which = 1) row, and that
// segment's range [*e0, *e1); false if there is no such long segment (the
// last row's is looked at only when it differs from the first row's).
__device__ __forceinline__ bool long_part(const int* seg, int E, int S, int b,
                                          int which, int* n, int* e0, int* e1,
                                          int* r0, int* r1) {
  const int begin = b * kLong, end = min(E, begin + kLong);
  const int first = seg[begin], last = seg[end - 1];
  if (which == 1 && last == first) return false;
  *n = which == 0 ? first : last;
  if (*n < 0 || *n >= S) return false;
  if (!maybe_long(seg, E, which == 0 ? begin : end - 1, *n)) return false;
  *e0 = gn::lower_bound(seg, E, *n);
  *e1 = *e0 + gn::lower_bound(seg + *e0, E - *e0, *n + 1);
  if (*e1 - *e0 <= kLong) return false;
  *r0 = max(*e0, begin);
  *r1 = min(*e1, end);
  return true;
}

// part[(b * 2 + which) * D + c] = f32 sum of the long segment's rows in
// chunk b.  The block's threads split into groups of D / 4 (4 columns a
// thread); group j takes the rows r0 + j, r0 + j + groups, ..., and the
// groups' sums are added in group order.
template <typename T>
__device__ void long_segment_parts(const T* __restrict__ x,
                                   const int* __restrict__ seg,
                                   float* __restrict__ part, int E, int S,
                                   int D, int b) {
  __shared__ float4 sums[kThreads];
  const int tid = threadIdx.x;
  const int per_row = D / 4;
  const int groups = per_row >= kThreads ? 1 : kThreads / per_row;
  const int group = tid / per_row, lane = tid % per_row;
  for (int which = 0; which < 2; ++which) {
    int n, e0, e1, r0, r1;
    if (!long_part(seg, E, S, b, which, &n, &e0, &e1, &r0, &r1)) continue;
    for (int c0 = 0; c0 < per_row; c0 += kThreads) {
      const int c = (c0 + lane) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (group < groups && c < D) {
#pragma unroll 4
        for (int r = r0 + group; r < r1; r += groups) {
          const float4 v = gn::load4(x + (size_t)r * D + c);
          acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
        }
      }
      if (groups > 1) {
        sums[tid] = acc;
        __syncthreads();
        if (group == 0) {
          for (int j = 1; j < groups; ++j) {
            const float4 v = sums[j * per_row + lane];
            acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
          }
        }
        __syncthreads();
      }
      if (group == 0 && c < D)
        gn::store4(part + ((size_t)b * 2 + which) * D + c, acc);
    }
  }
}

// Blocks [0, seg_blocks) give a warp to each segment; the blocks after
// them take a chunk of rows each for the long segments' parts.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                          T* __restrict__ out, float* __restrict__ part,
                          int E, int S, int D, int seg_blocks) {
  if ((int)blockIdx.x >= seg_blocks) {
    long_segment_parts(x, seg, part, E, S, D, (int)blockIdx.x - seg_blocks);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (n >= S) return;
  const int e0 = gn::lower_bound(seg, E, n);
  const int e1 = e0 + gn::lower_bound(seg + e0, E - e0, n + 1);
  if (e1 - e0 > kLong) return;  // the long-segment kernels write this row
  for (int c0 = 0; c0 < D; c0 += 128 * kChunks) {
    float4 acc[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = e0; e < e1; ++e) {
      const T* row = x + (size_t)e * D;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int c = c0 + j * 128 + lane * 4;
        if (c < D) {
          const float4 v = gn::load4(row + c);
          acc[j].x += v.x; acc[j].y += v.y; acc[j].z += v.z; acc[j].w += v.w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = c0 + j * 128 + lane * 4;
      if (c < D) gn::store4(out + (size_t)n * D + c, acc[j]);
    }
  }
}

// out[n] = the parts of long segment n, added in chunk order, rounded once;
// by the block of the chunk that holds the segment's first row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
long_segment_combine_kernel(const int* __restrict__ seg,
                            const float* __restrict__ part,
                            T* __restrict__ out, int E, int S, int D) {
  const int b = blockIdx.x;
  for (int which = 0; which < 2; ++which) {
    int n, e0, e1, r0, r1;
    if (!long_part(seg, E, S, b, which, &n, &e0, &e1, &r0, &r1)) continue;
    if (e0 / kLong != b) continue;  // an earlier chunk's block owns it
    const int last_chunk = (e1 - 1) / kLong;
    for (int c = threadIdx.x * 4; c < D; c += kThreads * 4) {
      float4 acc = gn::load4(part + ((size_t)b * 2 + which) * D + c);
      // Every later chunk holds the segment at its first row.
#pragma unroll 4
      for (int u = b + 1; u <= last_chunk; ++u) {
        const float4 v = gn::load4(part + (size_t)u * 2 * D + c);
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      gn::store4(out + (size_t)n * D + c, acc);
    }
  }
}

constexpr int kTile = 128;    // segments per block (windowed)
constexpr int kCols = 32;     // columns per block: one per lane
constexpr int kWarps = 8;
constexpr int kAhead = 8;     // edges loaded before they are added
constexpr size_t kWinSmem = (size_t)kWarps * kTile * kCols * sizeof(float);

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_f32(float v) { return v; }

// First index i in the ascending a[0, n) with a[i] > key (n if none).
__device__ __forceinline__ int upper_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
windowed_segment_sum_kernel(const T* __restrict__ x,
                            const int* __restrict__ seg,
                            const int* __restrict__ node_off,
                            const int* __restrict__ edge_off, int G,
                            T* __restrict__ out, int N, int D) {
  extern __shared__ __align__(16) float acc[];  // [kWarps][kTile][kCols]
  __shared__ int win[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kTile, nt = min(kTile, N - n0);
  const int c = blockIdx.y * kCols + lane;

  for (int i = tid; i < kWarps * kTile * kCols; i += kWarps * 32) acc[i] = 0.f;
  if (tid == 0) {
    // The graphs whose node ranges meet [n0, n0 + kTile), as the TPU
    // kernel's host-side searchsorted computes them.
    const int g_lo = max(0, min(G, upper_bound(node_off, G + 1, n0) - 1));
    const int g_hi = max(0, min(G, gn::lower_bound(node_off, G + 1,
                                                   n0 + kTile)));
    win[0] = edge_off[g_lo];
    win[1] = max(edge_off[g_hi], win[0]);
  }
  __syncthreads();
  const int len = win[1] - win[0];
  const int a = win[0] + (int)((long long)len * warp / kWarps);
  const int b = win[0] + (int)((long long)len * (warp + 1) / kWarps);
  float* mine = acc + (size_t)warp * kTile * kCols + lane;
  if (c < D) {
    for (int e0 = a; e0 < b; e0 += kAhead) {
      unsigned s[kAhead];
      float v[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        // A sender of another tile (or past the part) gets s >= nt.
        s[j] = e0 + j < b ? (unsigned)(seg[e0 + j] - n0) : (unsigned)nt;
        v[j] = s[j] < (unsigned)nt ? to_f32(x[(size_t)(e0 + j) * D + c])
                                   : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j)
        if (s[j] < (unsigned)nt) mine[s[j] * kCols] += v[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < nt * kCols; i += kWarps * 32) {
    const int r = i / kCols, q = i % kCols;
    const int cc = blockIdx.y * kCols + q;
    if (cc >= D) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum += acc[((size_t)w * kTile + r) * kCols + q];
    out[(size_t)(n0 + r) * D + cc] = from_f32<T>(sum);
  }
}

template <typename T>
int launch_sorted(const void* x, const void* seg, void* out, void* part,
                  int E, int S, int D, cudaStream_t stream) {
  const int per_block = kThreads / 32;
  const int seg_blocks = (S + per_block - 1) / per_block;
  const int chunks = E > kLong ? (E + kLong - 1) / kLong : 0;
  sorted_segment_sum_kernel<T><<<seg_blocks + chunks, kThreads, 0, stream>>>(
      (const T*)x, (const int*)seg, (T*)out, (float*)part, E, S, D,
      seg_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 0) return err;
  long_segment_combine_kernel<T><<<chunks, kThreads, 0, stream>>>(
      (const int*)seg, (const float*)part, (T*)out, E, S, D);
  return cudaGetLastError();
}

template <typename T>
int launch_windowed(const void* x, const void* seg, const void* node_off,
                    const void* edge_off, int G, void* out, int N, int D,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      windowed_segment_sum_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWinSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, (D + kCols - 1) / kCols);
  windowed_segment_sum_kernel<T><<<grid, kWarps * 32, kWinSmem, stream>>>(
      (const T*)x, (const int*)seg, (const int*)node_off,
      (const int*)edge_off, G, (T*)out, N, D);
  return cudaGetLastError();
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError().
// Preconditions, checked by the Python wrapper: x [E, D] contiguous, bf16
// (is_bf16 = 1) or f32, D % 4 == 0; int32 ids; out [S or N, D] of x's type.
// Sorted: ids ascending (rows with ids outside [0, S) are dropped); part is
// f32 scratch of 2 * ceil(E / long_rows) * D values (unused, and may be
// null, when E <= long_rows).
// Windowed: node_off / edge_off [G + 1] ascending, and every edge of
// edge_off[b]:edge_off[b+1] has its id in node_off[b]:node_off[b+1].
extern "C" int gn_sorted_segment_sum_long_rows() { return kLong; }

extern "C" int gn_sorted_segment_sum(const void* x, const void* seg,
                                     void* out, void* part, int E, int S,
                                     int D, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16
             ? launch_sorted<__nv_bfloat16>(x, seg, out, part, E, S, D, s)
             : launch_sorted<float>(x, seg, out, part, E, S, D, s);
}

extern "C" int gn_windowed_segment_sum(const void* x, const void* seg,
                                       const void* node_off,
                                       const void* edge_off, int G,
                                       void* out, int N, int D, int is_bf16,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_windowed<__nv_bfloat16>(x, seg, node_off, edge_off,
                                                  G, out, N, D, s)
                 : launch_windowed<float>(x, seg, node_off, edge_off, G, out,
                                          N, D, s);
}
