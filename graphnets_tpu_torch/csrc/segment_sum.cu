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
// [G+1] node and edge offsets): a block owns a tile of kWinNodes segments
// and one group of 32 x VEC columns (16 bytes a lane: 8 bf16 or 4 f32
// values); its edge window is the edge range of the graphs that the tile
// meets (a tile may span graphs).  The block reads the window's ids in
// pieces of kPiece with all loads in flight at once, and sorts the edges
// of its own segments by segment with a stable counting sort in shared
// memory (per-warp counts, offsets in warp order, ranks within a warp by
// __match_any_sync), so that each segment's edges lie together in edge
// order.  Each warp then owns two neighbouring segments and adds their rows
// in that order in registers, kWinAhead rows in flight at a time; a
// segment of more than kWinLong rows (the pad node of a padded batch, which
// collects every pad edge: 297 of the sort task's 512) is cut into eight
// contiguous parts, one a warp, added in warp order.  Shared memory holds
// the piece's ids, their order and the offsets (~33 KB) whatever the window
// or the width; the sum order depends only on the ids: no float atomics,
// deterministic.  At the main path (E = 16384, 8 graphs of 128 nodes,
// d = 384 bf16) that is 64 tiles x 2 column groups = 128 blocks.

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

constexpr int kWinNodes = 16;    // segments a block (windowed)
constexpr int kWinWarps = 8;
constexpr int kPiece = 2048;     // window edges sorted at a time
constexpr int kWinAhead = 16;    // rows a warp loads before it adds them
constexpr int kWinLong = 64;     // rows above which all warps share a segment
constexpr int kMaxOffsets = 1024;  // offsets cached in shared memory

// First index i in the ascending a[0, n) with a[i] > key (n if none).
__device__ __forceinline__ int upper_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// VEC consecutive values of a row: one load, f32 adds, one rounding.
template <typename T, int VEC> struct Vec;
template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void add(float (&a)[8], Raw r) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      a[2 * t] += f.x;
      a[2 * t + 1] += f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&a)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      h[t] = __floats2bfloat162_rn(a[2 * t], a[2 * t + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};
template <typename T> struct Vec<T, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return gn::load4(p);
  }
  static __device__ __forceinline__ void add(float (&a)[4], Raw r) {
    a[0] += r.x; a[1] += r.y; a[2] += r.z; a[3] += r.w;
  }
  static __device__ __forceinline__ void store(T* p, const float (&a)[4]) {
    gn::store4(p, make_float4(a[0], a[1], a[2], a[3]));
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kWinWarps * 32)
windowed_segment_sum_kernel(const T* __restrict__ x,
                            const int* __restrict__ seg,
                            const int* __restrict__ node_off,
                            const int* __restrict__ edge_off, int G,
                            T* __restrict__ out, int N, int D) {
  using V = Vec<T, VEC>;
  constexpr int kLoads = kPiece / (kWinWarps * 32);
  __shared__ int ids[kPiece];     // the piece's local ids (-1: not ours)
  __shared__ int order[kPiece];   // our edges, grouped by segment
  __shared__ int cnt[kWinWarps][kWinNodes];
  __shared__ int start[kWinNodes + 1];
  __shared__ int offs[2][kMaxOffsets];
  __shared__ int win[2];
  __shared__ float parts[kWinWarps][VEC][32];  // a long segment's parts
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kWinNodes;
  const int c = (blockIdx.y * 32 + lane) * VEC;
  const bool col_ok = c < D;

  // The graphs whose node ranges meet [n0, n0 + kWinNodes), as the TPU
  // kernel's host-side searchsorted computes them.
  const bool cached = G + 1 <= kMaxOffsets;
  if (cached)
    for (int i = tid; i <= G; i += kWinWarps * 32) {
      offs[0][i] = node_off[i];
      offs[1][i] = edge_off[i];
    }
  __syncthreads();
  if (tid == 0) {
    const int* no = cached ? offs[0] : node_off;
    const int* eo = cached ? offs[1] : edge_off;
    const int g_lo = max(0, min(G, upper_bound(no, G + 1, n0) - 1));
    const int g_hi =
        max(0, min(G, gn::lower_bound(no, G + 1, n0 + kWinNodes)));
    win[0] = eo[g_lo];
    win[1] = max(eo[g_hi], win[0]);
  }
  __syncthreads();
  const int w0 = win[0], w1 = win[1];

  float acc[2][VEC];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[q][t] = 0.f;

  for (int p0 = w0; p0 < w1; p0 += kPiece) {
    const int len = min(kPiece, w1 - p0);
    {
      int v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = tid + k * kWinWarps * 32;
        v[k] = i < len ? seg[p0 + i] - n0 : -1;
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        ids[tid + k * kWinWarps * 32] =
            (unsigned)v[k] < (unsigned)kWinNodes ? v[k] : -1;
    }
    if (tid < kWinWarps * kWinNodes) cnt[tid / kWinNodes][tid % kWinNodes] = 0;
    __syncthreads();
    // Counts of each warp's contiguous part of the piece.
    const int a = len * warp / kWinWarps, b = len * (warp + 1) / kWinWarps;
    for (int i = a + lane; i < b; i += 32) {
      const int l = ids[i];
      if (l >= 0) atomicAdd(&cnt[warp][l], 1);
    }
    __syncthreads();
    // Offsets: segment t's edges start after those of the segments before
    // it; within them, warp w's after those of the warps before it.
    if (warp == 0) {
      int tot = 0;
      if (lane < kWinNodes)
        for (int w = 0; w < kWinWarps; ++w) tot += cnt[w][lane];
      int incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane < kWinNodes) {
        int run = incl - tot;
        start[lane] = run;
        for (int w = 0; w < kWinWarps; ++w) {
          const int k = cnt[w][lane];
          cnt[w][lane] = run;
          run += k;
        }
        if (lane == kWinNodes - 1) start[kWinNodes] = run;
      }
    }
    __syncthreads();
    // Stable placement: lanes in edge order, warps in part order.
    for (int base = a; base < b; base += 32) {
      const int i = base + lane;
      const int l = i < b ? ids[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, l);
      if (l >= 0)
        order[cnt[warp][l] + __popc(peers & ((1u << lane) - 1u))] = p0 + i;
      __syncwarp();
      if (l >= 0 && lane == __ffs(peers) - 1) cnt[warp][l] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // Rows order[i0 .. i1) added in order, kWinAhead loads in flight; the
    // rows before `mid` go to a0, the rest to a1.
    auto add_rows = [&](float (&a0)[VEC], float (&a1)[VEC], int i0, int i1,
                        int mid) {
      if (!col_ok) return;
      for (int i = i0; i < i1; i += kWinAhead) {
        typename V::Raw r[kWinAhead];
#pragma unroll
        for (int j = 0; j < kWinAhead; ++j)
          if (i + j < i1) r[j] = V::load(x + (size_t)order[i + j] * D + c);
#pragma unroll
        for (int j = 0; j < kWinAhead; ++j) {
          if (i + j >= i1) continue;
          if (i + j < mid) V::add(a0, r[j]);
          else V::add(a1, r[j]);
        }
      }
    };
    // Segments 2 warp and 2 warp + 1 (their edges lie together in order),
    // unless one is long.
    const int e_begin = start[2 * warp], e_mid = start[2 * warp + 1],
              e_end = start[2 * warp + 2];
    const bool long0 = e_mid - e_begin > kWinLong,
               long1 = e_end - e_mid > kWinLong;
    add_rows(acc[0], acc[1], long0 ? e_mid : e_begin, long1 ? e_mid : e_end,
             e_mid);
    // A long segment (the pad node of a padded batch collects every pad
    // edge): each warp adds a contiguous eighth of its rows, and the owner
    // adds the eighths in warp order.
    for (int t = 0; t < kWinNodes; ++t) {
      const int s0 = start[t], len = start[t + 1] - s0;
      if (len <= kWinLong) continue;
      float part[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) part[v] = 0.f;
      add_rows(part, part, s0 + len * warp / kWinWarps,
               s0 + len * (warp + 1) / kWinWarps, 1 << 30);
#pragma unroll
      for (int v = 0; v < VEC; ++v) parts[warp][v][lane] = part[v];
      __syncthreads();
      if (warp == t / 2) {
#pragma unroll
        for (int w = 0; w < kWinWarps; ++w)
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            if (t % 2) acc[1][v] += parts[w][v][lane];
            else acc[0][v] += parts[w][v][lane];
          }
      }
      __syncthreads();
    }
    __syncthreads();  // the next piece rewrites the shared arrays
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int n = n0 + 2 * warp + q;
    if (n < N && col_ok) V::store(out + (size_t)n * D + c, acc[q]);
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

template <typename T, int VEC>
int launch_windowed(const void* x, const void* seg, const void* node_off,
                    const void* edge_off, int G, void* out, int N, int D,
                    cudaStream_t stream) {
  const dim3 grid((N + kWinNodes - 1) / kWinNodes,
                  (D + 32 * VEC - 1) / (32 * VEC));
  windowed_segment_sum_kernel<T, VEC><<<grid, kWinWarps * 32, 0, stream>>>(
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
  if (!is_bf16)
    return launch_windowed<float, 4>(x, seg, node_off, edge_off, G, out, N,
                                     D, s);
  return D % 8 == 0
             ? launch_windowed<__nv_bfloat16, 8>(x, seg, node_off, edge_off,
                                                 G, out, N, D, s)
             : launch_windowed<__nv_bfloat16, 4>(x, seg, node_off, edge_off,
                                                 G, out, N, D, s);
}
