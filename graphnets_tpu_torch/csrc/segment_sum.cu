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
// What bounds it on the H100: bytes, and the latency of reaching them.  At
// the main-path shape (x [16384, 384] bf16 into 1024 segments) it reads
// 12.6 MB and writes 0.8 MB for ~6 MFLOP of adds: ~4.0 us at 3.35 TB/s.  At
// the large graph ([1,048,576, 256] bf16 into 65,536) 570 MB, ~0.17 ms; at
// a sampled subgraph ([56,320, 256] into 56,960, a pad node holding ~51,670
// rows and ~51,800 empty segments behind it) 28.8 MB read and 29.2 MB
// written, ~17 us.  The TPU kernel turned the scatter into one-hot matmuls
// on the MXU; here each row is read once with 16-byte loads and added on the
// CUDA cores, with no float atomics, so the result is deterministic.
//
// Sorted ids (receivers, ascending), chunk-balanced as the TPU kernel's
// fixed edge windows are: a block owns a chunk of R rows (R = 64 * 2^k,
// chosen on the host so that there are about two blocks an SM) and a slab
// of up to 32 x NJ 16-byte column vectors, whatever the segment lengths.  It
// stages the chunk's ids in shared memory with coalesced loads (no search
// over the ids), and each of its 8 warps walks R / 8 rows in order, a lane
// holding NJ column vectors, in batches of 8 / NJ rows with two batches'
// loads in flight (both first ones issued before the ids arrive, and a
// batch's registers refilled as soon as its rows are added).  A run of
// equal ids is summed in edge order in f32 registers: a run inside a
// warp's rows is written out at once; the runs that touch a warp's first
// or last row go to shared memory and are added in warp order by the warp
// where they start.  A run that touches the chunk's first or last row and
// continues into the next chunk goes to a partial row of the chunk
// (part_first / part_last); every chunk it spans adds to a counter of its
// segment (the first chunk -(c0 + 1), the last c1, the others -1: the sum
// is 0 only once all have arrived, so the counter is zero again for the
// next launch, and a replayed CUDA graph finds it so), and the last to
// arrive adds the partial rows in chunk order, its 8 warps over contiguous
// eighths with a batch of rows in flight, then the eighths in order.  One
// launch, no per-segment search, and the order of every sum depends only on
// the ids.  Empty segments between two ids are zeroed by the warp that sees
// the gap, unless its chunk is wide (its edge ids span more segments than
// it has rows); those below the first id and above the last (a sampled
// batch's ~51,800 nodes past its pad node) and those inside the first 8
// wide chunks (the ~3,300 between its last real receiver and the pad node)
// by all blocks, an equal share each (zeroed by one warp, they took most of
// the time at that shape).
// Rejected: a warp a segment, its range found by two binary searches over
// all E ids, and segments of more than 256 rows cut into chunks added in a
// second launch: 0.0114 ms at the main-path shape and 0.280 ms
// at the large graph (chip_smoke.py, H100 80GB HBM3, 700 W).
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
//
// Few rows (at most 2048, windows of at most 512 rows a graph: the sort
// task's 512 rows; ops/kernels/segment_sum.py small_plan): the kernels
// above run chains of serial phases on 8-9 blocks there (0.008-0.010 ms)
// for bytes that take 0.1-0.3 us, and what bounds the sum is latency: the
// launch and two dependent loads, the tile's window and then its rows.
// One pass, for sorted and windowed ids alike (small_segment_sum_kernel):
// blocks of 32 sub-warps over tiles of 4-16 segments x slabs of 8 16-byte
// vectors (a block an SM or fewer), each sub-warp a contiguous part of its
// tile's window into partial rows in shared memory, then every row
// written once, the parts added in order: no partial rows in device
// memory, counters, sort or float atomics, and the order depends only on
// the ids.  0.0035-0.0047 ms at the sort task's shapes, against
// index_add_'s 0.0049-0.0070 (chip_smoke.py --phase sums, H100 80GB HBM3,
// 700 W).  Rejected: 16 rows a batch and 16 ids a scan (slower: more
// code), 16 sub-warps (slower where a pad node sends 297 of a window's
// rows), a partial row added in shared memory row by row (scalar
// accesses with 4-way bank conflicts).

#include <climits>

#include "common.cuh"

namespace {

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


// ---- sorted ids ------------------------------------------------------------

constexpr int kSumWarps = 8;
constexpr int kMaxChunk = 2048;  // rows of a chunk at most (its staged ids)
constexpr int kMaxWide = 8;      // wide chunks whose gaps all blocks share
constexpr int kMaxShare = 4096;  // chunks at most for that sharing

// One warp's NJ column vectors of a row, as f32 sums.
template <int NJ, int VEC>
struct Acc {
  float v[NJ][VEC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int t = 0; t < VEC; ++t) v[j][t] = 0.f;
  }
  // Shared rows of 32 NJ VEC floats, value t of vector (j, lane) at
  // t * 32 NJ + 32 j + lane (no bank conflicts).
  __device__ __forceinline__ void stash(float* row, int lane) const {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int t = 0; t < VEC; ++t) row[t * 32 * NJ + 32 * j + lane] = v[j][t];
  }
  __device__ __forceinline__ void load(const float* row, int lane) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int t = 0; t < VEC; ++t) v[j][t] = row[t * 32 * NJ + 32 * j + lane];
  }
  __device__ __forceinline__ void add(const float* row, int lane) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int t = 0; t < VEC; ++t) v[j][t] += row[t * 32 * NJ + 32 * j + lane];
  }
};

// Blocks: (chunk, slab).  part_first / part_last [chunks, D] f32 scratch;
// counters [S * slabs] int32, zero at launch and left zero; spans
// [2 * S * slabs] int32 scratch: for a run that crosses a chunk edge, its
// first chunk (times 2, plus 1 where the run is that chunk's last run and
// not its first) and its last chunk.
template <typename T, int VEC, int NJ>
__global__ void __launch_bounds__(kSumWarps * 32, 2)
sorted_segment_sum_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                          T* __restrict__ out, float* __restrict__ part_first,
                          float* __restrict__ part_last, int* counters,
                          int* spans, int E, int S, int D, int R) {
  using V = Vec<T, VEC>;
  using A = Acc<NJ, VEC>;
  constexpr int kAhead = 8 / NJ;          // rows of a batch (two in flight)
  constexpr int kSlab = 32 * NJ;          // column vectors of a slab
  constexpr int kRow = kSlab * VEC;       // floats of a stashed row
  __shared__ int ids[kMaxChunk];
  __shared__ int nbr[4];                  // ids before / after, first, last
  __shared__ float first_sum[kSumWarps][kRow];  // a warp's first run
  __shared__ float last_sum[kSumWarps][kRow];   // and its last, if another
  __shared__ float chunk_sum[2][kRow];    // the chunk's first / last run
  __shared__ int glob[2][3];              // per chunk-edge run: kind, edges, last
  __shared__ int wide[kMaxWide + 1];      // the shared wide chunks, and count
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, y = blockIdx.y;
  const int chunks = gridDim.x, slabs = gridDim.y;
  const size_t r0 = (size_t)c * R;
  const int rows = E > 0 ? min(R, E - (int)r0) : 0;
  const int nvec = D / VEC;
  bool vok[NJ];
  int col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int v = y * kSlab + 32 * j + lane;
    vok[j] = v < nvec;
    col[j] = v * VEC;
  }
  auto valid = [&](int n) { return n >= 0 && n < S; };
  // The id before chunk u (u = 0: the first id; u = chunks: the last id).
  auto edge_id = [&](int u) {
    return u == 0 ? seg[0] : seg[min((size_t)E, (size_t)u * R) - 1];
  };
  // Ids strictly between a and b that are segments: a chunk whose edge ids
  // span more of them than it has rows is wide (its gaps may be long).
  auto inner = [&](int a, int b) { return max(0, min(b, S) - max(a + 1, 0)); };
  auto write_row = [&](int n, const A& a) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (vok[j]) V::store(out + (size_t)n * D + col[j], a.v[j]);
  };
  A zeros;
  zeros.zero();
  // Segments strictly between ids a and b (an empty gap), by this warp.
  auto zero_gap = [&](int a, int b) {
    for (int n = max(a + 1, 0); n < min(b, S); ++n) write_row(n, zeros);
  };

  // The warp's rows [l0, l1) of the chunk; their first batch is in flight
  // while the ids are staged.
  const int sub = R / kSumWarps;
  const int l0 = warp * sub, l1 = min(rows, l0 + sub);
  using Batch = typename V::Raw[kAhead][NJ];
  Batch raw[2];
  auto load_batch = [&](Batch& r, int l) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (l + k < l1 && vok[j])
          r[k][j] = V::load(x + (r0 + l + k) * D + col[j]);
  };
  if (l0 < l1) {
    load_batch(raw[0], l0);
    load_batch(raw[1], l0 + kAhead);
  }
  for (int i = tid; i < rows; i += kSumWarps * 32) ids[i] = seg[r0 + i];
  if (tid == 0) {
    nbr[0] = c > 0 ? seg[r0 - 1] : 0;
    nbr[1] = (int)r0 + rows < E ? seg[r0 + rows] : 0;
    nbr[2] = E > 0 ? seg[0] : 0;
    nbr[3] = E > 0 ? seg[E - 1] : 0;
  }
  // Which chunks are wide, where there are at most 2 x 256 (their ids
  // arrive with the chunk's own).
  const bool early = E > 0 && chunks <= 2 * kSumWarps * 32;
  bool wide_early[2] = {false, false};
  if (early)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid + i * kSumWarps * 32;
      if (u < chunks) wide_early[i] = inner(edge_id(u), edge_id(u + 1)) > R;
    }
  __syncthreads();
  const bool has_prev = c > 0, has_next = (int)r0 + rows < E;
  const int lo_c = c > 0 ? nbr[0] : nbr[2];
  const bool own_wide = rows > 0 && inner(lo_c, ids[rows - 1]) > R;

  // Segments below the first id and above the last: an equal share a block.
  {
    const int head_end = E > 0 ? min(max(nbr[2], 0), S) : S;
    const int tail_begin =
        E > 0 ? min(max(nbr[3], head_end - 1), S - 1) + 1 : S;
    const long long total = (long long)head_end + (S - tail_begin);
    const long long z0 = total * c / chunks, z1 = total * (c + 1) / chunks;
    for (long long i = z0 + warp; i < z1; i += kSumWarps) {
      const int n = i < head_end ? (int)i
                                 : tail_begin + (int)(i - head_end);
      write_row(n, zeros);
    }
  }

  // Walk the warp's rows in order.
  if (l0 < l1) {
    A acc;
    acc.zero();
    int cur = ids[l0];
    if (r0 + l0 > 0 && !own_wide) zero_gap(l0 > 0 ? ids[l0 - 1] : nbr[0], cur);
    bool first = true;
    auto add_batch = [&](const Batch& r, int l) {
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (l + k >= l1) break;
        const int n = ids[l + k];
        if (n != cur) {
          if (first) acc.stash(first_sum[warp], lane);
          else if (valid(cur)) write_row(cur, acc);
          if (!own_wide) zero_gap(cur, n);
          first = false;
          cur = n;
          acc.zero();
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (vok[j]) V::add(acc.v[j], r[k][j]);
      }
    };
    // Two batches in flight: a batch's buffer is refilled as soon as its
    // rows are added.
    for (int l = l0; l < l1; l += 2 * kAhead) {
      add_batch(raw[0], l);
      load_batch(raw[0], l + 2 * kAhead);
      if (l + kAhead >= l1) break;
      add_batch(raw[1], l + kAhead);
      load_batch(raw[1], l + 3 * kAhead);
    }
    acc.stash(first ? first_sum[warp] : last_sum[warp], lane);
  }
  // (With at most 512 chunks, whether any is wide comes with this barrier.)
  const bool any_early = __syncthreads_or(wide_early[0] || wide_early[1]);

  // Runs that cross warps, added in warp order by the warp where they start;
  // those that touch the chunk's first or last row go on to chunk_sum.
  const int pieces = (rows + sub - 1) / sub;
  auto pfirst = [&](int p) { return ids[p * sub]; };
  auto plast = [&](int p) { return ids[min(rows, p * sub + sub) - 1]; };
  auto gather = [&](int n, int p) {
    A s;
    s.load(n == pfirst(p) ? first_sum[p] : last_sum[p], lane);
    int p1 = p;
    if (plast(p) == n) {
      for (int q = p + 1; q < pieces && pfirst(q) == n; ++q) {
        s.add(first_sum[q], lane);
        p1 = q;
        if (plast(q) != n) break;
      }
    }
    if (p == 0 && pfirst(0) == n) s.stash(chunk_sum[0], lane);
    else if (p1 == pieces - 1 && plast(pieces - 1) == n)
      s.stash(chunk_sum[1], lane);
    else if (valid(n)) write_row(n, s);
  };
  if (warp < pieces) {
    const int nf = pfirst(warp), nl = plast(warp);
    if (warp == 0 || plast(warp - 1) != nf) gather(nf, warp);
    if (nl != nf) gather(nl, warp);
  }
  __syncthreads();
  if (rows == 0) return;

  // The chunk's first run (0) and last run (1, if another): complete here,
  // or a partial row for the last chunk of the run to arrive.
  const int nA = ids[0], nB = ids[rows - 1];
  if (tid < 2) {
    const int n = tid == 0 ? nA : nB;
    const bool mine = tid == 0 || nB != nA;
    const bool from_prev = has_prev && nbr[0] == n && tid == 0;
    const bool to_next = has_next && nbr[1] == n && (tid == 1 || nA == nB);
    // kind: 0 none, 1 complete here, 2 crosses a chunk edge
    glob[tid][0] = !mine || !valid(n) ? 0 : (from_prev || to_next ? 2 : 1);
    glob[tid][1] = (from_prev ? 1 : 0) | (to_next ? 2 : 0);
    glob[tid][2] = 0;
  }
  __syncthreads();
  for (int w = 0; w < 2; ++w) {
    const int kind = glob[w][0];
    if (kind == 0 || warp != w) continue;
    A s;
    s.load(chunk_sum[w], lane);
    if (kind == 1) {
      write_row(w == 0 ? nA : nB, s);
    } else {
      float* part = (w == 0 ? part_first : part_last) + (size_t)c * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (vok[j])
#pragma unroll
          for (int t = 0; t < VEC; t += 4)
            *reinterpret_cast<float4*>(part + col[j] + t) = make_float4(
                s.v[j][t], s.v[j][t + 1], s.v[j][t + 2], s.v[j][t + 3]);
    }
  }
  // Only a chunk with a crossing run publishes partial rows (a fence waits
  // for the block's stores, so the others skip it).
  const bool crossing = glob[0][0] == 2 || glob[1][0] == 2;
  if (crossing) {
    __threadfence();
    __syncthreads();
  }
  if (tid < 2 && glob[tid][0] == 2) {
    const int edges = glob[tid][1];
    const size_t slot = (size_t)(tid == 0 ? nA : nB) * slabs + y;
    int add = -1;
    if (!(edges & 1)) {  // the run's first chunk: its last run, or its only
      spans[2 * slot] = 2 * c + tid;
      add -= c;
    }
    if (!(edges & 2)) {  // the run's last chunk
      spans[2 * slot + 1] = c;
      add += c + 1;
    }
    __threadfence();
    glob[tid][2] = atomicAdd(counters + slot, add) + add == 0;
  }
  if (crossing) __syncthreads();

  // The last chunk of a crossing run to arrive adds its partial rows in
  // chunk order: the warps take contiguous eighths, then warp 0 adds the
  // eighths in order.  The counter is back at 0.
  for (int w = 0; w < 2; ++w) {
    if (!glob[w][2]) continue;
    __threadfence();
    const int n = w == 0 ? nA : nB;
    const size_t slot = (size_t)n * slabs + y;
    const int s0 = __ldcg(spans + 2 * slot), c1 = __ldcg(spans + 2 * slot + 1);
    const int c0 = s0 >> 1, K = c1 - c0 + 1;
    const int a = c0 + K * warp / kSumWarps;
    const int b = c0 + K * (warp + 1) / kSumWarps;
    A s;
    s.zero();
    // kBatch partial rows' loads in flight, then their adds in order.
    constexpr int kBatch = NJ == 1 ? 8 : 2;
    for (int u0 = a; u0 < b; u0 += kBatch) {
      float4 v[kBatch][NJ][VEC / 4];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int u = u0 + q;
        const float* row =
            (u == c0 && (s0 & 1) ? part_last : part_first) + (size_t)u * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int t = 0; t < VEC / 4; ++t)
            if (u < b && vok[j])
              v[q][j][t] = __ldcg(
                  reinterpret_cast<const float4*>(row + col[j] + 4 * t));
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int t = 0; t < VEC / 4; ++t)
            if (u0 + q < b && vok[j]) {
              s.v[j][4 * t] += v[q][j][t].x;
              s.v[j][4 * t + 1] += v[q][j][t].y;
              s.v[j][4 * t + 2] += v[q][j][t].z;
              s.v[j][4 * t + 3] += v[q][j][t].w;
            }
    }
    s.stash(first_sum[warp], lane);
    __syncthreads();
    if (warp == 0) {
      s.load(first_sum[0], lane);
      for (int q = 1; q < kSumWarps; ++q) s.add(first_sum[q], lane);
      write_row(n, s);
    }
    __syncthreads();
  }

  // Empty segments inside wide chunks (a sampled batch's ~3,300 node slots
  // between its last real receiver and its pad node): every block zeroes an
  // equal slice of the id span of each of the first kMaxWide wide chunks,
  // an id where a binary search over that chunk's staged ids finds no row;
  // a wide chunk past them zeroes its own span.
  auto zero_span = [&](int lo, int hi, int rw, int part, int parts) {
    const int a = max(lo + 1, 0), b = min(hi, S);
    if (b <= a) return;
    const long long span = b - a;
    const int s0 = a + (int)(span * part / parts);
    const int s1 = a + (int)(span * (part + 1) / parts);
    for (int n = s0 + warp; n < s1; n += kSumWarps) {
      int lo_i = 0, hi_i = rw;
      while (lo_i < hi_i) {
        const int mid = (lo_i + hi_i) >> 1;
        if (ids[mid] < n) lo_i = mid + 1; else hi_i = mid;
      }
      if (lo_i == rw || ids[lo_i] != n) write_row(n, zeros);
    }
  };
  if (early && !any_early) return;  // no wide chunk (own_wide is false)
  unsigned char* flags = reinterpret_cast<unsigned char*>(&first_sum[0][0]);
  const bool share = chunks <= kMaxShare;
  int any = 0;
  if (early) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid + i * kSumWarps * 32;
      if (u < chunks) flags[u] = wide_early[i];
    }
    any = 1;
  } else if (share) {
    for (int u = tid; u < chunks; u += kSumWarps * 32) {
      const bool w = inner(edge_id(u), edge_id(u + 1)) > R;
      flags[u] = w;
      any |= w;
    }
  }
  if (!__syncthreads_or(any)) {
    if (own_wide) zero_span(lo_c, ids[rows - 1], rows, 0, 1);
    return;
  }
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < chunks && n < kMaxWide; base += 32) {
      unsigned m = __ballot_sync(0xffffffffu,
                                 base + lane < chunks && flags[base + lane]);
      for (; m != 0 && n < kMaxWide; ++n) {
        if (lane == 0) wide[n] = base + __ffs(m) - 1;
        m &= m - 1;
      }
    }
    if (lane == 0) wide[kMaxWide] = n;
  }
  __syncthreads();
  const int nw = wide[kMaxWide];
  bool listed = false;
  for (int i = 0; i < nw; ++i) listed |= wide[i] == c;
  if (own_wide && !listed) zero_span(lo_c, ids[rows - 1], rows, 0, 1);
  for (int i = 0; i < nw; ++i) {
    const int w = wide[i];
    const int rw = min(R, E - w * R);
    __syncthreads();  // ids[] and nbr are free
    for (int j = tid; j < rw; j += kSumWarps * 32) ids[j] = seg[(size_t)w * R + j];
    if (tid == 0) {
      nbr[0] = edge_id(w);
      nbr[1] = edge_id(w + 1);
    }
    __syncthreads();
    zero_span(nbr[0], nbr[1], rw, c, chunks);
  }
}

template <typename T, int VEC, int NJ>
int launch_sorted_as(const void* x, const void* seg, void* out, void* part,
                     void* counters, void* spans, int E, int S, int D, int R,
                     cudaStream_t stream) {
  const int chunks = E > 0 ? (E + R - 1) / R : 1;
  const int slabs = (D / VEC + 32 * NJ - 1) / (32 * NJ);
  sorted_segment_sum_kernel<T, VEC, NJ>
      <<<dim3(chunks, slabs), kSumWarps * 32, 0, stream>>>(
          (const T*)x, (const int*)seg, (T*)out, (float*)part,
          (float*)part + (size_t)chunks * D, (int*)counters, (int*)spans, E,
          S, D, R);
  return cudaGetLastError();
}

template <typename T, int VEC>
int launch_sorted(const void* x, const void* seg, void* out, void* part,
                  void* counters, void* spans, int E, int S, int D, int R,
                  cudaStream_t stream) {
  return D / VEC > 32
             ? launch_sorted_as<T, VEC, 2>(x, seg, out, part, counters, spans,
                                           E, S, D, R, stream)
             : launch_sorted_as<T, VEC, 1>(x, seg, out, part, counters, spans,
                                           E, S, D, R, stream);
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


// ---- few rows: one pass, sorted or windowed ids ----------------------------

constexpr int kSmallLanes = 8;     // 16-byte vectors of a sub-warp (a slab)
constexpr int kSmallBatch = 8;     // rows a sub-warp loads before it adds
constexpr int kSmallScan = 4;      // ids or offsets a thread reads at once
constexpr int kSmallThreads = 256;  // at most: 32 sub-warps

// One value of a row (any width; the edge-order sum's odd widths).
template <typename T> struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void add(float (&a)[1], Raw r) {
    a[0] += static_cast<float>(r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&a)[1]) {
    *p = static_cast<T>(a[0]);
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *p;
  }
  static __device__ __forceinline__ void add(float (&a)[1], Raw r) {
    a[0] += __bfloat162float(r);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&a)[1]) {
    *p = __float2bfloat16_rn(a[0]);
  }
};

// f32 rounded to T and back (the edge-order sum's accumulator).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Q consecutive floats of shared memory (Q = 4: one 16-byte access).
template <int Q> struct Quad {
  float v[Q];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (Q == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
      for (int u = 0; u < Q; ++u) v[u] = p[u];
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (Q == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
#pragma unroll
      for (int u = 0; u < Q; ++u) p[u] = v[u];
  }
};

// Blocks: (tile of TS segments, slab of kSmallLanes column vectors); K
// sub-warps of kSmallLanes threads.  The tile's window of rows is found
// first (sorted: the two rows where an id crosses n0 and n0 + TS, every
// thread testing its own positions of ids[0, E]; windowed: the graphs
// whose node ranges meet the tile, from the offsets), then sub-warp k adds
// the window's k-th contiguous K-th part, all kSmallBatch rows' loads
// issued before their id-dependent adds, into its own f32 partial rows
// parts[k][TS] in shared memory: a run of equal ids is added in registers
// onto its partial row, in edge order, and written back when the id
// changes; a thread's bit mask marks the partial rows it wrote (the others
// read as 0, so nothing is zeroed).  The block then writes each of its
// rows once, the K partials added in sub-warp order and rounded once.
// kRound (the edge-order sum: sorted ids, K = 1) rounds the running sum to
// T after every add, as a scatter-add in T does; its window is found by two
// binary searches, so each block reads only its tile's rows.  Shared memory: K * TS *
// kSmallLanes * VEC floats (TS <= 32); float (lane, e) of a partial row at
// ((e / Q) * kSmallLanes + lane) * Q + e % Q, so that a sub-warp's 16-byte
// accesses fall on distinct banks.
template <typename T, int VEC, bool kSorted, bool kRound>
__global__ void __launch_bounds__(kSmallThreads)
small_segment_sum_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                         const int* __restrict__ node_off,
                         const int* __restrict__ edge_off, int G,
                         T* __restrict__ out, int E, int S, int D, int TS,
                         int K) {
  using V = Vec<T, VEC>;
  constexpr int Q = VEC < 4 ? VEC : 4;   // floats of a shared access
  constexpr int kRow = kSmallLanes * VEC;
  extern __shared__ float4 smem4[];
  float* parts = reinterpret_cast<float*>(smem4);
  __shared__ int win[2];
  __shared__ unsigned masks[kSmallThreads];  // each thread's rows written
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int k = tid / kSmallLanes, lane = tid % kSmallLanes;
  const int n0 = blockIdx.x * TS, n1 = n0 + TS;
  const int c = (blockIdx.y * kSmallLanes + lane) * VEC;

  // The window [w0, w1): one position meets each test where the ids (or
  // offsets) ascend, as the caller guarantees.  The edge-order sum (8
  // threads a block, any row count) searches the ids instead: no scan.
  constexpr bool kSearch = kSorted && kRound;
  if (kSearch && tid < 2) {  // lower_bound(ids, n0) and lower_bound(ids, n1)
    const int key = tid ? n1 : n0;
    int lo = 0, hi = E;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (seg[mid] < key) lo = mid + 1; else hi = mid;
    }
    win[tid] = lo;
  }
  const int len = kSearch ? -1 : kSorted ? E : G;
  for (int base = 0; base <= len; base += kSmallScan * nthreads) {
    int lo[kSmallScan], here[kSmallScan], hi[kSmallScan], e[kSmallScan];
#pragma unroll
    for (int j = 0; j < kSmallScan; ++j) {
      const int i = base + j * nthreads + tid;
      if (kSorted) {  // ids[i - 1] and ids[i]
        lo[j] = i > 0 && i <= E ? seg[i - 1] : INT_MIN;
        here[j] = i < E ? seg[i] : INT_MAX;
      } else {        // node_off[i - 1, i, i + 1] and edge_off[i]
        const bool ok = i <= G;
        here[j] = ok ? node_off[i] : 0;
        e[j] = ok ? edge_off[i] : 0;
        lo[j] = ok && i > 0 ? node_off[i - 1] : INT_MIN;
        hi[j] = ok && i < G ? node_off[i + 1] : INT_MAX;
      }
    }
#pragma unroll
    for (int j = 0; j < kSmallScan; ++j) {
      const int i = base + j * nthreads + tid;
      if (i > len) continue;
      if (kSorted) {  // lower_bound(ids, n0) and lower_bound(ids, n1)
        if (lo[j] < n0 && n0 <= here[j]) win[0] = i;
        if (lo[j] < n1 && n1 <= here[j]) win[1] = i;
      } else {
        // edge_off of max(0, upper_bound(node_off, n0) - 1) and of
        // min(G, lower_bound(node_off, n1)), as the large-row kernel's.
        if ((here[j] <= n0 || i == 0) && hi[j] > n0) win[0] = e[j];
        if ((here[j] >= n1 || i == G) && lo[j] < n1) win[1] = e[j];
      }
    }
  }
  __syncthreads();
  const int w0 = min(max(win[0], 0), E), w1 = min(max(win[1], w0), E);
  const int W = w1 - w0;

  // Sub-warp k's part of the window, into parts[k].
  unsigned done = 0;        // bit s: this thread's part of row s written
  if (c < D) {
    const int r0 = w0 + (int)((long long)W * k / K);
    const int r1 = w0 + (int)((long long)W * (k + 1) / K);
    float* mine = parts + (size_t)k * TS * kRow + lane * Q;
    int cur = -1;           // the run's segment in the tile (-1: none)
    float acc[VEC];         // its partial row, running
    auto flush = [&] {
#pragma unroll
      for (int t = 0; t < VEC; t += Q) {
        Quad<Q> q;
#pragma unroll
        for (int u = 0; u < Q; ++u) q.v[u] = acc[t + u];
        q.store(mine + cur * kRow + t * kSmallLanes);
      }
      done |= 1u << cur;
    };
    auto fetch = [&] {
      const bool was = done >> cur & 1u;
#pragma unroll
      for (int t = 0; t < VEC; t += Q) {
        Quad<Q> q;
        if (was) q.load(mine + cur * kRow + t * kSmallLanes);
#pragma unroll
        for (int u = 0; u < Q; ++u) acc[t + u] = was ? q.v[u] : 0.f;
      }
    };
    for (int r = r0; r < r1; r += kSmallBatch) {
      typename V::Raw raw[kSmallBatch];
      int id[kSmallBatch];
#pragma unroll
      for (int j = 0; j < kSmallBatch; ++j) {
        id[j] = -1;
        if (r + j < r1) {
          id[j] = seg[r + j] - n0;
          raw[j] = V::load(x + (size_t)(r + j) * D + c);
        }
      }
#pragma unroll
      for (int j = 0; j < kSmallBatch; ++j) {
        const int s = (unsigned)id[j] < (unsigned)TS ? id[j] : -1;
        if (s < 0) continue;
        if (s != cur) {
          if (cur >= 0) flush();
          cur = s;
          fetch();
        }
        float v[VEC];
#pragma unroll
        for (int t = 0; t < VEC; ++t) v[t] = 0.f;
        V::add(v, raw[j]);
#pragma unroll
        for (int t = 0; t < VEC; ++t)
          acc[t] = kRound ? round_to<T>(acc[t] + v[t]) : acc[t] + v[t];
      }
    }
    if (cur >= 0) flush();
  }
  masks[tid] = done;
  __syncthreads();

  // Each row of the tile once: the K partials in order, one rounding.
  constexpr int kPos = kSmallLanes * (VEC / Q);  // Q-float groups a row
  for (int job = tid; job < TS * kPos; job += nthreads) {
    const int s = job / kPos, pos = job % kPos;
    const int n = n0 + s;
    const int col = (blockIdx.y * kSmallLanes + pos % kSmallLanes) * VEC +
                    (pos / kSmallLanes) * Q;
    if (n >= S || col >= D) continue;
    Quad<Q> sum, part;
#pragma unroll
    for (int u = 0; u < Q; ++u) sum.v[u] = 0.f;
    const float* p = parts + (size_t)s * kRow + pos * Q;
    for (int kk = 0; kk < K; ++kk, p += (size_t)TS * kRow) {
      if (!(masks[kk * kSmallLanes + pos % kSmallLanes] >> s & 1u)) continue;
      part.load(p);
#pragma unroll
      for (int u = 0; u < Q; ++u) sum.v[u] += part.v[u];
    }
    if constexpr (Q == 4)
      gn::store4(out + (size_t)n * D + col,
                 make_float4(sum.v[0], sum.v[1], sum.v[2], sum.v[3]));
    else
      Vec<T, 1>::store(out + (size_t)n * D + col, sum.v);
  }
}

template <typename T, int VEC, bool kSorted, bool kRound>
int launch_small_as(const void* x, const void* seg, const void* node_off,
                    const void* edge_off, int G, void* out, int E, int S,
                    int D, int TS, int K, cudaStream_t stream) {
  auto kernel = small_segment_sum_kernel<T, VEC, kSorted, kRound>;
  const size_t smem = (size_t)K * TS * kSmallLanes * VEC * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + TS - 1) / TS,
                  (D / VEC + kSmallLanes - 1) / kSmallLanes);
  kernel<<<grid, K * kSmallLanes, smem, stream>>>(
      (const T*)x, (const int*)seg, (const int*)node_off,
      (const int*)edge_off, G, (T*)out, E, S, D, TS, K);
  return cudaGetLastError();
}

template <bool kSorted, bool kRound>
int launch_small(const void* x, const void* seg, const void* node_off,
                 const void* edge_off, int G, void* out, int E, int S, int D,
                 int TS, int K, int vec, int is_bf16, cudaStream_t s) {
  if (is_bf16 && vec == 8)
    return launch_small_as<__nv_bfloat16, 8, kSorted, kRound>(
        x, seg, node_off, edge_off, G, out, E, S, D, TS, K, s);
  if (is_bf16 && vec == 4)
    return launch_small_as<__nv_bfloat16, 4, kSorted, kRound>(
        x, seg, node_off, edge_off, G, out, E, S, D, TS, K, s);
  if (!is_bf16 && vec == 4)
    return launch_small_as<float, 4, kSorted, kRound>(
        x, seg, node_off, edge_off, G, out, E, S, D, TS, K, s);
  if constexpr (kRound) {  // odd widths: the edge-order sum only
    if (vec == 1)
      return is_bf16 ? launch_small_as<__nv_bfloat16, 1, kSorted, kRound>(
                           x, seg, node_off, edge_off, G, out, E, S, D, TS,
                           K, s)
                     : launch_small_as<float, 1, kSorted, kRound>(
                           x, seg, node_off, edge_off, G, out, E, S, D, TS,
                           K, s);
  }
  return cudaErrorInvalidValue;
}


}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError().
// Preconditions, checked by the Python wrapper: x [E, D] contiguous, bf16
// (is_bf16 = 1) or f32, D % 4 == 0; int32 ids; out [S or N, D] of x's type.
// Sorted: ids ascending (rows with ids outside [0, S) are dropped); R rows
// a chunk, a multiple of 8 up to 2048; part f32 scratch of
// 2 * ceil(E / R) * D values; counters int32 [S * slabs], zero (the kernel
// leaves them zero); spans int32 scratch [2 * S * slabs], where slabs =
// ceil(D / VEC / (32 NJ)) (VEC 8 for bf16 rows with D % 8 == 0, else 4;
// NJ 2 where D / VEC > 32, else 1).
// Windowed: node_off / edge_off [G + 1] ascending, and every edge of
// edge_off[b]:edge_off[b+1] has its id in node_off[b]:node_off[b+1].
extern "C" int gn_sorted_segment_sum(const void* x, const void* seg,
                                     void* out, void* part, void* counters,
                                     void* spans, int E, int S, int D, int R,
                                     int is_bf16, void* stream) {
  if (R < kSumWarps || R > kMaxChunk || R % kSumWarps != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    return launch_sorted<float, 4>(x, seg, out, part, counters, spans, E, S,
                                   D, R, s);
  return D % 8 == 0
             ? launch_sorted<__nv_bfloat16, 8>(x, seg, out, part, counters,
                                               spans, E, S, D, R, s)
             : launch_sorted<__nv_bfloat16, 4>(x, seg, out, part, counters,
                                               spans, E, S, D, R, s);
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

// The one-pass kernel for few rows (the sort task's 512), as planned by
// ops/kernels/segment_sum.py `small_plan`: tiles of `tile` segments,
// `subwarps` sub-warps of 8 threads a block, `vec` values a thread (8 or 4
// for bf16 rows, 4 for f32; 1 for the edge-order sum's odd widths, which
// D % vec == 0 must allow).  sorted = 1: ascending ids (node_off and
// edge_off unused); 0: windowed ids with [G + 1] offsets.  rounded = 1
// (sorted, subwarps = 1): every add rounded to x's type, each segment's
// rows in the order given.  Output [S, D] of x's type.
extern "C" int gn_small_segment_sum(const void* x, const void* seg,
                                    const void* node_off,
                                    const void* edge_off, int G, void* out,
                                    int E, int S, int D, int tile,
                                    int subwarps, int vec, int is_bf16,
                                    int sorted, int rounded, void* stream) {
  if (tile < 1 || tile > 32 || subwarps < 1 ||
      subwarps * kSmallLanes > kSmallThreads ||
      S < 1 || vec < 1 || D % vec != 0 ||
      (rounded && (!sorted || subwarps != 1)))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (rounded)
    return launch_small<true, true>(x, seg, node_off, edge_off, G, out, E, S,
                                    D, tile, subwarps, vec, is_bf16, s);
  if (sorted)
    return launch_small<true, false>(x, seg, node_off, edge_off, G, out, E, S,
                                     D, tile, subwarps, vec, is_bf16, s);
  return launch_small<false, false>(x, seg, node_off, edge_off, G, out, E, S,
                                    D, tile, subwarps, vec, is_bf16, s);
}
