// GraphCast's interaction-network edge MLP, its first layer split over the
// tables its three inputs live on, with the activation, in one pass:
//
//   pre[e] = bf16( f32(e[e] @ W_e)
//                  + ((f32(P_s[s[e]]) + f32(P_r[r[e]])) + f32(b)) )
//   h[e]   = bf16( swish(f32(pre[e])) )
//
// where P_s = v_s @ W_s and P_r = v_r @ W_r are the node tables' projections
// (plain products on the node rows, outside this kernel).  And the
// backward's elementwise pass:
//
//   d_pre[e] = bf16( f32(d_h[e]) * swish'(f32(pre[e])) )
//   d_b      = f32 column sums of the rounded d_pre
//
// Replaces no Pallas kernel: the JAX package has no GraphCast.  Composed
// from torch ops the layer took seven passes over [E, hidden] rows (the
// edge product, two gathers, two adds, the broadcast bias, swish), each
// writing a full [E, hidden] tensor that the next read back; and the
// backward one more read of d_pre for the bias gradient.
//
// What bounds it on the H100: bytes.  At the processor's shape (E =
// 327,680, 512 -> 512, tables of 40,968 rows) it reads e (0.34 GB) and the
// two tables (42 MB each) and writes pre and h (0.34 GB each): ~1.09 GB,
// 0.33 ms at 3.35 TB/s, against 172 GFLOP (0.17 ms of bf16 tensor-core
// work).
//
// Forward design: the wgmma + TMA core of edge_wgmma.cuh, with two outputs
// and the gathered terms in its epilogue.  One block an SM, persistent over
// 128-row tiles: two consumer warpgroups (warpgroup w takes rows [64 w,
// 64 w + 64) of a tile) and a producer warpgroup.
//   * A tile's e rows arrive by TMA as 64 x 64 boxes (whole rows stay in
//     shared memory for all output columns: latent <= 768), each box on a
//     barrier of its own; during a tile's last pass each box of the next
//     tile is loaded as soon as its products are done.
//   * W_e streams in items of [64 k x 128 n] through a ring of up to 6
//     stages (W_e, 512 KB at 512 x 512, does not fit beside the rows).  One
//     thread of the producer warpgroup fills it.  Filled by a consumer
//     thread instead, as edge_wgmma.cuh does, the consumer waited once an
//     item for the other warpgroup's hand-back, and the kernel took 1.49
//     ms at the processor's shape (0.72-0.79 with the producer; H100 80GB
//     HBM3, 700 W).  The producer warpgroup gives registers to the
//     consumers (setmaxnreg); so built, the early loads below fit in 168
//     registers without spilling (a producer warp of 32 threads spilled 60
//     bytes).
//   * Output columns go in passes of 128: per k16 step one wgmma
//     m64n128k16 a warpgroup, f32 accumulators in registers.
//   * A pass's gathered rows are loaded before its products are issued and
//     used after them: lane q of a quad loads columns 8 (4 m + q) .. + 7 of
//     both node rows of each of its two edge rows (16-byte loads, 64 bytes
//     a row for a quad).  The receivers ascend, so a tile's receiver rows
//     are one short window of P_r, which stays in L2; the senders are
//     unsorted and each is read as whole 64-byte runs.
//   * The epilogue moves the products into that layout (a 4 x 4 transpose
//     of 32-bit words across the quad, twice for a group of 8 columns),
//     adds the node terms and the bias in f32, rounds pre once, takes swish
//     of the rounded value (the special-function unit's ex2 and
//     reciprocal), rounds h once, and writes both with 16-byte stores.
//     Nothing else of [E, hidden] size is written.
//   What bounds it now (ibid.): the two warpgroups run their epilogues
//   together, with the tensor cores idle (without the epilogue the kernel
//   took 0.57 ms, without it and the products 0.37: the W_e ring from L2
//   and the e rows).  Rejected: the next pass's products under the
//   epilogue, from a second set of accumulators (spilled at 168 registers,
//   and ptxas serialized the wgmma: 1.75 ms); the ring refilled by a
//   consumer thread only where the stage was already free, 256 threads
//   (2.35 ms).
// Ids outside [0, N) read a zero row.
//
// Backward design: the elementwise pass reads d_h and pre once with
// 16-byte loads, writes d_pre (over pre, which nothing reads after it: the
// backward allocates no [E, hidden] tensor), and sums its rounded values by
// column over the block's rows into one partial row a block (the row
// groups' sums added in group order); a second kernel adds the partial rows
// in block order.  No atomics: the sums repeat bit for bit on one card.

#include "edge_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 256;           // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kRows = 64;                // rows of a warpgroup
constexpr int kTile = 2 * kRows;         // rows of a tile
constexpr int kCols = 128;               // output columns of a pass
constexpr int kItem = 64 * kCols * 2;    // one W_e item, [64 x 128] bf16
constexpr int kBox = kRows * 64 * 2;     // one e box, [64 x 64] bf16
constexpr int kMaxStages = 6;
constexpr int kMaxChunks = 12;           // 64-column boxes of an e row
constexpr size_t kMaxSmem = 232448;

struct Plan {
  int D, H, stages, tiles;
  uint32_t off_a, off_bars;
  size_t smem;
};

// Whole e rows of a tile, then as many W_e stages as fit (at least 2).
int plan(Plan* p, int E, int D, int H) {
  p->D = D;
  p->H = H;
  p->tiles = E / kTile;
  const size_t a = (size_t)kTile * D * 2;
  const size_t bars = (2 * kMaxStages + 2 * kMaxChunks) * 8;
  p->stages = 0;
  for (int s = kMaxStages; s >= 2 && p->stages == 0; --s)
    if ((size_t)s * kItem + a + bars + 1024 <= kMaxSmem) p->stages = s;
  if (p->stages == 0 || D / 64 > kMaxChunks) return cudaErrorInvalidValue;
  p->off_a = (uint32_t)(p->stages * kItem);
  p->off_bars = p->off_a + (uint32_t)a;
  p->smem = p->off_bars + bars + 1024;
  return 0;
}

// 4 x 4 transpose of 32-bit words across the four lanes of a quad (q =
// lane % 4): w[j] = M[q][j] in, w[j] = M[j][q] out.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int q) {
  const bool hi = q & 2, odd = q & 1;
  uint32_t s0 = hi ? w[0] : w[2], s1 = hi ? w[1] : w[3];
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hi) { w[0] = r0; w[1] = r1; } else { w[2] = r0; w[3] = r1; }
  s0 = odd ? w[0] : w[1];
  s1 = odd ? w[2] : w[3];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (odd) { w[0] = r0; w[2] = r1; } else { w[1] = r0; w[3] = r1; }
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// x * sigmoid(x) = x / (1 + e^-x), e^-x and the reciprocal by the
// special-function unit's approximations (relative errors near 2^-22, far
// below bf16's 2^-9; an overflowed e^-x gives -0, as the quotient does).
__device__ __forceinline__ float sigmoid_fast(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-1.4426950408889634f * x));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return r;
}
__device__ __forceinline__ float swish(float x) { return x * sigmoid_fast(x); }

__global__ void __launch_bounds__(kThreads, 1)
split_edge_fwd_kernel(const __grid_constant__ CUtensorMap emap,
                      const __grid_constant__ CUtensorMap wmap, const Plan p,
                      const __nv_bfloat16* __restrict__ ps,
                      const __nv_bfloat16* __restrict__ pr,
                      const __nv_bfloat16* __restrict__ bias,
                      const int* __restrict__ senders,
                      const int* __restrict__ receivers,
                      __nv_bfloat16* __restrict__ pre,
                      __nv_bfloat16* __restrict__ h, int Ns, int Nr) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const int S = p.stages, D = p.D, H = p.H, nk = D / 64;
  const int passes = H / kCols, items_tile = passes * nk;
  const uint32_t full = base + p.off_bars;
  const uint32_t empty = full + 8 * kMaxStages;
  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int wl = (tid >> 5) & 3, lane = tid & 31, q = lane & 3;
  const uint32_t abar = empty + 8 * kMaxStages + 8 * kMaxChunks * wg;
  const uint32_t a_s = base + p.off_a + (uint32_t)(wg * kRows * D * 2);

  const int my_tiles = (int)blockIdx.x < p.tiles
      ? (p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = my_tiles * items_tile;  // ring items of this block

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival a warpgroup
    }
    for (int i = 0; i < 2 * kMaxChunks; ++i)
      mbar_init(empty + 8 * kMaxStages + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warpgroup hands registers to the consumers (40 + 2 x 232
    // a thread of 128 fit the SM's 64K).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // The producer: W_e item j of a tile (pass j / nk, rows 64 (j % nk) ..
    // of W_e) into its ring stage once both warpgroups handed it back.
    if (tid == kConsumers) {
      for (int it = 0; it < total; ++it) {
        const int s = it % S, j = it % items_tile;
        const int c = (j / nk) * kCols, k = (j % nk) * 64;
        mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kItem);
        tma_load(base + s * kItem, &wmap, full + 8 * s, c, k);
        tma_load(base + s * kItem + 8192, &wmap, full + 8 * s, c + 64, k);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  auto release = [&](int item) {
    if (tw == 0) mbar_arrive(empty + 8 * (item % S));
  };
  // The warpgroup's 64-row tiles: 2 (blockIdx.x + t gridDim.x) + wg; its
  // leader loads their e boxes.
  auto tile64_of = [&](int t) {
    return 2 * (int)(blockIdx.x + t * gridDim.x) + wg;
  };
  auto load_box = [&](int t64, int kk) {
    mbar_expect_tx(abar + 8 * kk, kBox);
    tma_load(a_s + kk * 8192, &emap, abar + 8 * kk, kk * 64, t64 * kRows);
  };
  if (tw == 0 && my_tiles > 0)
    for (int kk = 0; kk < nk; ++kk) load_box(tile64_of(0), kk);

  int it = 0;        // ring items consumed
  int held = -1;     // an item whose products may still run
  uint32_t a_par = 0;
  for (int t = 0; t < my_tiles; ++t) {
    const int t64 = tile64_of(t);
    const bool more = t + 1 < my_tiles;
    // This thread's rows: 16 wl + lane / 4 (+ 8) of the warpgroup's 64.
    const __nv_bfloat16* srow[2];
    const __nv_bfloat16* rrow[2];
    bool sval[2], rval[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = t64 * kRows + 16 * wl + (lane >> 2) + 8 * half;
      const int s = senders[row], r = receivers[row];
      sval[half] = s >= 0 && s < Ns;
      rval[half] = r >= 0 && r < Nr;
      srow[half] = ps + (size_t)(sval[half] ? s : 0) * H;
      rrow[half] = pr + (size_t)(rval[half] ? r : 0) * H;
    }
    for (int pp = 0; pp < passes; ++pp) {
      const int c0 = pp * kCols;
      const bool last = pp == passes - 1;
      // The pass's node rows, in flight during the products.
      uint4 ws[2][4], wr[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int c = c0 + 8 * (4 * m + q);
          ws[half][m] = load16(srow[half] + c);
          wr[half][m] = load16(rrow[half] + c);
        }
      }
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int kk = 0; kk < nk; ++kk) {
        if (pp == 0) mbar_wait(abar + 8 * kk, a_par);
        const uint32_t w_s = base + (it % S) * kItem;
        mbar_wait(full + 8 * (it % S), (it / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_m64n128k16<0, 1>(acc, make_desc(a_s + kk * 8192 + j * 32, 16),
                                 make_desc(w_s + j * 2048, 8192));
        wgmma_commit();
        // The item before this one is done: hand its stage back, and in
        // the tile's last pass its e box is free for the next tile.
        wgmma_wait<1>();
        if (held >= 0) release(held);
        if (last && more && kk > 0 && tw == 0) load_box(tile64_of(t + 1), kk - 1);
        held = it++;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(held);
      held = -1;
      if (pp == 0) a_par ^= 1;
      if (last && more && tw == 0) load_box(tile64_of(t + 1), nk - 1);

      // Epilogue.  Thread (warp wl, lane) holds the products of rows 16 wl
      // + lane / 4 (+ 8) and columns 8 j + 2 q (+ 1) of the pass.  For each
      // group m of j = 4 m .. 4 m + 3 a transpose across the quad hands
      // lane q the products of columns 8 (4 m + q) .. + 7, the columns of
      // its node-row, bias, pre and h vectors.
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c = c0 + 8 * (4 * m + q);
        const uint4 bv = load16(bias + c);
        const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t ax[4], ay[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            ax[jj] = __float_as_uint(acc[4 * (4 * m + jj) + 2 * half]);
            ay[jj] = __float_as_uint(acc[4 * (4 * m + jj) + 2 * half + 1]);
          }
          quad_transpose(ax, q);
          quad_transpose(ay, q);
          const uint32_t sw[4] = {ws[half][m].x, ws[half][m].y,
                                  ws[half][m].z, ws[half][m].w};
          const uint32_t rw[4] = {wr[half][m].x, wr[half][m].y,
                                  wr[half][m].z, wr[half][m].w};
          uint32_t po[4], ho[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float2 fs = unpack2(sw[u]), fr = unpack2(rw[u]);
            if (!sval[half]) fs = make_float2(0.f, 0.f);
            if (!rval[half]) fr = make_float2(0.f, 0.f);
            const float2 fb = unpack2(bw[u]);
            po[u] = pack_bf16(__uint_as_float(ax[u]) + ((fs.x + fr.x) + fb.x),
                              __uint_as_float(ay[u]) + ((fs.y + fr.y) + fb.y));
            const float2 x = unpack2(po[u]);
            ho[u] = pack_bf16(swish(x.x), swish(x.y));
          }
          const size_t off =
              ((size_t)t64 * kRows + 16 * wl + (lane >> 2) + 8 * half) * H + c;
          *reinterpret_cast<uint4*>(pre + off) =
              make_uint4(po[0], po[1], po[2], po[3]);
          *reinterpret_cast<uint4*>(h + off) =
              make_uint4(ho[0], ho[1], ho[2], ho[3]);
        }
      }
    }
  }
}

// ---- backward ----------------------------------------------------------------

constexpr int kBwdThreads = 256;

// Rows [blockIdx.x rpb, + rpb): thread (row group g, chunk c) takes the
// 8 columns 8 c .. of rows g, g + groups, ...; its rounded d_pre are summed
// in f32 in row order, the groups' sums added in group order into the
// block's partial row.  dpre may be pre itself: each element is read before
// the same thread writes it.
__global__ void __launch_bounds__(kBwdThreads)
split_edge_bwd_kernel(const __nv_bfloat16* __restrict__ dh,
                      const __nv_bfloat16* pre, __nv_bfloat16* dpre,
                      float* __restrict__ part, int E, int H, int rpb) {
  extern __shared__ float red[];  // [groups][H]
  const int cc = H / 8, groups = blockDim.x / cc;
  const int c = threadIdx.x % cc, g = threadIdx.x / cc;
  const int r0 = blockIdx.x * rpb, r1 = min(E, r0 + rpb);
  float sum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sum[i] = 0.f;
  if (g < groups) {
#pragma unroll 4
    for (int r = r0 + g; r < r1; r += groups) {
      const size_t off = (size_t)r * H + 8 * c;
      const uint4 a = load16(dh + off);
      const uint4 b = *reinterpret_cast<const uint4*>(pre + off);
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
      uint32_t o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 dy = unpack2(aw[u]), x = unpack2(bw[u]);
        // torch's silu backward: dy * s * (1 + x (1 - s)), s = sigmoid(x).
        const float s0 = sigmoid_fast(x.x), s1 = sigmoid_fast(x.y);
        o[u] = pack_bf16(dy.x * s0 * (1.f + x.x * (1.f - s0)),
                         dy.y * s1 * (1.f + x.y * (1.f - s1)));
        const float2 rd = unpack2(o[u]);
        sum[2 * u] += rd.x;
        sum[2 * u + 1] += rd.y;
      }
      *reinterpret_cast<uint4*>(dpre + off) = make_uint4(o[0], o[1], o[2], o[3]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) red[g * H + 8 * c + i] = sum[i];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < H; col += blockDim.x) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += red[gg * H + col];
    part[(size_t)blockIdx.x * H + col] = s;
  }
}

// d_b[col] = the partial rows' values at col, added in block order: 32
// columns a block, 32 strided runs of partial rows a column, the runs'
// sums added in run order.
constexpr int kSumCols = 32, kSumRuns = 32;

__global__ void __launch_bounds__(kSumCols * kSumRuns)
split_edge_bias_kernel(const float* __restrict__ part,
                       float* __restrict__ db, int blocks, int H) {
  __shared__ float red[kSumRuns][kSumCols];
  const int cl = threadIdx.x % kSumCols, run = threadIdx.x / kSumCols;
  const int col = blockIdx.x * kSumCols + cl;
  float s = 0.f;
  if (col < H) {
#pragma unroll 8
    for (int b = run; b < blocks; b += kSumRuns) s += part[(size_t)b * H + col];
  }
  red[run][cl] = s;
  __syncthreads();
  if (run == 0 && col < H) {
    float t = 0.f;
    for (int u = 0; u < kSumRuns; ++u) t += red[u][cl];
    db[col] = t;
  }
}

}  // namespace

// Launches the forward on `stream`; returns the first error.
// Preconditions, checked by the Python wrapper: e [E, D], w_e [D, H],
// ps [Ns, H], pr [Nr, H], bias [H], pre and h [E, H], all bf16; senders and
// receivers [E] int32; contiguous and 16-byte aligned; E % 128 == 0, E >=
// 128; D % 128 == 0, D <= 768; H % 128 == 0.
extern "C" int gn_split_edge_fwd(const void* e, const void* w_e,
                                 const void* ps, const void* pr,
                                 const void* bias, const void* senders,
                                 const void* receivers, void* pre, void* h,
                                 int E, int Ns, int Nr, int D, int H,
                                 void* stream) {
  Plan p;
  int err;
  if ((err = plan(&p, E, D, H)) != 0) return err;
  CUtensorMap em, wm;
  if ((err = make_map(&em, e, E, D, 64)) != 0) return err;
  if ((err = make_map(&wm, w_e, D, H, 64)) != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      split_edge_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (cerr != cudaSuccess) return cerr;
  const int grid = min(p.tiles, gn::edge::num_sms());
  split_edge_fwd_kernel<<<grid, kThreads, p.smem, (cudaStream_t)stream>>>(
      em, wm, p, (const __nv_bfloat16*)ps, (const __nv_bfloat16*)pr,
      (const __nv_bfloat16*)bias, (const int*)senders,
      (const int*)receivers, (__nv_bfloat16*)pre, (__nv_bfloat16*)h, Ns, Nr);
  return cudaGetLastError();
}

// Rows a block of the backward takes and the number of blocks (= partial
// rows): one wave of resident blocks on this card.
extern "C" int gn_split_edge_bwd_plan(int E, int H, int* rows_per_block,
                                      int* blocks) {
  const int cc = H / 8, groups = kBwdThreads / cc;
  const size_t smem = (size_t)groups * H * 4;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, split_edge_bwd_kernel, cc * groups, smem);
  if (err != cudaSuccess) return err;
  const int want = max(1, per_sm) * gn::edge::num_sms();
  int rpb = (E + want - 1) / want;
  rpb = (rpb + groups - 1) / groups * groups;
  *rows_per_block = rpb;
  *blocks = (E + rpb - 1) / rpb;
  return 0;
}

// Launches the backward's two kernels on `stream`.  dh, pre, dpre [E, H]
// bf16 (dpre may be pre); part [blocks, H] f32 scratch and db [H] f32,
// from gn_split_edge_bwd_plan; H % 128 == 0, H <= 2048.
extern "C" int gn_split_edge_bwd(const void* dh, const void* pre, void* dpre,
                                 void* part, void* db, int E, int H,
                                 int rows_per_block, int blocks,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int cc = H / 8, groups = kBwdThreads / cc;
  split_edge_bwd_kernel<<<blocks, cc * groups, (size_t)groups * H * 4, s>>>(
      (const __nv_bfloat16*)dh, (const __nv_bfloat16*)pre,
      (__nv_bfloat16*)dpre, (float*)part, E, H, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_edge_bias_kernel<<<(H + kSumCols - 1) / kSumCols,
                           kSumCols * kSumRuns, 0, s>>>(
      (const float*)part, (float*)db, blocks, H);
  return cudaGetLastError();
}
