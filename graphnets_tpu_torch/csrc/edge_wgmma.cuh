// The wgmma + TMA core of the two fused edge updates (edge_update.cu, the
// uniform slot layouts; edge_update_g1.cu, a single graph) and of
// ln_matmul's bf16 rows (ln_linear_fwd.cu):
//
//   h[e]   = bf16( epilogue( f32(bf16(LN(ef[e])) @ W0), partials of e ) )
//   agg[n] = f32 sum of the ROUNDED h[e] over the edges with receiver n
//
// The epilogue is the caller's (a policy type with receiver(e), row(e) and
// apply(row, c, a0, a1, staged), or pre(row, c, staged) for the terms that
// come before the product; kStaged / kStagedF32: a bf16 / f32 [E, dout]
// partial read through the staging tile, whose pair is `staged`; kOutF32:
// h is the f32 sum, not rounded); the core does the rest.  ln_matmul's
// policy has no receivers and no agg: h = bf16(product + addend) with the
// addend staged in its stored type, or the f32 product alone.
//
// What bounds it on the H100: bytes.  At the large graph (E = 1,048,576,
// 256 -> 256) ~1.7 GB against 137 GFLOP; at the uniform headline
// (E = 16384, 384 -> 384) ~30 MB against 4.8 GFLOP.
//
// Design.  One block of two consumer warpgroups an SM, persistent over
// 128-row tiles; warpgroup w takes rows [64 w, 64 w + 64) of a tile.  No
// producer warp (it would cap a thread at 168 registers): thread 0 issues
// the W0 loads, each warpgroup's first thread its own tile loads.
//   * The ef rows arrive by TMA as 64 x 64 boxes in the 128-byte-swizzled
//     K-major layout wgmma reads (64-column atoms of 8 KB); the next tile's
//     rows stream in under the last pass's epilogue.  The warps take each
//     row's statistics (f32, the Flux convention: std = 0 where var == 0)
//     and normalise the tile in place, rounding once to bf16: the LN runs
//     once per row for all of dout.  Rows too wide for shared memory (de
//     above ~600) are held `kp` columns at a time: their statistics then
//     come from device memory first, and each piece is loaded and
//     normalised again for every 128-column pass.
//   * W0 arrives in items of [64 k x 128 n] (two 64 x 64 boxes, read
//     MN-major: W0 stays row-major).  Where the whole of W0 fits beside the
//     rows (256 x 256: 128 KB) it is loaded once a block and stays;
//     otherwise the items stream through a ring of up to 6 stages shared by
//     the two warpgroups (an mbarrier of one arrival fills a stage, one of
//     two arrivals hands it back; a stage goes back as soon as the next
//     item's products are issued).
//   * Output columns go in passes of 128: per k16 step one wgmma m64n128k16
//     a warpgroup, f32 accumulators in registers (64 a thread).
//   * Epilogue of a pass, on a 16 KB staging tile laid out as two TMA boxes
//     (no bank conflicts for the fragment writes or the column reads; 32 KB
//     as four boxes of 32 f32 columns where an f32 partial comes in or f32
//     values go out): a [E, dout] partial (the single graph's bf16 sender
//     term, ln_matmul's addend) is loaded
//     into it by TMA during the products, and the terms that come before
//     the product in the caller's order are summed while the products run;
//     the caller's sum, rounded once to bf16, replaces the staged values
//     element by element, and the tile leaves by TMA store (rows past E are
//     not written).  Partials read from device memory in the fragment
//     layout after the products, behind generic stores, were the largest
//     cost of the first build of this design.
//   Rejected: the PR 1 / PR 4 designs (WMMA on 64 x 128 tiles, ef
//   normalised once per column tile, W0 re-read from L2 by every block,
//   loading, multiplying and storing in turn): 2.58 ms at the large graph
//   and 0.167 ms at the headline (chip_smoke.py, H100 80GB HBM3, 700 W).
//
// The edge->node sum (no atomics, deterministic).  Receivers ascend.  Every
// thread of a warpgroup owns a column of the pass and walks the warpgroup's
// 64 rows in order: a node whose edges lie wholly inside those rows gets its
// sum written to agg; the run that touches the first row and the run that
// touches the last may continue next door, so their sums go to two partial
// rows of the 64-row tile.  `edge_agg_boundary_kernel` then adds, for every
// node on a tile boundary, the partial rows in tile order.  Nodes with no
// edge keep the zeros the caller fills agg with; ids outside [0, N) join no
// sum.
//
// h may be the buffer of a partial the epilogue reads (the single-graph
// update writes h over its dead sender term): a pass reads its part of the
// partial (staged, or into registers) before its TMA store writes that
// part of h, and passes and tiles own disjoint parts.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace gn {
namespace edge {

using namespace hopper;

constexpr int kThreads = 256;            // two consumer warpgroups
constexpr int kRows = 64;                // rows of a warpgroup (a tile's half)
constexpr int kCols = 128;               // output columns of a pass
constexpr int kItem = 64 * kCols * 2;    // one W0 item, [64 x 128] bf16
constexpr int kHs = kRows * kCols * 2;   // the staged h of a pass
constexpr int kMaxStages = 6;
constexpr size_t kMaxSmem = 232448;

// The block's shared memory, chosen on the host (plan()).
struct Plan {
  int de, dout;
  int kp;          // ef columns held at once: de, or a divisor of it
  int stages;      // W0 ring stages; 0: W0 resident
  int tiles;       // 128-row tiles
  uint32_t off_a, off_hs, off_rls, off_stats, off_bars;
  size_t smem;
};

// Barrier `id` (1 or 2) over the 128 threads of one warpgroup.
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Eight bf16 values of a 16-byte chunk.
__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(p[t]);
    v[2 * t] = f.x;
    v[2 * t + 1] = f.y;
  }
}

// Mean and std + eps of the warpgroup's 64 rows, two neighbouring lanes a
// row; `chunk(r, vi)` gives the 16-byte chunk vi (columns 8 vi ..) of row r.
template <class Chunk>
__device__ __forceinline__ void row_stats(int tw, int de, float* mean,
                                          float* den, Chunk chunk) {
  const int r = tw >> 1, j = tw & 1, nvec = de / 8;
  float v[8], s = 0.f;
#pragma unroll 4
  for (int vi = j; vi < nvec; vi += 2) {
    unpack8(chunk(r, vi), v);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += v[t];
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  const float m = s / de;
  float q = 0.f;
#pragma unroll 4
  for (int vi = j; vi < nvec; vi += 2) {
    unpack8(chunk(r, vi), v);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float c = v[t] - m;
      q += c * c;
    }
  }
  q += __shfl_xor_sync(0xffffffffu, q, 1);
  const float var = q / de;
  if (j == 0) {
    mean[r] = m;
    den[r] = (var > 0.f ? sqrtf(var) : 0.f) + kLnEps;
  }
}

// Byte offset of chunk vi of row r in a warpgroup's A tile.
__device__ __forceinline__ uint32_t a_off(int r, int vi) {
  return (uint32_t)(vi >> 3) * 8192u + swz128(r, vi & 7);
}

// Byte offset of column cc of row r in the staged h tile: two 64-column
// atoms of 128-byte rows in the layout of a 128-byte-swizzled TMA box.
__device__ __forceinline__ uint32_t hs_off(int r, int cc) {
  return (uint32_t)((cc >> 6) * 8192 + r * 128 +
                    ((((cc & 63) >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2);
}

// The same for an f32 tile: four 32-column atoms.
__device__ __forceinline__ uint32_t hs_off_f32(int r, int cc) {
  return (uint32_t)((cc >> 5) * 8192 + r * 128 +
                    ((((cc & 31) >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4);
}

// Bytes of a warpgroup's staging tile: f32 partials in or f32 values out
// take twice the bf16 tile.
template <class Epi>
__host__ __device__ constexpr int stage_bytes() {
  return Epi::kStagedF32 || Epi::kOutF32 ? 2 * kHs : kHs;
}

template <class Epi, bool kLn>
__global__ void __launch_bounds__(kThreads, 1)
edge_update_tc_kernel(const __grid_constant__ CUtensorMap efmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap smap, const Plan p,
                      const Epi epi, const __nv_bfloat16* __restrict__ ef,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      float* __restrict__ agg,
                      float* __restrict__ part_first,
                      float* __restrict__ part_last, int E, int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  const int S = p.stages, de = p.de, dout = p.dout, kp = p.kp;
  const int nk = de / 64, nkp = kp / 64, nq = de / kp;
  const int passes = dout / kCols, items_tile = passes * nk;
  constexpr bool staged_src = Epi::kStaged || Epi::kStagedF32;
  constexpr int kHsW = stage_bytes<Epi>();  // a warpgroup's staging tile
  const uint32_t full = base + p.off_bars;
  const uint32_t empty = full + 8 * kMaxStages;
  const uint32_t wbar = empty + 8 * kMaxStages;
  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int wl = (tid >> 5) & 3, lane = tid & 31;
  const uint32_t abar = wbar + 8 + 8 * wg;   // this warpgroup's A tile
  const uint32_t sbar = wbar + 24 + 8 * wg;  // and its staged partial tile
  const uint32_t a_bytes = (uint32_t)kRows * kp * 2;
  const uint32_t a_s = base + p.off_a + wg * a_bytes;
  unsigned char* a_g = smem + p.off_a + wg * a_bytes;
  unsigned char* hs = smem + p.off_hs + wg * kHsW;
  const uint32_t hs_s = base + p.off_hs + wg * kHsW;
  int* rls = reinterpret_cast<int*>(smem + p.off_rls) + wg * kRows;
  float* st_mean = reinterpret_cast<float*>(smem + p.off_stats) + wg * 2 * kRows;
  float* st_den = st_mean + kRows;

  const int my_tiles = (int)blockIdx.x < p.tiles
      ? (p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = my_tiles * items_tile;  // ring items of this block

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival a warpgroup
    }
    for (int i = 0; i < 5; ++i) mbar_init(wbar + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // W0 item j of a tile: pass j / nk, rows 64 (j % nk) .. of W0.
  auto load_item = [&](uint32_t dst, uint32_t bar, int j) {
    const int c = (j / nk) * kCols, k = (j % nk) * 64;
    tma_load(dst, &wmap, bar, c, k);
    tma_load(dst + 8192, &wmap, bar, c + 64, k);
  };
  // Ring item `it` into its stage, once both warpgroups handed it back.
  auto issue = [&](int it) {
    const int s = it % S;
    mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, kItem);
    load_item(base + s * kItem, full + 8 * s, it % items_tile);
  };
  // The warpgroup's 64-row tiles: 2 (blockIdx.x + t gridDim.x) + wg.  Its
  // leader (tw == 0) loads columns [q kp, q kp + kp) of their ef rows, and
  // the caller's staged partial of pass instance i = t * passes + pp into
  // the staging tile (where the warpgroup has rows).
  auto tile64_of = [&](int t) {
    return 2 * (int)(blockIdx.x + t * gridDim.x) + wg;
  };
  auto load_a = [&](int t64, int q) {
    mbar_expect_tx(abar, a_bytes);
    for (int b = 0; b < nkp; ++b)
      tma_load(a_s + b * 8192, &efmap, abar, q * kp + 64 * b, t64 * kRows);
  };
  auto load_src = [&](int i) {
    const int t64 = tile64_of(i / passes), c0 = (i % passes) * kCols;
    if (i >= my_tiles * passes || t64 * kRows >= E) return;
    constexpr int boxes = Epi::kStagedF32 ? 4 : 2;
    mbar_expect_tx(sbar, kHsW);
    for (int b = 0; b < boxes; ++b)
      tma_load(hs_s + 8192 * b, &smap, sbar, c0 + (kCols / boxes) * b,
               t64 * kRows);
  };
  // The staged partial's pair at row r, columns cc, cc + 1 of the pass.
  auto staged_pair = [&](int r, int cc) {
    if constexpr (Epi::kStagedF32)
      return *reinterpret_cast<const float2*>(hs + hs_off_f32(r, cc));
    else if constexpr (Epi::kStaged)
      return __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(hs + hs_off(r, cc)));
    else
      return make_float2(0.f, 0.f);
  };
  if (tid == 0 && my_tiles > 0) {
    if (S == 0) {
      mbar_expect_tx(wbar, de * dout * 2);
      for (int j = 0; j < items_tile; ++j) load_item(base + j * kItem, wbar, j);
    } else {
      for (int it = 0; it < min(S, total); ++it) issue(it);
    }
  }
  if (tw == 0 && my_tiles > 0) {
    if (nq == 1) load_a(tile64_of(0), 0);
    if (staged_src) load_src(0);
  }
  if (S == 0 && my_tiles > 0) mbar_wait(wbar, 0);

  // A consumed ring item's stage goes back (both warpgroups' arrivals
  // free it; thread 0 then refills it).
  auto release = [&](int item) {
    if (tw == 0) mbar_arrive(empty + 8 * (item % S));
    if (tid == 0 && item + S < total) issue(item + S);
  };
  int it = 0;                     // ring items consumed
  int held = -1;                  // an item whose products may still run
  uint32_t a_par = 0, s_par = 0;  // parities of the next A and staged loads
  for (int t = 0; t < my_tiles; ++t) {
    const int t64 = tile64_of(t);
    const int row0 = t64 * kRows;
    const int rows = min(kRows, E - row0);  // may be <= 0
    // (The warpgroup's last barrier of the previous tile follows its walk:
    // rls and the statistics are free.)
    if (tw < kRows) rls[tw] = tw < rows ? epi.receiver(row0 + tw) : -1;
    if (kLn && nq > 1)  // wide rows: statistics from device memory
      row_stats(tw, de, st_mean, st_den, [&](int r, int vi) {
        return r < rows ? *reinterpret_cast<const uint4*>(
                              ef + (size_t)(row0 + r) * de + 8 * vi)
                        : make_uint4(0u, 0u, 0u, 0u);
      });
    for (int pp = 0; pp < passes; ++pp) {
      const int c0 = pp * kCols;
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int q = 0; q < nq; ++q) {
        if (pp == 0 || nq > 1) {
          if (nq > 1) {
            // Wide rows: reload the piece once the warpgroup is done with
            // the last one (its products were waited on).
            wg_sync(1 + wg);
            if (tw == 0) load_a(t64, q);
          }
          mbar_wait(abar, a_par);
          a_par ^= 1;
          if (kLn) {
            if (nq == 1)
              row_stats(tw, de, st_mean, st_den, [&](int r, int vi) {
                return *reinterpret_cast<const uint4*>(a_g + a_off(r, vi));
              });
            wg_sync(1 + wg);
            // Normalise in place: ((x - mean) / den) * scale + bias, the
            // scale and bias without fused multiply-adds, rounded once to
            // bf16; one warp a row.  The quotient is the correctly rounded
            // one (normal range), from one reciprocal a row and a
            // fused-multiply-add correction (Markstein), not a division a
            // value.
            for (int vi = lane; vi < kp / 8; vi += 32) {
              const int c = q * kp + 8 * vi;
              const float4 s0 = *reinterpret_cast<const float4*>(scale + c);
              const float4 s1 = *reinterpret_cast<const float4*>(scale + c + 4);
              const float4 b0 = *reinterpret_cast<const float4*>(bias + c);
              const float4 b1 = *reinterpret_cast<const float4*>(bias + c + 4);
              const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
              const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll 4
              for (int r = wl; r < kRows; r += 4) {
                const float m = st_mean[r], dn = st_den[r];
                const float rd = __frcp_rn(dn);
                unsigned char* at = a_g + a_off(r, vi);
                float v[8];
                unpack8(*reinterpret_cast<const uint4*>(at), v);
                float y[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                  const float x = v[u] - m;
                  const float q0 = __fmul_rn(x, rd);
                  const float q1 = fmaf(fmaf(-q0, dn, x), rd, q0);
                  y[u] = __fadd_rn(__fmul_rn(q1, sc[u]), bi[u]);
                }
                uint4 packed;
                uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  pk[u] = pack_bf16(y[2 * u], y[2 * u + 1]);
                *reinterpret_cast<uint4*>(at) = packed;
              }
            }
            fence_proxy_async();  // the stores, before wgmma reads them
            wg_sync(1 + wg);
          }
        }
        for (int kk = 0; kk < nkp; ++kk) {
          uint32_t w_s;
          if (S == 0) {
            w_s = base + (pp * nk + q * nkp + kk) * kItem;
          } else {
            w_s = base + (it % S) * kItem;
            mbar_wait(full + 8 * (it % S), (it / S) & 1);
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma_m64n128k16<0, 1>(
                acc, make_desc(a_s + kk * 8192 + j * 32, 16),
                make_desc(w_s + j * 2048, 8192));
          wgmma_commit();
          if (S != 0) {
            // The item before this one is done: hand its stage back.
            wgmma_wait<1>();
            if (held >= 0) release(held);
            held = it++;
          }
        }
        if (q + 1 < nq) {  // the A piece is reloaded next
          wgmma_wait<0>();
          if (held >= 0) release(held);
          held = -1;
        }
      }
      // Whole rows: the tile's last product is issued, so the next tile's
      // rows may stream in under this epilogue once it completes.
      const bool prefetch = nq == 1 && pp == passes - 1 && t + 1 < my_tiles;

      // The caller's partials that do not need the product, while the
      // products run (the single graph's ((src + gb) + tr)).
      if (staged_src && rows > 0) {
        mbar_wait(sbar, s_par);
        s_par ^= 1;
      }
      float2 pre[2][16];
      if constexpr (Epi::kPreSum) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * wl + (lane >> 2) + 8 * half;
          if (r < rows) {
            const auto rw = epi.row(row0 + r, dout);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int cc = 8 * j + 2 * (lane & 3);
              pre[half][j] = epi.pre(rw, c0 + cc, staged_pair(r, cc));
            }
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (held >= 0) release(held);
      held = -1;
      if (prefetch && tw == 0) load_a(tile64_of(t + 1), 0);

      // Epilogue: the caller's partials in its order, one rounding, into
      // the staging tile (over the staged partial: each element is written
      // by the thread that read it, or, where an f32 partial sits under the
      // bf16 result, after the warpgroup has read all of it).  Thread (warp
      // wl, lane) holds rows 16 wl + lane / 4 (+ 8) and columns 8 j + 2
      // (lane % 4) (+ 1) of the pass.  Every load comes before the first
      // store to the staging tile (stores through a generic pointer would
      // order later loads behind them).
      if constexpr (Epi::kOutF32) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * wl + (lane >> 2) + 8 * half;
          if (r < rows) {
            const auto rw = epi.row(row0 + r, dout);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int cc = 8 * j + 2 * (lane & 3);
              *reinterpret_cast<float2*>(hs + hs_off_f32(r, cc)) =
                  epi.apply(rw, c0 + cc, acc[4 * j + 2 * half],
                            acc[4 * j + 2 * half + 1], make_float2(0.f, 0.f));
            }
          }
        }
      } else {
        uint32_t packed[2][16];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * wl + (lane >> 2) + 8 * half;
          if (r < rows) {
            const auto rw = epi.row(row0 + r, dout);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int cc = 8 * j + 2 * (lane & 3);
              const float a0 = acc[4 * j + 2 * half],
                          a1 = acc[4 * j + 2 * half + 1];
              float2 v;
              if constexpr (Epi::kPreSum)
                v = make_float2(pre[half][j].x + a0, pre[half][j].y + a1);
              else
                v = epi.apply(rw, c0 + cc, a0, a1, staged_pair(r, cc));
              packed[half][j] = pack_bf16(v.x, v.y);
            }
          }
        }
        if constexpr (Epi::kStagedF32) wg_sync(1 + wg);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * wl + (lane >> 2) + 8 * half;
          if (r < rows) {
#pragma unroll
            for (int j = 0; j < 16; ++j)
              *reinterpret_cast<uint32_t*>(
                  hs + hs_off(r, 8 * j + 2 * (lane & 3))) = packed[half][j];
          }
        }
      }
      fence_proxy_async();  // the staging tile, before the TMA store reads it
      wg_sync(1 + wg);
      if (tw == 0 && rows > 0) {  // rows past E are not written
        constexpr int boxes = Epi::kOutF32 ? 4 : 2;
        for (int b = 0; b < boxes; ++b)
          tma_store(&hmap, hs_s + 8192 * b, c0 + (kCols / boxes) * b, row0);
        bulk_commit();
      }
      if (agg != nullptr && rows > 0) {
        // Column c0 + tw, run by run of equal receivers, in row order.  The
        // runs' first rows, as a bit mask from two ballots of each warp.
        const int n0 = rls[lane], n1 = rls[32 + lane];
        const int p0 = lane > 0 ? rls[lane - 1] : -2, p1 = rls[31 + lane];
        const uint64_t starts =
            (uint64_t)__ballot_sync(0xffffffffu, lane < rows && n0 != p0) |
            ((uint64_t)__ballot_sync(0xffffffffu,
                                     32 + lane < rows && n1 != p1) << 32);
        const size_t prow = (size_t)t64 * dout + c0 + tw;
        uint64_t m = starts;
        while (m != 0) {
          const int s = __ffsll((long long)m) - 1;
          m &= m - 1;
          const int e = m != 0 ? __ffsll((long long)m) - 1 : rows;
          float sum = 0.f;
#pragma unroll 4
          for (int r = s; r < e; ++r)
            sum += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                hs + hs_off(r, tw)));
          const int node = rls[s];
          if (s == 0) part_first[prow] = sum;         // may continue before
          else if (e == rows) part_last[prow] = sum;  // may continue after
          else if (node >= 0 && node < N)
            agg[(size_t)node * dout + c0 + tw] = sum;
        }
      }
      if (tw == 0) bulk_wait_read<0>();  // the TMA store has read the tile
      wg_sync(1 + wg);  // the staging tile, rls and stats are free again
      if (tw == 0 && staged_src) load_src(t * passes + pp + 1);
    }
  }
  if (tw == 0) bulk_wait<0>();
}

// The node sums that cross tile boundaries.  Block t looks at tile t's
// first run (if it does not continue the previous tile's last run) and at
// its last run (if the tile holds more than one run): for each it adds this
// tile's partial row and the first-run partial rows of the following tiles
// for as long as they belong to the same node, in tile order.
__global__ void __launch_bounds__(256)
edge_agg_boundary_kernel(const int* __restrict__ rl,
                         const float* __restrict__ part_first,
                         const float* __restrict__ part_last,
                         float* __restrict__ agg, int E, int N, int dout,
                         int tile_rows, int tiles) {
  const int t = blockIdx.x;
  auto first_of = [&](int u) { return rl[(size_t)u * tile_rows]; };
  auto last_of = [&](int u) {
    return rl[min((size_t)E, (size_t)(u + 1) * tile_rows) - 1];
  };
  const int first = first_of(t), last = last_of(t);
  for (int which = 0; which < 2; ++which) {
    int node;
    const float* mine;
    if (which == 0) {
      if (t > 0 && last_of(t - 1) == first) continue;  // an earlier tile's
      node = first;
      mine = part_first;
    } else {
      if (last == first) continue;  // one run only: handled as the first
      node = last;
      mine = part_last;
    }
    if (node < 0 || node >= N) continue;
    // The tiles after t that the node's run reaches (u > t whose first row
    // is the node): galloping, then bisecting, over the tiles' first ids,
    // a few loads for a short run and log2 of its length for a long one.
    int lo = t, hi = tiles;
    for (int step = 1;; step *= 2) {
      const int probe = t + step;
      if (probe >= tiles || first_of(probe) != node) {
        hi = min(probe, tiles);
        break;
      }
      lo = probe;
    }
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (first_of(mid) == node) lo = mid; else hi = mid;
    }
    const int until = lo + 1;
    for (int c = threadIdx.x; c < dout; c += blockDim.x) {
      float sum = mine[(size_t)t * dout + c];
      // A hub or pad node spans hundreds of tiles: unrolled, so that the
      // independent loads are in flight together; the adds stay in order.
#pragma unroll 16
      for (int u = t + 1; u < until; ++u)
        sum += part_first[(size_t)u * dout + c];
      agg[(size_t)node * dout + c] = sum;
    }
  }
}

// ---- host side -------------------------------------------------------------

// The shared-memory plan for widths de, dout (multiples of 128) and a
// warpgroup's staging tile of hs_bytes: W0 resident with whole rows if
// both fit, else a ring of as many stages as fit (2-6) with whole rows,
// else rows held kp columns at a time (the largest multiple of 64 dividing
// de that fits beside a ring of 4, 3 or 2 stages).
inline int plan(Plan* p, int E, int de, int dout, int hs_bytes) {
  p->de = de;
  p->dout = dout;
  p->tiles = (E + 2 * kRows - 1) / (2 * kRows);
  const size_t fixed = 2 * (size_t)hs_bytes + 2 * kRows * 4 + 2 * 2 * kRows * 4 +
                       (2 * kMaxStages + 5) * 8 + 1024;
  auto a_bytes = [](int kp) { return (size_t)2 * kRows * kp * 2; };
  size_t w = 0;
  p->kp = 0;
  if ((size_t)de * dout * 2 + a_bytes(de) + fixed <= kMaxSmem) {
    p->kp = de;
    p->stages = 0;
    w = (size_t)de * dout * 2;
  }
  for (int s = kMaxStages; p->kp == 0 && s >= 2; --s)
    if ((size_t)s * kItem + a_bytes(de) + fixed <= kMaxSmem) {
      p->kp = de;
      p->stages = s;
    }
  for (int m = de / 64; p->kp == 0 && m >= 1; --m)
    if ((de / 64) % m == 0) {
      for (int s = 4; p->kp == 0 && s >= 2; --s)
        if ((size_t)s * kItem + a_bytes(64 * m) + fixed <= kMaxSmem) {
          p->kp = 64 * m;
          p->stages = s;
        }
    }
  if (p->kp == 0) return cudaErrorInvalidValue;
  if (p->stages != 0) w = (size_t)p->stages * kItem;
  p->off_a = (uint32_t)w;
  p->off_hs = p->off_a + (uint32_t)a_bytes(p->kp);
  p->off_rls = p->off_hs + 2 * hs_bytes;
  p->off_stats = p->off_rls + 2 * kRows * 4;
  p->off_bars = p->off_stats + 2 * 2 * kRows * 4;
  p->smem = p->off_bars + (2 * kMaxStages + 5) * 8 + 1024;
  return 0;
}

inline int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1)
    return 132;
  return n;
}

// Launches the core (and, with agg, the boundary pass) on `stream`.  agg
// [N, dout] f32 zero-filled by the caller, or null (then part_first,
// part_last and rl are unused); part_first / part_last [ceil(E / 64), dout]
// f32 scratch; `rl` the ascending receivers; `staged` the bf16 (f32 with
// Epi::kStagedF32) [E, dout] partial the epilogue reads through the staging
// tile (Epi::kStaged), else null; h bf16 (f32 with Epi::kOutF32).
template <class Epi>
int launch(const Epi& epi, const void* ef, const void* w0, const void* scale,
           const void* bias, const void* staged, void* h, void* agg,
           void* part_first, void* part_last, const int* rl, int E, int N,
           int de, int dout, int has_ln, cudaStream_t stream) {
  Plan p;
  int e;
  if ((e = plan(&p, E, de, dout, stage_bytes<Epi>())) != 0) return e;
  CUtensorMap em, wm, hm, sm;
  const int h_bytes = Epi::kOutF32 ? 4 : 2;
  if ((e = make_map(&em, ef, E, de, 64)) != 0) return e;
  if ((e = make_map(&wm, w0, de, dout, 64)) != 0) return e;
  if ((e = make_map(&hm, h, E, dout, 64, h_bytes)) != 0) return e;
  if ((e = staged != nullptr
               ? make_map(&sm, staged, E, dout, 64, Epi::kStagedF32 ? 4 : 2)
               : make_map(&sm, h, E, dout, 64, h_bytes)) != 0)
    return e;
  auto kernel = has_ln ? edge_update_tc_kernel<Epi, true>
                       : edge_update_tc_kernel<Epi, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const int grid = min(p.tiles, num_sms());
  kernel<<<grid, kThreads, p.smem, stream>>>(
      em, wm, hm, sm, p, epi, (const __nv_bfloat16*)ef, (const float*)scale,
      (const float*)bias, (float*)agg, (float*)part_first, (float*)part_last,
      E, N);
  err = cudaGetLastError();
  if (err != cudaSuccess || agg == nullptr) return err;
  const int tiles64 = (E + kRows - 1) / kRows;
  edge_agg_boundary_kernel<<<tiles64, 256, 0, stream>>>(
      rl, (const float*)part_first, (const float*)part_last, (float*)agg, E,
      N, dout, kRows, tiles64);
  return cudaGetLastError();
}

}  // namespace edge
}  // namespace gn
