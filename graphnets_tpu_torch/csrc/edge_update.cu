// Fused edge update with the edge->node sum, for uniform slot layouts.
//
// Replaces the Pallas kernel of `fused_edge_update_agg` and
// `fused_edge_update` (graphnets_tpu/ops/pallas/edge_update.py, `_kernel`
// and `_forward`; the second writes h alone, here with agg == nullptr):
//
//   h[e]   = bf16( (((f32(bf16(LN(ef[e])) @ W0) + ts[s[e]]) + tr[r[e]])
//                  + tg[e / e_slots]) + b )
//   agg[n] = f32 sum of the ROUNDED h[e] over the edges with r[e] == n
//
// What bounds it on the H100: at the main-path shape (E = 16384,
// de = dout = 384, N = 1024) it moves ~30 MB (read ef, write h, read the
// f32 partial tables, write agg) for 4.8 GFLOP, so the bound is the
// memory: ~9 us at 3.35 TB/s against ~5 us of bf16 tensor-core work.
//
// What the design does about it: the wgmma + TMA core of edge_wgmma.cuh.
// A block takes 128 edge rows at a time (a partition by edge rows, so its
// work does not depend on the degrees), normalises them once, and makes
// every output column from W0 streamed in k-chunks through a ring (shared
// memory does not depend on de, so every width the JAX gate admits runs
// here).  The TPU kernel's one-hot MXU gathers and hi/lo bf16 split are
// gone: the epilogue reads the f32 partial rows ts[s], tr[r], tg[g]
// directly (a graph's node window sits in L2).  The edge->node sum walks
// the rounded h of each 64-row tile and completes the nodes that cross a
// tile boundary in a second pass, in tile order: no atomics, deterministic.

#include "edge_wgmma.cuh"

namespace {

// The uniform layout's partials, added in the TPU kernel's order.
struct Uniform {
  const float* ts;
  const float* tr;
  const float* tg;
  const float* b;
  const int* senders;
  const int* receivers;
  int e_slots;

  // The product comes first in the order: nothing to add before it, and
  // nothing staged.
  static constexpr bool kPreSum = false;
  static constexpr bool kStaged = false;
  static constexpr bool kStagedF32 = false;
  static constexpr bool kOutF32 = false;

  struct Row {
    const float* s;
    const float* r;
    const float* g;
  };
  __device__ __forceinline__ int receiver(int e) const { return receivers[e]; }
  __device__ __forceinline__ Row row(int e, int dout) const {
    return {ts + (size_t)senders[e] * dout, tr + (size_t)receivers[e] * dout,
            tg + (size_t)(e / e_slots) * dout};
  }
  __device__ __forceinline__ float2 apply(const Row& w, int c, float a0,
                                          float a1, float2) const {
    const float2 vs = *reinterpret_cast<const float2*>(w.s + c);
    const float2 vr = *reinterpret_cast<const float2*>(w.r + c);
    const float2 vg = *reinterpret_cast<const float2*>(w.g + c);
    const float2 vb = *reinterpret_cast<const float2*>(b + c);
    return make_float2((((a0 + vs.x) + vr.x) + vg.x) + vb.x,
                       (((a1 + vs.y) + vr.y) + vg.y) + vb.y);
  }
};

}  // namespace

// Rows of ef a partial row of the edge->node sum covers.
extern "C" int gn_edge_update_tile_rows() { return gn::edge::kRows; }

// Launches the kernel (and, with agg, the boundary pass) on `stream` and
// returns the first launch error.  `agg` may be null: then only h is
// written (`fused_edge_update`).  With agg: agg [N, dout] f32 zero-filled
// by the caller, part_first and part_last [ceil(E / 64), dout] f32
// scratch.  Preconditions, checked by the Python wrapper: bf16 ef [E, de]
// and w0 [de, dout], f32 ts / tr [N, dout], tg [G, dout], b [dout], scale
// and bias [de], int32 ids with ascending receivers in [0, N), de % 128 ==
// 0, dout % 128 == 0, contiguous 16-byte-aligned row-major tensors.
extern "C" int gn_edge_update(const void* ef, const void* w0, const void* ts,
                              const void* tr, const void* tg, const void* b,
                              const void* scale, const void* bias,
                              const void* senders, const void* receivers,
                              void* h, void* agg, void* part_first,
                              void* part_last, int E, int N, int de, int dout,
                              int e_slots, int use_ln, void* stream) {
  const Uniform epi{(const float*)ts, (const float*)tr, (const float*)tg,
                    (const float*)b, (const int*)senders,
                    (const int*)receivers, e_slots};
  return gn::edge::launch(epi, ef, w0, scale, bias, nullptr, h, agg,
                          part_first,
                          part_last, (const int*)receivers, E, N, de, dout,
                          use_ln, (cudaStream_t)stream);
}
