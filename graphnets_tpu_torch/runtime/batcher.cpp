// Native host-side graph runtime of the PyTorch port: COO batching, CSC
// construction, fixed-fanout neighbour sampling, row gathers and edge
// partitioning.
//
// The port's own copy of the JAX package's graphnets_tpu/runtime/batcher.cpp,
// with the same functions, the same arithmetic and the same xorshift128+
// streams, so that both packages build the same index arrays and draw the
// same sampled batches from one seed.  These are the host hot loops that
// feed the device static-shaped index arrays.  Exposed as a plain C ABI for
// ctypes (runtime/native.py builds and loads it).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread batcher.cpp -o libgraphnets.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Canonical COO extraction from a batch of dense adjacency matrices.
//
// adj: int8 row-major [sum n_i^2]; ns: [B] node counts.
// Canonical edge order (parity with the reference, src/pad.jl:30): receiver
// (column) varies slowest, sender (row) fastest; entry counts iff == 1.
// Outputs must be preallocated: senders/receivers [max_edges],
// n_edge [B].  Returns total edge count, or -1 if max_edges exceeded.
int64_t gt_batch_coo(const int8_t* adj, const int64_t* ns, int64_t B,
                     int32_t* senders, int32_t* receivers, int32_t* n_edge,
                     int64_t max_edges) {
  int64_t e = 0;
  int64_t adj_off = 0;
  int64_t node_off = 0;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t n = ns[b];
    const int8_t* a = adj + adj_off;
    int64_t e0 = e;
    for (int64_t j = 0; j < n; ++j) {       // receiver (column) outer
      for (int64_t i = 0; i < n; ++i) {     // sender (row) inner
        if (a[i * n + j] == 1) {
          if (e >= max_edges) return -1;
          senders[e] = static_cast<int32_t>(node_off + i);
          receivers[e] = static_cast<int32_t>(node_off + j);
          ++e;
        }
      }
    }
    n_edge[b] = static_cast<int32_t>(e - e0);
    adj_off += n * n;
    node_off += n;
  }
  return e;
}

// ---------------------------------------------------------------------------
// CSC-by-destination from COO (counting sort by receiver) — stable, O(E).
// indptr: [N+1] out; src_out: [E] out.
void gt_csc_from_coo(const int64_t* senders, const int64_t* receivers,
                     int64_t E, int64_t N, int64_t* indptr,
                     int64_t* src_out) {
  std::memset(indptr, 0, sizeof(int64_t) * (N + 1));
  for (int64_t k = 0; k < E; ++k) indptr[receivers[k] + 1]++;
  for (int64_t v = 0; v < N; ++v) indptr[v + 1] += indptr[v];
  // temp cursor
  int64_t* cur = new int64_t[N];
  std::memcpy(cur, indptr, sizeof(int64_t) * N);
  for (int64_t k = 0; k < E; ++k) {
    src_out[cur[receivers[k]]++] = senders[k];
  }
  delete[] cur;
}

// ---------------------------------------------------------------------------
// xorshift128+ PRNG (deterministic, fast)
static inline uint64_t xs128(uint64_t* s) {
  uint64_t x = s[0];
  const uint64_t y = s[1];
  s[0] = y;
  x ^= x << 23;
  s[1] = x ^ y ^ (x >> 17) ^ (y >> 26);
  return s[1] + y;
}

// Fixed-fanout sampling of incoming edges for one frontier layer.
//
// For each frontier node v (local position pos[i]), sample up to `fanout`
// distinct incoming edges from CSC (indptr/src).  Appends:
//   sampled_src[out_k]  = global source node id
//   recv_pos[out_k]     = frontier position (local subgraph node index)
// Returns number of sampled edges.  Sampling: Fisher-Yates on a local index
// buffer when deg > fanout; all edges otherwise.
int64_t gt_sample_layer(const int64_t* indptr, const int64_t* src,
                        const int64_t* frontier, const int64_t* pos,
                        int64_t n_frontier, int64_t fanout, uint64_t seed,
                        int64_t* sampled_src, int64_t* recv_pos,
                        int64_t max_out) {
  uint64_t st[2] = {seed ^ 0x9E3779B97F4A7C15ull, seed | 1ull};
  int64_t out = 0;
  // scratch for partial Fisher-Yates (bounded by max degree we touch)
  int64_t scratch_cap = 0;
  int64_t* scratch = nullptr;
  for (int64_t i = 0; i < n_frontier; ++i) {
    const int64_t v = frontier[i];
    const int64_t lo = indptr[v], hi = indptr[v + 1];
    const int64_t d = hi - lo;
    if (d <= 0) continue;
    const int64_t k = d < fanout ? d : fanout;
    if (out + k > max_out) return -1;
    if (d <= fanout) {
      for (int64_t t = 0; t < d; ++t) {
        sampled_src[out] = src[lo + t];
        recv_pos[out] = pos[i];
        ++out;
      }
    } else {
      if (d > scratch_cap) {
        delete[] scratch;
        scratch_cap = d * 2;
        scratch = new int64_t[scratch_cap];
      }
      for (int64_t t = 0; t < d; ++t) scratch[t] = lo + t;
      for (int64_t t = 0; t < k; ++t) {  // partial Fisher-Yates
        const int64_t r = t + (int64_t)(xs128(st) % (uint64_t)(d - t));
        std::swap(scratch[t], scratch[r]);
        sampled_src[out] = src[scratch[t]];
        recv_pos[out] = pos[i];
        ++out;
      }
    }
  }
  delete[] scratch;
  return out;
}

// ---------------------------------------------------------------------------
// Parallel fixed-fanout sampling (the per-seed loops are independent,
// so the layer parallelizes across frontier chunks).
//
// Two-pass: per-node sample counts + exclusive prefix sum give each node a
// private output range, then threads fill disjoint chunks.  Each frontier
// node draws from its OWN xorshift stream seeded by (seed, i), so results
// are deterministic and independent of the thread count (they differ from
// gt_sample_layer's single sequential stream — both are valid uniform
// fixed-fanout draws).
static void sample_range(const int64_t* indptr, const int64_t* src,
                         const int64_t* frontier, const int64_t* pos,
                         int64_t lo_i, int64_t hi_i, int64_t fanout,
                         uint64_t seed, const int64_t* offs,
                         int64_t* sampled_src, int64_t* recv_pos) {
  int64_t scratch_cap = 0;
  int64_t* scratch = nullptr;
  for (int64_t i = lo_i; i < hi_i; ++i) {
    const int64_t v = frontier[i];
    const int64_t lo = indptr[v], hi = indptr[v + 1];
    const int64_t d = hi - lo;
    if (d <= 0) continue;
    int64_t out = offs[i];
    if (d <= fanout) {
      for (int64_t t = 0; t < d; ++t) {
        sampled_src[out] = src[lo + t];
        recv_pos[out] = pos[i];
        ++out;
      }
    } else {
      uint64_t st[2] = {
          seed ^ (0x9E3779B97F4A7C15ull * (uint64_t)(i + 1)),
          (seed + 0xD1B54A32D192ED03ull * (uint64_t)(i + 1)) | 1ull};
      xs128(st);  // decorrelate nearby seeds
      if (d > scratch_cap) {
        delete[] scratch;
        scratch_cap = d * 2;
        scratch = new int64_t[scratch_cap];
      }
      for (int64_t t = 0; t < d; ++t) scratch[t] = lo + t;
      const int64_t k = fanout;
      for (int64_t t = 0; t < k; ++t) {  // partial Fisher-Yates
        const int64_t r = t + (int64_t)(xs128(st) % (uint64_t)(d - t));
        std::swap(scratch[t], scratch[r]);
        sampled_src[out] = src[scratch[t]];
        recv_pos[out] = pos[i];
        ++out;
      }
    }
  }
  delete[] scratch;
}

int64_t gt_sample_layer_par(const int64_t* indptr, const int64_t* src,
                            const int64_t* frontier, const int64_t* pos,
                            int64_t n_frontier, int64_t fanout,
                            uint64_t seed, int64_t* sampled_src,
                            int64_t* recv_pos, int64_t max_out,
                            int64_t n_threads) {
  std::vector<int64_t> offs(n_frontier + 1);
  offs[0] = 0;
  for (int64_t i = 0; i < n_frontier; ++i) {
    int64_t d = indptr[frontier[i] + 1] - indptr[frontier[i]];
    if (d < 0) d = 0;
    offs[i + 1] = offs[i] + (d < fanout ? d : fanout);
  }
  const int64_t total = offs[n_frontier];
  if (total > max_out) return -1;
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n_frontier < 1024) {
    sample_range(indptr, src, frontier, pos, 0, n_frontier, fanout, seed,
                 offs.data(), sampled_src, recv_pos);
    return total;
  }
  std::vector<std::thread> ts;
  const int64_t chunk = (n_frontier + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(lo + chunk, n_frontier);
    if (lo >= hi) break;
    ts.emplace_back(sample_range, indptr, src, frontier, pos, lo, hi,
                    fanout, seed, offs.data(), sampled_src, recv_pos);
  }
  for (auto& th : ts) th.join();
  return total;
}

// ---------------------------------------------------------------------------
// Parallel float32 row gather: out[i] = in[idx[i]] (feature assembly for
// sampled subgraphs; numpy fancy indexing is single-threaded).
void gt_gather_rows_f32_par(const float* in, const int64_t* idx, int64_t n,
                            int64_t d, float* out, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * d, in + idx[i] * d, sizeof(float) * d);
    }
  };
  if (n_threads == 1 || n < 4096) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// Edge partitioning: owner = min(receiver / nodes_per_shard, S-1); returns
// per-shard counts and shard-grouped permutation (stable within shard).
void gt_partition_edges(const int64_t* receivers, int64_t E,
                        int64_t nodes_per_shard, int64_t S,
                        int64_t* counts, int64_t* perm) {
  std::memset(counts, 0, sizeof(int64_t) * S);
  for (int64_t k = 0; k < E; ++k) {
    int64_t o = receivers[k] / nodes_per_shard;
    if (o >= S) o = S - 1;
    counts[o]++;
  }
  int64_t* cur = new int64_t[S];
  int64_t acc = 0;
  for (int64_t s = 0; s < S; ++s) { cur[s] = acc; acc += counts[s]; }
  for (int64_t k = 0; k < E; ++k) {
    int64_t o = receivers[k] / nodes_per_shard;
    if (o >= S) o = S - 1;
    perm[cur[o]++] = k;
  }
  delete[] cur;
}

// ---------------------------------------------------------------------------
// Greedy min-edge-cut refinement of a node->shard assignment (an FM-style
// relaxation): repeatedly move a node to the shard holding the plurality of
// its neighbors when that strictly reduces the cut and the target shard is
// under the balance cap.  Undirected CSR (indptr/adj over both edge
// directions).  assign: [N] in/out.  Returns the number of moves applied.
int64_t gt_refine_partition(const int64_t* indptr, const int64_t* adj,
                            int64_t N, int64_t S, int64_t cap,
                            int64_t passes, int64_t* assign) {
  int64_t* counts = new int64_t[S]();
  int64_t* hist = new int64_t[S]();
  for (int64_t v = 0; v < N; ++v) counts[assign[v]]++;
  int64_t moves = 0;
  for (int64_t p = 0; p < passes; ++p) {
    int64_t moved = 0;
    for (int64_t v = 0; v < N; ++v) {
      const int64_t cur = assign[v];
      const int64_t lo = indptr[v], hi = indptr[v + 1];
      if (hi == lo) continue;
      // Histogram of neighbor shards (only shards seen get touched).
      for (int64_t k = lo; k < hi; ++k) hist[assign[adj[k]]]++;
      int64_t best = cur, best_n = hist[cur];
      for (int64_t k = lo; k < hi; ++k) {
        const int64_t s = assign[adj[k]];
        if (hist[s] > best_n && (s == cur || counts[s] < cap)) {
          best = s;
          best_n = hist[s];
        }
      }
      for (int64_t k = lo; k < hi; ++k) hist[assign[adj[k]]] = 0;
      if (best != cur) {
        assign[v] = best;
        counts[cur]--;
        counts[best]++;
        ++moved;
        ++moves;
      }
    }
    if (moved == 0) break;
  }
  delete[] counts;
  delete[] hist;
  return moves;
}

// Scatter float32 feature rows by an index permutation: out[i] = in[perm[i]].
void gt_gather_rows_f32(const float* in, const int64_t* perm, int64_t n,
                        int64_t d, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * d, in + perm[i] * d, sizeof(float) * d);
  }
}

}  // extern "C"
