"""Segment-id layouts for the segment sums' tests, and the summation order
of the one-pass kernel for few rows.

Module data and numpy only (no JAX, no torch), shared by
``tests/test_torch_segment_layouts.py`` and ``tests/test_torch_small_sums.py``
(the port's plain route against the JAX package's Pallas kernel in
interpret mode, on the CPU) and ``tests/test_torch_cuda.py`` (the CUDA
kernels against their plain versions, on the card).  Every sorted layout
is ascending and has a row count divisible by 128, as the JAX package's
kernel route requires.

``LAYOUTS[name](rng) -> (ids int32 [E], num_segments)``;
``WINDOWS[name] = (nodes, edges)`` a graph, for ``windowed_layout``.
"""

import numpy as np


def _headline(rng):
    """``bench.py``'s receivers: 1024 nodes of in-degree 16, E = 16384."""
    return np.repeat(np.arange(1024), 16), 1024


def _bucketed(rng):
    """The headline's eight graphs bucket-padded
    (``PadSpec.bucketed(1024, 16384, 8, node_multiple=32)``): an edgeless
    ninth graph owns the last 32 node slots."""
    return np.repeat(np.arange(1024), 16), 1056


def _hub(rng):
    """Power-law receivers (p ~ 1 / (rank + 10)) over 2048 nodes with one
    hub of 3000 rows: the hub spans many chunks."""
    p = 1.0 / (np.arange(2047) + 10.0)
    ids = rng.choice(2047, size=16384 - 3000, p=p / p.sum())
    return np.concatenate([ids, np.full(3000, 700)]), 2048


def _pad_node(rng):
    """A sampled subgraph's shape: a tenth of the rows are real edges over
    the first 600 nodes, the rest pad edges on node 600, and the 1400 node
    slots after it have no edge."""
    E = 8192
    real = rng.integers(0, 600, size=E // 10)
    return np.concatenate([real, np.full(E - real.size, 600)]), 2001


def _empty_runs(rng):
    """Runs of empty segments at the start (0-99), in the middle (a gap of
    300 and gaps of one) and at the end (the last 250)."""
    ids = np.concatenate([rng.integers(100, 400, size=1500),
                          rng.integers(700, 1750, size=2596)])
    ids = ids[(ids % 7) != 3]
    ids = np.concatenate([ids, np.full(4096 - ids.size, 1000)])
    return ids, 2000


def _out_of_range(rng):
    """Ids below 0 and at or above S, which the sum drops."""
    ids = np.concatenate([np.full(200, -3), np.full(57, -1),
                          rng.integers(0, 500, size=3383),
                          np.full(300, 500), np.full(156, 777)])
    return ids, 500


def _chunk_edges(rng):
    """Segments that end exactly on 128- and 256-row edges (lengths 128,
    128, 256, 64, 64, 2048, 1, 127, 256, twice, then one of 2048)."""
    lengths = np.array([128, 128, 256, 64, 64, 2048, 1, 127, 256] * 2
                       + [2048])
    return np.repeat(np.arange(lengths.size), lengths), lengths.size + 3


def _e128(rng):
    """The smallest row count the JAX gate takes: E = 128."""
    return rng.integers(0, 40, size=128), 50


LAYOUTS = {
    "headline": _headline,
    "bucketed": _bucketed,
    "hub": _hub,
    "pad_node": _pad_node,
    "empty_runs": _empty_runs,
    "out_of_range": _out_of_range,
    "chunk_edges": _chunk_edges,
    "e128": _e128,
}


def layout(name, seed=0):
    """Ascending int32 ids of layout ``name`` and its segment count."""
    ids, num_segments = LAYOUTS[name](np.random.default_rng(seed))
    ids = np.sort(np.asarray(ids)).astype(np.int32)
    assert ids.size % 128 == 0, (name, ids.size)
    return ids, num_segments


# Windowed-sum layouts: (node count, edge count) a graph.  The sort
# task's five small graphs (a 16-segment tile spans several; padded, one
# node takes more rows than a warp batches), the headline
# (eight 128-node graphs of 2,048 edges), the bucketed headline (a ninth,
# edgeless padding graph of 32 nodes), empty graphs between full ones,
# windows longer than one sorted piece of 2,048 edges, and the sort
# task's uniform device layout (four graphs of 16 node and 128 edge slots,
# pad edges on each graph's last node).
WINDOWS = {
    "sort": ([8, 9, 7, 9, 8], [100, 110, 90, 112, 100]),
    # the sort task's padded batch: a pad node sends 297 of 512 edges
    "sort_pad_node": ([9, 7, 7, 6, 12], [81, 49, 49, 36, 297]),
    "sort_uniform": ([16] * 4, [128] * 4),
    "headline": ([128] * 8, [2048] * 8),
    "bucketed": ([128] * 8 + [32], [2048] * 8 + [0]),
    "empty_graphs": ([5, 0, 20, 0, 3, 17], [40, 0, 0, 0, 30, 200]),
    "long_windows": ([16, 40, 1], [5000, 9000, 3]),
}


def windowed_layout(name, seed=24):
    """``(senders, receivers, node_offsets, edge_offsets)`` of layout
    ``name`` (int32): senders unsorted within each graph, receivers
    ascending; ``sort_pad_node``'s last graph and each ``sort_uniform``
    graph send and receive their last 28 edges on one node."""
    nodes, edges = WINDOWS[name]
    rng = np.random.default_rng(seed)
    no = np.concatenate([[0], np.cumsum(nodes)]).astype(np.int32)
    eo = np.concatenate([[0], np.cumsum(edges)]).astype(np.int32)
    snd, rcv = [], []
    for i in range(len(nodes)):
        hi = max(no[i + 1], no[i] + 1)
        s = rng.integers(no[i], hi, size=edges[i])
        r = np.sort(rng.integers(no[i], hi, size=edges[i]))
        if name == "sort_uniform":
            s[-28:] = no[i + 1] - 1
            r = np.sort(np.concatenate([r[:-28], np.full(28, no[i + 1] - 1)]))
        snd.append(s)
        rcv.append(r)
    snd, rcv = (np.concatenate(a).astype(np.int32) for a in (snd, rcv))
    if name == "sort_pad_node":
        snd[eo[-2]:] = rcv[eo[-2]:] = no[-2]
    return snd, rcv, no, eo


def small_sum_order(x, seg, num_segments, tile, subwarps, windows=None):
    """The one-pass kernel's f32 sums (``csrc/segment_sum.cu``,
    ``small_segment_sum_kernel``) in numpy float32, in its order: each
    tile of ``tile`` segments takes its window of rows (sorted ids: the
    rows whose ids lie in the tile; ``windows=(node_offsets,
    edge_offsets)``: the edges of the graphs that the tile meets), sub-warp
    k adds the k-th of ``subwarps`` contiguous parts of the window in edge
    order into partial rows of 0, and a segment's sum is the partials added
    in sub-warp order.  Returns ``(sums [S, D] f32, hits [E])``, hits the
    number of times each row was added."""
    x = np.asarray(x, np.float32)
    seg = np.asarray(seg)
    E = seg.shape[0]
    out = np.zeros((num_segments, x.shape[1]), np.float32)
    hits = np.zeros(E, np.int64)
    G = 0 if windows is None else len(windows[0]) - 1
    for n0 in range(0, num_segments, tile):
        n1 = n0 + tile
        if windows is None:
            w0, w1 = np.searchsorted(seg, [n0, n1], side="left")
        else:
            no, eo = windows
            g_lo = min(max(np.searchsorted(no, n0, side="right") - 1, 0), G)
            g_hi = min(max(np.searchsorted(no, n1, side="left"), 0), G)
            w0, w1 = eo[g_lo], max(eo[g_hi], eo[g_lo])
        W = int(w1 - w0)
        parts = np.zeros((subwarps, tile, x.shape[1]), np.float32)
        for k in range(subwarps):
            for r in range(w0 + W * k // subwarps, w0 + W * (k + 1) // subwarps):
                s = int(seg[r]) - n0
                if 0 <= s < tile:
                    parts[k, s] = parts[k, s] + x[r]
                    hits[r] += 1
        for s in range(tile):
            if n0 + s < num_segments:
                acc = np.zeros(x.shape[1], np.float32)
                for k in range(subwarps):
                    acc = acc + parts[k, s]
                out[n0 + s] = acc
    return out, hits
