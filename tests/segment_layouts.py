"""Sorted segment-id layouts for the sorted segment sum's tests.

Module data only (no JAX, no torch), shared by
``tests/test_torch_segment_layouts.py`` (the port's plain route against
the JAX package's Pallas kernel in interpret mode, on the CPU) and
``tests/test_torch_cuda.py`` (the CUDA kernel against its plain version,
on the card).  Every layout is ascending and has a row count divisible by
128, as the JAX package's kernel route requires.

``LAYOUTS[name](rng) -> (ids int32 [E], num_segments)``.
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
