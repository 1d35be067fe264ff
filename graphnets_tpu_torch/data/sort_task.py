"""The list-sorting graph task (counterpart of the host generator in
``graphnets_tpu/data/sort_task.py``).

Graphs of ``n in [min_nodes, max_nodes]`` nodes, fully connected (with
self-loops); input node features are the one-hot of an integer in
``1..vocab_size``; node targets are the one-hot of "is the minimum"; edge
targets the one-hot of "the receiver follows the sender in sorted order"
(stable sort by value, ties broken by original position).

The generator is numpy on the host and draws exactly what the JAX
package's draws from the same ``numpy.random.Generator``, so both packages
see bit-equal batches.  The JAX package's on-device generator
(``device_batch``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..graph import GraphsTuple, PadSpec, batch

__all__ = ["SortTaskConfig", "gen_sample", "get_batch", "sort_pad_spec"]


@dataclasses.dataclass(frozen=True)
class SortTaskConfig:
    vocab_size: int = 100
    min_nodes: int = 2
    max_nodes: int = 10
    batch_size: int = 4


def _edge_targets(values: np.ndarray) -> np.ndarray:
    """Consecutive-in-sorted-order edge labels, in canonical (column-major)
    edge order on the fully connected graph."""
    n = len(values)
    order = np.argsort(values, kind="stable")  # ties -> original position
    mat = np.zeros((n, n), dtype=np.int64)
    for a, b in zip(order[:-1], order[1:]):
        mat[a, b] = 1
    # Column-major flatten = canonical edge order for the full graph.
    return mat.flatten(order="F")


def gen_sample(rng: np.random.Generator, cfg: SortTaskConfig):
    """One sample: ``(adj, x_nf [n, V], y_nf [n, 2], y_ef [n*n, 2],
    values)``."""
    n = int(rng.integers(cfg.min_nodes, cfg.max_nodes + 1))
    adj = np.ones((n, n), dtype=np.int64)
    values = rng.integers(1, cfg.vocab_size + 1, size=n)
    x_nf = np.eye(cfg.vocab_size, dtype=np.float32)[values - 1]
    is_min = (values == values.min()).astype(np.int64)
    y_nf = np.eye(2, dtype=np.float32)[is_min]
    y_ef = np.eye(2, dtype=np.float32)[_edge_targets(values)]
    return adj, x_nf, y_nf, y_ef, values


def sort_pad_spec(cfg: SortTaskConfig, uniform: bool = False) -> PadSpec:
    """Static pad sizes covering the worst case, so every batch has one
    shape.

    ``uniform=True``: the uniform slot layout (``PadSpec.uniform``): every
    graph slot owns ``max_nodes + 1`` node slots (one reserved padding
    node, rounded up) and ``max_nodes**2`` edge slots (rounded up to a
    multiple of 128).  This sets ``slot_shape``, which the fused
    edge-update kernel needs."""
    if uniform:
        return PadSpec.uniform(cfg.max_nodes + 1, cfg.max_nodes ** 2)
    max_n = cfg.batch_size * cfg.max_nodes
    max_e = cfg.batch_size * cfg.max_nodes ** 2
    return PadSpec(
        num_nodes=max_n + 1,
        num_edges=((max_e + 127) // 128) * 128,
        num_graphs=cfg.batch_size + 1,
    )


def get_batch(rng: np.random.Generator, cfg: SortTaskConfig,
              pad: Optional[PadSpec] = None, device=None
              ) -> Tuple[GraphsTuple, GraphsTuple]:
    """One (input, target) batched pair of one fixed shape, on ``device``
    (``cuda`` unless the caller passes another)."""
    pad = pad or sort_pad_spec(cfg)
    samples = [gen_sample(rng, cfg) for _ in range(cfg.batch_size)]
    adjs = [s[0] for s in samples]
    x = batch({"graphs": adjs, "ef": None,
               "nf": [s[1] for s in samples], "gf": None}, pad=pad,
              device=device)
    y = batch({"graphs": adjs, "ef": [s[3] for s in samples],
               "nf": [s[2] for s in samples], "gf": None}, pad=pad,
              device=device)
    return x, y
