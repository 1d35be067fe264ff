"""Per-graph feature extraction helpers (counterpart of
``graphnets_tpu/util.py``): copies of one graph's edge, node or graph
features as host arrays."""

from __future__ import annotations

import numpy as np

from .graph import GraphsTuple, _host_meta, _np

__all__ = ["get_edge_features", "get_node_features", "get_graph_features"]


def get_edge_features(g: GraphsTuple, graph_idx: int) -> np.ndarray:
    """Copy of graph ``graph_idx``'s edge features ``[E_i, DE]``."""
    if g.ef is None:
        raise ValueError("the batch has no edge features")
    _, _, _, _, edge_off = _host_meta(g)
    return np.array(_np(g.ef)[edge_off[graph_idx]:edge_off[graph_idx + 1]])


def get_node_features(g: GraphsTuple, graph_idx: int) -> np.ndarray:
    """Copy of graph ``graph_idx``'s node features ``[N_i, DN]``."""
    if g.nf is None:
        raise ValueError("the batch has no node features")
    _, _, _, node_off, _ = _host_meta(g)
    return np.array(_np(g.nf)[node_off[graph_idx]:node_off[graph_idx + 1]])


def get_graph_features(g: GraphsTuple, graph_idx: int) -> np.ndarray:
    """Copy of graph ``graph_idx``'s global features ``[DG]``."""
    if g.gf is None:
        raise ValueError("the batch has no graph features")
    return np.array(_np(g.gf)[graph_idx])
