"""Gather / segment-aggregation primitives of the PyTorch port (forward
semantics of ``graphnets_tpu/ops/scatter.py``).

All aggregations accumulate in float32 and mask padded slots, so padding
never contaminates real slots.  The JAX package takes a one-hot matmul at
``Precision.HIGHEST`` for <= 64 segments (the graph pools); that is the
same float32 sum, which here is an ``index_add_``, so no TF32 matmul is
ever involved.  With kernels on, a ``sorted_pad_safe`` sum over more than
64 segments takes the sorted segment-sum kernel instead
(``ops/kernels/segment_sum``), as the JAX package does
(``scatter.py:227-232``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.config import use_kernels

__all__ = [
    "gather_nodes",
    "segment_sum",
    "aggregate_edges_for_nodes",
    "aggregate_edges_for_globals",
    "aggregate_nodes_for_globals",
    "broadcast_globals_to_edges",
    "broadcast_globals_to_nodes",
]


def _mask_rows(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask[:, None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def gather_nodes(nf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``nf[idx]``: node rows gathered onto edge slots."""
    return nf.index_select(0, idx)


def segment_sum(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                sorted_pad_safe: bool = False) -> torch.Tensor:
    """Masked segment sum with float32 accumulation, cast back to
    ``x.dtype``.

    ``sorted_pad_safe`` declares the batch layout's contract: ids ascend
    and padded rows target only segments no real row targets, so the mask
    is redundant.  With kernels on and more than 64 segments such a sum
    takes the sorted segment-sum kernel, which skips the mask."""
    if sorted_pad_safe and use_kernels() and num_segments > 64:
        from .kernels.segment_sum import (sorted_segment_sum,
                                          supports_sorted_segment_sum)
        if supports_sorted_segment_sum(x.shape[0], num_segments,
                                       x.shape[-1]):
            return sorted_segment_sum(x, segment_ids, num_segments)
    acc = torch.zeros((num_segments,) + tuple(x.shape[1:]),
                      dtype=torch.float32, device=x.device)
    acc.index_add_(0, segment_ids, _mask_rows(x, mask).float())
    return acc.to(x.dtype)


def aggregate_edges_for_nodes(ef: torch.Tensor, receivers: torch.Tensor,
                              num_nodes: int,
                              edge_mask: Optional[torch.Tensor]
                              ) -> torch.Tensor:
    """Sum of incoming-edge features per destination node (receivers
    ascend and padded edges target padding nodes)."""
    return segment_sum(ef, receivers, num_nodes, edge_mask,
                       sorted_pad_safe=True)


def aggregate_edges_for_globals(ef: torch.Tensor, edge_graph: torch.Tensor,
                                num_graphs: int,
                                edge_mask: Optional[torch.Tensor]
                                ) -> torch.Tensor:
    """Sum-pool over real edges per graph."""
    return segment_sum(ef, edge_graph, num_graphs, edge_mask)


def aggregate_nodes_for_globals(nf: torch.Tensor, node_graph: torch.Tensor,
                                num_graphs: int,
                                node_mask: Optional[torch.Tensor]
                                ) -> torch.Tensor:
    """Sum-pool over real nodes per graph."""
    return segment_sum(nf, node_graph, num_graphs, node_mask)


def broadcast_globals_to_edges(gf: torch.Tensor,
                               edge_graph: torch.Tensor) -> torch.Tensor:
    """Graph features tiled onto edge slots."""
    return gf.index_select(0, edge_graph)


def broadcast_globals_to_nodes(gf: torch.Tensor,
                               node_graph: torch.Tensor) -> torch.Tensor:
    """Graph features tiled onto node slots."""
    return gf.index_select(0, node_graph)
