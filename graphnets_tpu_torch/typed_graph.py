"""A graph with typed node and edge sets: several node tables, and edge
sets whose senders and receivers may index different tables (GraphCast's
``TypedGraph``, arXiv:2212.12794 §3: the grid and the mesh, joined by the
grid->mesh, mesh and mesh->grid edges).

Conventions, as ``graph.GraphsTuple`` keeps them for one node set:

* an edge set's ``receivers`` ascend, so the edge->node sum of a set is a
  sorted segment sum (``ops/scatter.segment_sum(..., sorted_pad_safe=True)``);
* padded rows sit after the real ones, and padded edges run from a padding
  node of their sender set to a padding node of their receiver set, so
  nothing of the padding reaches a real row (the pad-targets-pad rule).

It is a dataclass of tensors, dicts and host values, so ``utils/tree`` walks
it and ``capture_step`` copies it into its captured inputs like a
``GraphsTuple``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

__all__ = ["EdgeSet", "TypedGraph"]


@dataclasses.dataclass
class EdgeSet:
    """The edges of one edge set: ``senders`` / ``receivers [E]`` (int32
    ids into the sender and the receiver node set, receivers ascending)
    and ``features [E, F]``; the first ``num_real`` rows are real."""
    senders: torch.Tensor
    receivers: torch.Tensor
    features: torch.Tensor
    num_real: int


@dataclasses.dataclass
class TypedGraph:
    """Node features by node set (``nodes[name] [N, F]``), edge sets by
    name, and the real rows of each node set (the first
    ``num_real_nodes[name]``; the rest are padding)."""
    nodes: Dict[str, torch.Tensor]
    edges: Dict[str, EdgeSet]
    num_real_nodes: Dict[str, int]

    def with_nodes(self, **features: torch.Tensor) -> "TypedGraph":
        """The same graph with the named node sets' features replaced."""
        return dataclasses.replace(self, nodes={**self.nodes, **features})

    def num_nodes(self, name: str) -> int:
        """Rows of node set ``name``, padding included."""
        return self.nodes[name].shape[0]
