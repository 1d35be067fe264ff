"""The list-sorting task's batches worked out from their draws, for the
plain reference (GraphNets.jl ``examples/sort/helper.jl`` and
``sort.jl:12-46``).

A graph of ``n`` nodes holds the integers ``values`` (1..vocab).  It is
fully connected with self-edges, its edges listed in column-major order of
the adjacency (edge ``k`` goes from node ``k % n`` to node ``k // n``).
The input node features are the one-hot of ``values - 1``; the node
target is the one-hot of "is a minimum" (every tie counts); the edge
target is the one-hot of "the receiver directly follows the sender in the
stable sort of the values" (ties broken by position).  It imports nothing
of the program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .gn import Graphs


def _one_hot(idx: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx.long(), k).float()


def sort_graphs(values: Sequence[torch.Tensor], vocab: int, device
                ) -> Tuple[Graphs, Graphs]:
    """The input and the target batch of the graphs holding ``values``
    (one 1-D integer tensor a graph)."""
    senders, receivers, node_graph, edge_graph = [], [], [], []
    x_nf, y_nf, y_ef = [], [], []
    off = 0
    for b, v in enumerate(values):
        v = v.long().cpu()
        n = v.numel()
        k = torch.arange(n * n)
        senders.append(off + k % n)
        receivers.append(off + k // n)
        node_graph.append(torch.full((n,), b))
        edge_graph.append(torch.full((n * n,), b))
        x_nf.append(_one_hot(v - 1, vocab))
        y_nf.append(_one_hot(v == v.min(), 2))
        order = torch.argsort(v, stable=True)
        rank = torch.empty(n, dtype=torch.long)
        rank[order] = torch.arange(n)
        follows = rank[k // n] == rank[k % n] + 1
        y_ef.append(_one_hot(follows, 2))
        off += n
    cat = lambda ts: torch.cat(ts).to(device)
    common = dict(senders=cat(senders), receivers=cat(receivers),
                  node_graph=cat(node_graph), edge_graph=cat(edge_graph),
                  n_node=off, n_graph=len(values))
    return (Graphs(nf=cat(x_nf), ef=None, gf=None, **common),
            Graphs(nf=cat(y_nf), ef=cat(y_ef), gf=None, **common))
