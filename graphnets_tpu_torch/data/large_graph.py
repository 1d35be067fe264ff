"""Large-graph storage and the neighbour-sampling loader (counterpart of
``graphnets_tpu/data/large_graph.py``).

``LargeGraph`` holds a big directed graph on the host in CSC-by-destination
form (edges grouped by receiver, the aggregation direction).
``NeighborSampler`` draws GraphSAGE-style fixed-fanout incoming
neighbourhoods around seed nodes and emits static-shaped, mask-padded
single-graph :class:`GraphsTuple` batches: receivers ascending, padded edges
on a pad node behind every real one, both capacities rounded to multiples
of 128.  That layout is what the single-graph edge-update kernel and the
sorted segment sum rest on.

The sampling runs on the host where the JAX package's does: each layer
through the native runtime (``runtime/native.sample_layer``, threaded, each
frontier node on its own (seed, position)-keyed stream, the seed drawn from
the sampler's ``default_rng``), the features through its threaded row
gather, and the CSC through its counting sort; under
``GRAPHNETS_TPU_TORCH_NATIVE=0`` all three take the JAX module's numpy
paths.  Either way both packages draw the same batches from one seed.  A
sampler asked for the CPU emits CPU tensors, in page-locked memory with
``pin_memory=True``, which ``data/prefetch`` moves to the card on a stream
of its own while the device runs the step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graph import GraphsTuple
from ..runtime import native
from ..runtime.native import csc_from_coo
from ..utils.config import resolve_device

__all__ = ["LargeGraph", "NeighborSampler", "SampledBatch",
           "csc_from_coo", "device_feature_table"]


@dataclasses.dataclass
class LargeGraph:
    """A big graph on the host: CSC by destination, node features and
    labels."""

    indptr: np.ndarray     # [N + 1] edge range per destination node
    src: np.ndarray        # [E] source node per edge (grouped by dest)
    node_feat: np.ndarray  # [N, D]
    labels: Optional[np.ndarray] = None  # [N] int labels

    @staticmethod
    def from_coo(senders: np.ndarray, receivers: np.ndarray,
                 node_feat: np.ndarray,
                 labels: Optional[np.ndarray] = None) -> "LargeGraph":
        indptr, src = csc_from_coo(senders, receivers, node_feat.shape[0])
        return LargeGraph(indptr=indptr, src=src, node_feat=node_feat,
                          labels=labels)

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return len(self.src)

    def in_degree(self, nodes: np.ndarray) -> np.ndarray:
        return self.indptr[nodes + 1] - self.indptr[nodes]


@dataclasses.dataclass
class SampledBatch:
    graph: GraphsTuple
    seed_local_idx: torch.Tensor        # positions of the seeds in graph.nf
    labels: Optional[torch.Tensor]      # [num_seeds] labels of the seeds
    label_mask: torch.Tensor            # [num_seeds] False for padded seeds
    # emit_node_ids mode: the global node id of every subgraph node slot
    # (pad slots hold num_nodes, the zero row of the table built by
    # :func:`device_feature_table`); ``graph.nf`` is None and the training
    # step gathers the features on the device, so a batch ships indices
    # instead of gathered features.
    node_ids: Optional[torch.Tensor] = None


def device_feature_table(g: LargeGraph, dtype: Optional[torch.dtype] = None,
                         device=None) -> torch.Tensor:
    """The ``[N + 1, D]`` feature table on ``device`` (``cuda`` unless the
    caller passes another); its last row is zeros, the row the pad slots'
    ``node_ids`` point at.  Build once, reuse across batches."""
    feat = np.concatenate(
        [g.node_feat, np.zeros((1, g.node_feat.shape[1]), np.float32)])
    t = torch.from_numpy(feat).to(resolve_device(device))
    return t.to(dtype) if dtype is not None else t


class NeighborSampler:
    """Fixed-fanout incoming-neighbourhood sampler with static output
    shapes.

    The sampled subgraph's nodes are the seeds (positions ``0..B-1``), then
    the sampled frontier nodes layer by layer.  Edges point from a sampled
    neighbour to the node it was sampled for, so an L-layer stack gives
    every seed an L-hop receptive field.  Batches land on ``device``
    (``cuda`` unless the caller passes another); on the CPU,
    ``pin_memory=True`` puts them in page-locked memory.
    """

    def __init__(self, g: LargeGraph, fanouts: Sequence[int],
                 batch_size: int, seed: int = 0,
                 emit_node_ids: bool = False, device=None,
                 pin_memory: bool = False):
        self.g = g
        self.fanouts = tuple(fanouts)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.emit_node_ids = emit_node_ids
        self.device = resolve_device(device)
        if pin_memory and self.device.type != "cpu":
            raise ValueError("pin_memory is for batches emitted on the CPU")
        self.pin_memory = pin_memory
        caps_nodes = [batch_size]
        caps_edges = []
        cur = batch_size
        for f in self.fanouts:
            caps_edges.append(cur * f)
            cur = cur * f
            caps_nodes.append(cur)
        # Both capacities are multiples of 128 (one pad node included): the
        # kernel gates want 32- and 128-aligned row counts.
        self.max_nodes = ((int(sum(caps_nodes)) + 1 + 127) // 128) * 128
        self.max_edges = ((int(sum(caps_edges)) + 127) // 128) * 128

    def _layer(self, frontier: np.ndarray, frontier_pos: np.ndarray,
               f: int):
        """Up to ``f`` incoming edges of each frontier node, without
        replacement: ``(sources, receiver positions)``."""
        g = self.g
        if native.available() and len(frontier):
            return native.sample_layer(
                g.indptr, g.src, np.asarray(frontier, np.int64),
                np.asarray(frontier_pos, np.int64), f,
                int(self.rng.integers(1, 2 ** 62)))
        deg = g.in_degree(np.asarray(frontier, np.int64)) \
            if len(frontier) else np.zeros(0, np.int64)
        new_src, e_r = [], []
        for i, v in enumerate(frontier):
            d = deg[i]
            if d == 0:
                continue
            k = min(f, int(d))
            sel = self.rng.choice(int(d), size=k, replace=False)
            s_ = g.src[g.indptr[v]: g.indptr[v + 1]][sel]
            new_src.append(s_)
            e_r.append(np.full(len(s_), frontier_pos[i]))
        if not new_src:
            return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
        return np.concatenate(new_src), np.concatenate(e_r)

    def _emit(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cpu":
            return t.to(self.device)
        return t.pin_memory() if self.pin_memory else t

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        g = self.g
        B = self.batch_size
        if len(seeds) > B:
            raise ValueError(f"{len(seeds)} seeds for a batch of {B}")
        n_seeds = len(seeds)

        nodes: List[np.ndarray] = [np.asarray(seeds, np.int64)]
        senders_l: List[np.ndarray] = []
        receivers_l: List[np.ndarray] = []
        frontier = nodes[0]
        frontier_pos = np.arange(n_seeds)
        next_pos_start = n_seeds
        for f in self.fanouts:
            srcs, recv = self._layer(frontier, frontier_pos, f)
            pos = next_pos_start + np.arange(len(srcs))
            senders_l.append(pos)
            receivers_l.append(recv)
            nodes.append(srcs)
            frontier = srcs
            frontier_pos = pos
            next_pos_start = next_pos_start + len(srcs)

        all_nodes = np.concatenate(nodes)
        N = len(all_nodes)
        E = sum(len(s) for s in senders_l)
        NP, EP = self.max_nodes, self.max_edges
        if N > NP or E > EP:
            raise ValueError(f"sampled {N} nodes / {E} edges exceed the "
                             f"capacities {NP} / {EP}")

        senders = np.zeros(EP, np.int32)
        receivers = np.zeros(EP, np.int32)
        if E:
            senders[:E] = np.concatenate(senders_l)
            receivers[:E] = np.concatenate(receivers_l)
        # Padded slots point at the pad node.
        senders[E:] = N
        receivers[E:] = N

        emit = self._emit
        node_ids = nf = None
        if self.emit_node_ids:
            ids = np.full(NP, g.num_nodes, np.int32)  # the pad row
            ids[:N] = all_nodes
            node_ids = emit(ids)
        else:
            feat = np.zeros((NP, g.node_feat.shape[1]), np.float32)
            native.gather_rows(g.node_feat, all_nodes, out=feat[:N])
            nf = emit(feat)

        graph = GraphsTuple(
            senders=emit(senders), receivers=emit(receivers),
            node_graph=emit(np.zeros(NP, np.int32)),
            edge_graph=emit(np.zeros(EP, np.int32)),
            n_node=emit(np.array([N], np.int32)),
            n_edge=emit(np.array([E], np.int32)),
            node_mask=emit(np.arange(NP) < N),
            edge_mask=emit(np.arange(EP) < E),
            graph_mask=emit(np.ones(1, bool)),
            ef=None, nf=nf, gf=None)
        labels = None
        if g.labels is not None:
            lab = np.zeros(B, np.int64)
            lab[:n_seeds] = g.labels[seeds]
            labels = emit(lab)
        return SampledBatch(
            graph=graph, seed_local_idx=emit(np.arange(B, dtype=np.int32)),
            labels=labels, label_mask=emit(np.arange(B) < n_seeds),
            node_ids=node_ids)

    def epoch(self, train_nodes: np.ndarray, shuffle: bool = True):
        """Iterate mini-batches of seeds over an epoch."""
        idx = np.array(train_nodes)
        if shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            yield self.sample(idx[i: i + self.batch_size])
