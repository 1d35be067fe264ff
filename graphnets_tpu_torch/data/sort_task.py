"""The list-sorting graph task (counterpart of the host generator in
``graphnets_tpu/data/sort_task.py``).

Graphs of ``n in [min_nodes, max_nodes]`` nodes, fully connected (with
self-loops); input node features are the one-hot of an integer in
``1..vocab_size``; node targets are the one-hot of "is the minimum"; edge
targets the one-hot of "the receiver follows the sender in sorted order"
(stable sort by value, ties broken by original position).

The host generator (:func:`get_batch`) is numpy and draws exactly what the
JAX package's draws from the same ``numpy.random.Generator``, so both
packages see bit-equal batches.

:func:`device_batch` builds a batch on the device with no host round trip,
so a captured training step can generate its own data (the JAX package's
``device_batch``, ``sort_task.py:75-253``).  It is two parts:
:func:`sort_draws`, the node counts and values from a ``torch.Generator``
on the batch's device, and :func:`sort_layout`, the batch laid out from
those draws by index arithmetic that never syncs with the host.  torch
cannot reproduce ``jax.random``'s bits, but from the same draws the layout
is JAX's bit for bit, in both layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..graph import GraphsTuple, PadSpec, batch

__all__ = ["SortTaskConfig", "gen_sample", "get_batch", "sort_pad_spec",
           "device_batch", "sort_draws", "sort_layout"]


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


def sort_draws(generator: torch.Generator, cfg: SortTaskConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random part of :func:`device_batch`, on ``generator``'s device:
    ``n [B]`` node counts uniform in ``[min_nodes, max_nodes]`` and
    ``values [B, max_nodes]`` uniform in ``[1, vocab_size]`` (int32; graph
    ``b`` uses the first ``n[b]`` of its row), as JAX's two ``randint``
    draws."""
    B, dev = cfg.batch_size, generator.device
    n = torch.randint(cfg.min_nodes, cfg.max_nodes + 1, (B,),
                      generator=generator, device=dev, dtype=torch.int32)
    values = torch.randint(1, cfg.vocab_size + 1, (B, cfg.max_nodes),
                           generator=generator, device=dev,
                           dtype=torch.int32)
    return n, values


def _one_hot(idx: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a row of zeros for an id outside ``[0, k)``."""
    return (idx[:, None] == torch.arange(k, dtype=idx.dtype,
                                         device=idx.device)).to(dtype)


def _targets(val_node, masked_val, node_mask, node_graph, num_graphs: int,
             sort_key, senders, receivers, edge_mask, rank_base, dtype):
    """The "is minimum" node targets (ties all count) and the "receiver
    follows sender in sorted order" edge targets, as one-hots.
    ``masked_val`` holds the padded nodes' values above every real one."""
    ng = node_graph.long()
    graph_min = torch.full((num_graphs,), torch.iinfo(torch.int32).max,
                           dtype=torch.int32, device=val_node.device
                           ).scatter_reduce(0, ng, masked_val, "amin")
    is_min = (val_node == graph_min[ng]) & node_mask
    y_nf = _one_hot(is_min.to(torch.int32), 2, dtype)
    # Stable rank within the graph: the inverse of the stable sort of the
    # keys (position breaks ties, as the reference's stable sort does).
    order = torch.argsort(sort_key, stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    rank_w = rank.to(torch.int32) - rank_base
    consecutive = ((rank_w[senders.long()] + 1 == rank_w[receivers.long()])
                   & edge_mask)
    return y_nf, _one_hot(consecutive.to(torch.int32), 2, dtype)


def sort_layout(n: torch.Tensor, values: torch.Tensor, cfg: SortTaskConfig,
                pad: Optional[PadSpec] = None, dtype=None
                ) -> Tuple[GraphsTuple, GraphsTuple]:
    """The (input, target) batch of :func:`device_batch` from its draws
    (:func:`sort_draws`), on their device, with no host sync: the same
    structure, canonical edge order and targets as :func:`get_batch`,
    features in ``dtype`` (float32 by default).  ``pad`` is
    ``sort_pad_spec(cfg)`` by default; a ``PadSpec.uniform`` lays the batch
    out in uniform slots."""
    pad = pad or sort_pad_spec(cfg)
    if pad.per_slot:
        return _layout_uniform(n, values, cfg, pad, dtype)
    B = cfg.batch_size
    NP, EP, GP = pad.num_nodes, pad.num_edges, pad.num_graphs
    if GP < B + 1 or NP < B * cfg.max_nodes + 1:
        raise ValueError(f"sort_layout: pad {pad} does not cover the worst "
                         f"case of {cfg}")
    V, MN = cfg.vocab_size, cfg.max_nodes
    dtype = dtype or torch.float32
    dev, i32 = n.device, torch.int32
    zero = torch.zeros(1, dtype=i32, device=dev)

    node_end = torch.cumsum(n, 0, dtype=i32)
    node_off = torch.cat([zero, node_end])
    N = node_end[-1]                                # 0-d, on the device

    t = torch.arange(NP, dtype=i32, device=dev)
    node_graph = torch.searchsorted(node_end, t, right=True, out_int32=True)
    node_mask = t < N
    ng_c = node_graph.clamp(max=B - 1).long()
    li = t - node_off[ng_c]                         # local node index
    val_node = values[ng_c, li.clamp(max=MN - 1).long()]
    x_nf = torch.where(node_mask[:, None], _one_hot(val_node - 1, V, dtype),
                       0)

    # Edges: the full n_b x n_b adjacency of each graph in canonical
    # column-major order (receiver varies slowest).
    nn_ = n * n
    e_end = torch.cumsum(nn_, 0, dtype=i32)
    e_off = torch.cat([zero, e_end])
    e = torch.arange(EP, dtype=i32, device=dev)
    edge_mask = e < e_end[-1]
    edge_graph = torch.searchsorted(e_end, e, right=True, out_int32=True)
    eg_c = edge_graph.clamp(max=B - 1).long()
    ke = e - e_off[eg_c]
    nb = n[eg_c].clamp(min=1)
    senders = torch.where(edge_mask, node_off[eg_c] + ke % nb, N)
    receivers = torch.where(edge_mask, node_off[eg_c] + ke // nb, N)

    # Stable sort rank within each graph: key (graph, value, position).
    stride = (V + 2) * (MN + 1)
    masked = torch.where(node_mask, val_node, V + 2)
    sort_key = node_graph * stride + masked * (MN + 1) + li.clamp(max=MN)
    y_nf, y_ef = _targets(val_node, masked, node_mask, node_graph, GP,
                          sort_key, senders, receivers, edge_mask,
                          node_off[ng_c], dtype)

    gslot = torch.arange(GP, dtype=i32, device=dev)
    graph_mask = gslot < B
    gs_c = gslot.clamp(max=B - 1).long()
    common = dict(
        senders=senders, receivers=receivers, node_graph=node_graph,
        edge_graph=edge_graph,
        n_node=torch.where(graph_mask, n[gs_c], 0),
        n_edge=torch.where(graph_mask, nn_[gs_c], 0),
        node_mask=node_mask, edge_mask=edge_mask, graph_mask=graph_mask,
        gf=None, homogeneous=False)
    return (GraphsTuple(ef=None, nf=x_nf, **common),
            GraphsTuple(ef=y_ef, nf=y_nf, **common))


def _layout_uniform(n, values, cfg: SortTaskConfig, pad: PadSpec, dtype):
    """:func:`sort_layout` in the uniform slot layout: graph slot ``b``
    owns node slots ``[b*ns, (b+1)*ns)`` and edge slots
    ``[b*es, (b+1)*es)``; padded edges point at the slot's last node."""
    B = cfg.batch_size
    ns, es = pad.num_nodes, pad.num_edges
    GP = pad.num_graphs if pad.num_graphs is not None else B
    if GP < B or ns <= cfg.max_nodes or es < cfg.max_nodes ** 2:
        raise ValueError(
            "uniform sort layout needs one padding node per slot "
            "(n_slots > max_nodes) and e_slots >= max_nodes^2")
    V, MN = cfg.vocab_size, cfg.max_nodes
    dtype = dtype or torch.float32
    dev, i32 = n.device, torch.int32
    n = torch.cat([n, torch.zeros(GP - B, dtype=i32, device=dev)])
    values = torch.cat([values, torch.ones(GP - B, MN, dtype=i32,
                                           device=dev)])

    t = torch.arange(GP * ns, dtype=i32, device=dev)
    slot, li = t // ns, t % ns
    sl = slot.long()
    node_mask = li < n[sl]
    val_node = values[sl, li.clamp(max=MN - 1).long()]
    x_nf = torch.where(node_mask[:, None], _one_hot(val_node - 1, V, dtype),
                       0)

    e = torch.arange(GP * es, dtype=i32, device=dev)
    eslot, ke = e // es, e % es
    el = eslot.long()
    nb = n[el].clamp(min=1)
    edge_mask = ke < n[el] * n[el]
    last = (eslot + 1) * ns - 1      # the slot's padding node
    senders = torch.where(edge_mask, eslot * ns + ke % nb, last)
    receivers = torch.where(edge_mask, eslot * ns + ke // nb, last)

    # Every slot holds exactly ns keyed entries (padding sorts after real
    # ones), so slot b's first entry has global rank b * ns.
    stride = (V + 3) * (ns + 1)
    masked = torch.where(node_mask, val_node, V + 2)
    sort_key = slot * stride + masked * (ns + 1) + li
    y_nf, y_ef = _targets(val_node, masked, node_mask, slot, GP, sort_key,
                          senders, receivers, edge_mask, slot * ns, dtype)
    common = dict(
        senders=senders, receivers=receivers, node_graph=slot,
        edge_graph=eslot, n_node=n, n_edge=n * n, node_mask=node_mask,
        edge_mask=edge_mask,
        graph_mask=torch.arange(GP, dtype=i32, device=dev) < B,
        gf=None, homogeneous=False, slot_shape=(ns, es),
        pad_aliases_real=True)
    return (GraphsTuple(ef=None, nf=x_nf, **common),
            GraphsTuple(ef=y_ef, nf=y_nf, **common))


def device_batch(generator: torch.Generator, cfg: SortTaskConfig,
                 pad: Optional[PadSpec] = None, dtype=None
                 ) -> Tuple[GraphsTuple, GraphsTuple]:
    """One (input, target) batch generated on ``generator``'s device, with
    no host round trip, so a captured step (``training/train``) can draw
    a fresh batch on every replay.  The same distribution, canonical edge
    order and targets as :func:`get_batch`; ``dtype`` is the features'
    type (float32 by default)."""
    return sort_layout(*sort_draws(generator, cfg), cfg, pad, dtype)
