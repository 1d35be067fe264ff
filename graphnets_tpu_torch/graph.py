"""Batched-graph data structure of the PyTorch port (counterpart of
``graphnets_tpu/graph.py``).

A batch of graphs is one big sparse graph in COO form: ``senders[E]`` and
``receivers[E]`` index a flat node array, and segment-id arrays map nodes
and edges back to their graph.  Features are row-major, feature-last:
``ef [E, DE]``, ``nf [N, DN]``, ``gf [G, DG]``.

Conventions kept from the JAX package (they define parity):

* Adjacency entry ``(i, j) == 1`` is an edge from node ``i`` to node ``j``.
* Canonical edge order is the column-major linear index of the adjacency:
  receiver varies slowest, so ``receivers`` is ascending.
* Padded slots never contaminate real ones: aggregations mask them, and
  padded edges target padding nodes (the pad-targets-pad rule).

Index work runs on the host: the canonical COO through the native runtime
(``runtime/native.batch_coo``, numpy under
``GRAPHNETS_TPU_TORCH_NATIVE=0``), the rest in numpy; the finished arrays
move to ``device`` at the end (``cuda`` unless the caller passes another).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .runtime import native
from .utils.config import resolve_device
from .utils.profiling import span

__all__ = [
    "GraphsTuple", "PadSpec", "batch", "unbatch", "adjacency_matrices",
    "efview", "nfview", "gfview", "flat_unpadded_nf", "flat_unpadded_ef",
    "flatunpaddednf", "flatunpaddedef", "collapse_ef", "collapse_ef_padded",
    "collapsef", "unpadded_collapsed_ef", "flat_unpadded_collapsed_ef",
    "GNGraphBatch", "unpaddedcollapsedef", "flatunpaddedcollapsedef",
]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Static padding targets.

    ``None`` fields mean "exact" (no padding on that axis).  Padding adds
    one virtual padding graph that owns all padding nodes and edges.

    ``per_slot=True`` (see :meth:`uniform`) selects the UNIFORM slot layout:
    ``num_nodes``/``num_edges`` are then per-graph capacities.  Graph slot
    ``b`` owns node slots ``[b*num_nodes, (b+1)*num_nodes)`` and edge slots
    ``[b*num_edges, (b+1)*num_edges)``.  This sets
    ``GraphsTuple.slot_shape``, which the fused edge-update kernel needs.
    Padded edges of slot ``b`` point at slot ``b``'s last node slot, so a
    graph with padded edges must have at least one padding node.
    """

    num_nodes: Optional[int] = None
    num_edges: Optional[int] = None
    num_graphs: Optional[int] = None
    per_slot: bool = False

    @staticmethod
    def bucketed(n_node: int, n_edge: int, n_graph: int,
                 node_multiple: int = 8, edge_multiple: int = 128) -> "PadSpec":
        """Round node/edge totals up to friendly multiples."""
        return PadSpec(
            num_nodes=_round_up(n_node + 1, node_multiple),
            num_edges=_round_up(n_edge, edge_multiple),
            num_graphs=n_graph + 1,
        )

    @staticmethod
    def uniform(n_slots: int, e_slots: int,
                num_graphs: Optional[int] = None,
                node_multiple: int = 8,
                edge_multiple: int = 128) -> "PadSpec":
        """Uniform slot layout: every graph slot owns ``n_slots`` node and
        ``e_slots`` edge slots (rounded up to the given multiples).
        ``num_graphs`` > B appends fully padded graph slots."""
        return PadSpec(
            num_nodes=_round_up(n_slots, node_multiple),
            num_edges=_round_up(e_slots, edge_multiple),
            num_graphs=num_graphs,
            per_slot=True,
        )


@dataclasses.dataclass
class GraphsTuple:
    """A batch of graphs as one big sparse graph (COO), held as tensors.

    Structure (``int32``/``bool``): ``senders``/``receivers [E]``,
    ``node_graph [N]``/``edge_graph [E]`` (owning graph), ``n_node``/
    ``n_edge [G]`` (real counts per graph slot) and the ``node_mask``/
    ``edge_mask``/``graph_mask`` of real slots.  Features ``ef``/``nf``/
    ``gf`` are ``None`` when absent.

    ``slot_shape = (n_slots, e_slots)`` declares the uniform slot layout
    (see :class:`PadSpec`).  ``pad_aliases_real`` is set by that layout when
    padding exists: padded slots then share their graph's segment id, so
    graph-level pools must apply the masks.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    node_graph: torch.Tensor
    edge_graph: torch.Tensor
    n_node: torch.Tensor
    n_edge: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_mask: torch.Tensor
    ef: Optional[torch.Tensor] = None
    nf: Optional[torch.Tensor] = None
    gf: Optional[torch.Tensor] = None
    homogeneous: bool = False
    slot_shape: Optional[Tuple[int, int]] = None
    pad_aliases_real: bool = False

    @property
    def num_node_slots(self) -> int:
        return int(self.node_graph.shape[0])

    @property
    def num_edge_slots(self) -> int:
        return int(self.senders.shape[0])

    @property
    def num_graph_slots(self) -> int:
        return int(self.n_node.shape[0])

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def replace(self, **kw) -> "GraphsTuple":
        return dataclasses.replace(self, **kw)

    def with_features(self, ef=..., nf=..., gf=...) -> "GraphsTuple":
        """Same structure, new features (``...`` keeps the old one)."""
        kw = {}
        if ef is not ...:
            kw["ef"] = ef
        if nf is not ...:
            kw["nf"] = nf
        if gf is not ...:
            kw["gf"] = gf
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Host-side batching
# ---------------------------------------------------------------------------


def _as_feature_list(x, B: int, what: str) -> Optional[List[np.ndarray]]:
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        if len(x) != B:
            raise ValueError(
                f"{what}: expected one feature array per graph "
                f"({B} graphs), got {len(x)}")
        out = [np.asarray(v) for v in x]
        for i, v in enumerate(out):
            if v.ndim != 2:
                raise ValueError(
                    f"{what}[{i}]: per-graph features must be 2-D "
                    f"[count, dim]; got shape {v.shape}")
        widths = {v.shape[1] for v in out}
        if len(widths) > 1:
            raise ValueError(
                f"{what}: inconsistent feature widths across graphs: "
                f"{sorted(widths)}")
        return out
    x = np.asarray(x)
    if x.ndim != 3 or x.shape[0] != B:
        raise ValueError(
            f"{what}: homogeneous features must be [B, T, D] with "
            f"B={B}; got shape {x.shape}")
    return [x[i] for i in range(B)]


def _ranges(counts) -> np.ndarray:
    """``concat([arange(c) for c in counts])`` without a Python loop."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)


def batch(data: dict, pad: Optional[PadSpec] = None,
          device=None) -> GraphsTuple:
    """Build a :class:`GraphsTuple` from adjacency matrices + features.

    * ``data["graphs"]``: one adjacency matrix (homogeneous batch) or a
      list of per-graph matrices.
    * ``data["ef"]``: ``[B, E, DE]`` / list of ``[E_i, DE]`` / ``None``.
    * ``data["nf"]``: ``[B, N, DN]`` / list of ``[N_i, DN]`` / ``None``.
    * ``data["gf"]``: ``[B, DG]`` / list of ``[DG]`` / ``None``.

    Edge features are listed in canonical (column-major) edge order.
    Features come out as float32 tensors on ``device`` (``cuda`` unless the
    caller passes another).

    With the tracing switch on (``utils/config.enable_tracing``) a call is
    the span ``gn.batch``: ``gn.batch.pack`` (checks, the COO, padding and
    features in numpy) and then ``gn.batch.to_device`` (one copy an array).
    """
    device = resolve_device(device)
    with span("gn.batch"):
        with span("gn.batch.pack"):
            arrays, meta = _pack(data, pad)
        with span("gn.batch.to_device"):
            g = _to_device(arrays, device, **meta)
        return _validated(g)


def _pack(data: dict, pad: Optional[PadSpec]) -> Tuple[dict, dict]:
    """:func:`batch`'s arrays in numpy and the ``GraphsTuple``'s host
    metadata."""
    if set(data.keys()) != {"graphs", "ef", "nf", "gf"}:
        raise ValueError(
            "batch input must be a dict with exactly the keys "
            "{'graphs', 'ef', 'nf', 'gf'} (absent feature sets are None); "
            f"got {sorted(data.keys())}")
    graphs, ef, nf, gf = data["graphs"], data["ef"], data["nf"], data["gf"]
    if ef is None and nf is None and gf is None:
        raise ValueError("at least one of ef/nf/gf must be present")

    homogeneous = not isinstance(graphs, (list, tuple))
    if homogeneous:
        first = next(np.asarray(v) for v in (gf, nf, ef) if v is not None)
        B = first.shape[0]
        adj_mats = [np.asarray(graphs)] * B
    else:
        adj_mats = [np.asarray(a) for a in graphs]
        B = len(adj_mats)

    ef_list = _as_feature_list(ef, B, "ef")
    nf_list = _as_feature_list(nf, B, "nf")
    gf_arr = None
    if gf is not None:
        gf_arr = (np.stack([np.asarray(v) for v in gf])
                  if isinstance(gf, (list, tuple)) else np.asarray(gf))
        if gf_arr.ndim != 2 or gf_arr.shape[0] != B:
            raise ValueError(
                f"gf: graph features must be [B, DG] with B={B} (or a "
                f"list of B 1-D arrays); got shape {gf_arr.shape}")

    for i, a in enumerate(adj_mats):
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(
                f"graphs[{i}]: adjacency matrix must be square 2-D; got "
                f"shape {a.shape}")
        n, e = a.shape[0], int((a == 1).sum())
        if nf_list is not None and nf_list[i].shape[0] != n:
            raise ValueError(
                f"graph {i}: nf has {nf_list[i].shape[0]} rows but the "
                f"adjacency has {n} nodes")
        if ef_list is not None and ef_list[i].shape[0] != e:
            raise ValueError(
                f"graph {i}: ef has {ef_list[i].shape[0]} rows but the "
                f"adjacency has {e} edges (entries == 1)")

    n_node = np.array([a.shape[0] for a in adj_mats], dtype=np.int32)
    senders, receivers, n_edge = native.batch_coo(adj_mats)
    N, E, G = int(n_node.sum()), int(n_edge.sum()), B

    if pad is None:
        pad = PadSpec()
    if pad.per_slot:
        return _batch_uniform(n_node, n_edge, senders, receivers, ef_list,
                              nf_list, gf_arr, pad, homogeneous)
    NP = pad.num_nodes if pad.num_nodes is not None else N
    EP = pad.num_edges if pad.num_edges is not None else E
    GP = pad.num_graphs if pad.num_graphs is not None else G
    if NP < N or EP < E or GP < G:
        raise ValueError(
            f"pad spec ({NP},{EP},{GP}) smaller than batch ({N},{E},{G})")
    if (NP > N or EP > E) and GP == G:
        raise ValueError(
            "padding nodes/edges requires at least one padding graph slot "
            "(num_graphs >= B + 1) to own them")
    if EP > E and NP == N:
        raise ValueError(
            "padding edges requires at least one padding node "
            "(num_nodes >= N + 1) for them to target (use "
            "PadSpec.bucketed, which reserves one)")

    # Padding nodes/edges belong to the first padding graph; padded edges
    # point at the first padding node.
    pad_node_id = N if NP > N else 0
    node_graph = np.concatenate([np.repeat(np.arange(B, dtype=np.int32),
                                           n_node),
                                 np.full(NP - N, B, np.int32)])
    edge_graph = np.concatenate([np.repeat(np.arange(B, dtype=np.int32),
                                           n_edge),
                                 np.full(EP - E, B, np.int32)])
    senders = np.concatenate([senders, np.full(EP - E, pad_node_id,
                                               np.int32)])
    receivers = np.concatenate([receivers, np.full(EP - E, pad_node_id,
                                                   np.int32)])
    n_node_p = np.concatenate([n_node, np.zeros(GP - G, np.int32)])
    n_edge_p = np.concatenate([n_edge, np.zeros(GP - G, np.int32)])

    def _cat_feats(lst, rows: int):
        if lst is None:
            return None
        flat = np.concatenate([np.asarray(v, np.float32) for v in lst], 0)
        out = np.zeros((rows,) + flat.shape[1:], np.float32)
        out[:flat.shape[0]] = flat
        return out

    gf_p = None
    if gf_arr is not None:
        gf_p = np.zeros((GP, gf_arr.shape[1]), np.float32)
        gf_p[:B] = np.asarray(gf_arr, np.float32)
    exact = homogeneous and GP == B and NP == N and EP == E and B > 0
    arrays = dict(
        senders=senders, receivers=receivers, node_graph=node_graph,
        edge_graph=edge_graph, n_node=n_node_p, n_edge=n_edge_p,
        node_mask=np.arange(NP) < N, edge_mask=np.arange(EP) < E,
        graph_mask=np.arange(GP) < G,
        ef=_cat_feats(ef_list, EP), nf=_cat_feats(nf_list, NP), gf=gf_p)
    return arrays, dict(
        homogeneous=homogeneous,
        # Exact homogeneous batches have a uniform slot layout.
        slot_shape=(int(n_node[0]), int(n_edge[0])) if exact else None)


def _validated(g: GraphsTuple) -> GraphsTuple:
    """``g``, validated first under ``GRAPHNETS_TPU_TORCH_DEBUG=1``."""
    from .utils.config import debug_checks
    if debug_checks():
        from .utils.debug import validate_graph
        validate_graph(g)
    return g


def _batch_uniform(n_node, n_edge, senders, receivers, ef_list, nf_list,
                   gf_arr, pad: PadSpec, homogeneous: bool
                   ) -> Tuple[dict, dict]:
    """Uniform slot layout (``PadSpec.uniform``): every graph slot owns
    ``ns`` node slots and ``es`` edge slots, padding interleaved per slot.

    * graph slot ``b`` owns nodes ``[b*ns, (b+1)*ns)`` and edges
      ``[b*es, (b+1)*es)``; real slots are a prefix of each range;
    * padded edges of slot ``b`` point (sender AND receiver) at slot ``b``'s
      last node slot, a padding node, which keeps ``receivers`` globally
      ascending and padded aggregation targets apart from real ones;
    * ``node_graph``/``edge_graph`` give padding slots their owning graph,
      so graph-level pools need the masks (``pad_aliases_real=True``).
    """
    B = len(n_node)
    ns, es = pad.num_nodes, pad.num_edges
    GP = pad.num_graphs if pad.num_graphs is not None else B
    if GP < B:
        raise ValueError(f"PadSpec.uniform num_graphs={GP} < batch size {B}")
    for i in range(B):
        n_i, e_i = int(n_node[i]), int(n_edge[i])
        if n_i > ns or e_i > es:
            raise ValueError(
                f"graph {i} ({n_i} nodes / {e_i} edges) exceeds the uniform "
                f"slot capacity (n_slots={ns}, e_slots={es})")
        if e_i < es and n_i >= ns:
            raise ValueError(
                f"graph {i} has padded edge slots ({e_i} < {es}) but no "
                f"padding node ({n_i} == n_slots={ns}); padded edges must "
                "target a padding node; raise n_slots by one")
    if GP > B and ns < 1:
        raise ValueError("padding graph slots require n_slots >= 1")

    node_cum = np.concatenate([[0], np.cumsum(n_node)]).astype(np.int64)
    slot_node_base = np.arange(B, dtype=np.int64) * ns
    slot_edge_base = np.arange(B, dtype=np.int64) * es

    # Real edge endpoints, re-based from the packed layout to slot offsets.
    e_shift = np.repeat(slot_node_base - node_cum[:-1], n_edge)
    s_u = senders.astype(np.int64) + e_shift
    r_u = receivers.astype(np.int64) + e_shift

    # Every slot's padded endpoints start at the slot's last node slot.
    last_node = np.arange(GP, dtype=np.int64) * ns + ns - 1
    senders_u = np.repeat(last_node, es)
    receivers_u = senders_u.copy()
    epos = np.repeat(slot_edge_base, n_edge) + _ranges(n_edge)
    senders_u[epos] = s_u
    receivers_u[epos] = r_u

    n_node_p = np.concatenate([n_node, np.zeros(GP - B, np.int32)])
    n_edge_p = np.concatenate([n_edge, np.zeros(GP - B, np.int32)])
    loc_n = np.tile(np.arange(ns, dtype=np.int64), GP)
    loc_e = np.tile(np.arange(es, dtype=np.int64), GP)
    node_mask = loc_n < np.repeat(n_node_p.astype(np.int64), ns)
    edge_mask = loc_e < np.repeat(n_edge_p.astype(np.int64), es)

    def _place(lst, rows: int, base, counts):
        if lst is None:
            return None
        flat = np.concatenate([np.asarray(v, np.float32) for v in lst], 0)
        out = np.zeros((rows,) + flat.shape[1:], np.float32)
        out[np.repeat(base, counts) + _ranges(counts)] = flat
        return out

    gf_p = None
    if gf_arr is not None:
        gf_p = np.zeros((GP, gf_arr.shape[1]), np.float32)
        gf_p[:B] = np.asarray(gf_arr, np.float32)
    padded = bool(GP > B or (~node_mask).any() or (~edge_mask).any())
    arrays = dict(
        senders=senders_u.astype(np.int32),
        receivers=receivers_u.astype(np.int32),
        node_graph=np.repeat(np.arange(GP, dtype=np.int32), ns),
        edge_graph=np.repeat(np.arange(GP, dtype=np.int32), es),
        n_node=n_node_p, n_edge=n_edge_p,
        node_mask=node_mask, edge_mask=edge_mask,
        graph_mask=np.arange(GP) < B,
        ef=_place(ef_list, GP * es, slot_edge_base, n_edge),
        nf=_place(nf_list, GP * ns, slot_node_base, n_node),
        gf=gf_p)
    return arrays, dict(homogeneous=homogeneous, slot_shape=(ns, es),
                        pad_aliases_real=padded)


def _to_device(arrays: dict, device, **meta) -> GraphsTuple:
    t = {k: (None if v is None else torch.from_numpy(np.ascontiguousarray(v))
             .to(device)) for k, v in arrays.items()}
    return GraphsTuple(**t, **meta)


# ---------------------------------------------------------------------------
# Host-side unbatching and views
# ---------------------------------------------------------------------------


def _np(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()  # numpy has no bfloat16; the widening is exact
    return x.numpy()


def _host_meta(g: GraphsTuple):
    """Per-graph counts and slot offsets: graph ``i``'s real nodes span
    ``[node_off[i], node_off[i] + n_node[i])``."""
    n_node = _np(g.n_node)
    n_edge = _np(g.n_edge)
    B = int(_np(g.graph_mask).sum())
    if g.slot_shape is not None:
        ns, es = g.slot_shape
        node_off = np.arange(len(n_node) + 1, dtype=np.int64) * ns
        edge_off = np.arange(len(n_edge) + 1, dtype=np.int64) * es
    else:
        node_off = np.concatenate([[0], np.cumsum(n_node)]).astype(np.int64)
        edge_off = np.concatenate([[0], np.cumsum(n_edge)]).astype(np.int64)
    return B, n_node, n_edge, node_off, edge_off


def adjacency_matrices(g: GraphsTuple) -> List[np.ndarray]:
    """Reconstruct per-graph adjacency matrices (host-side)."""
    B, n_node, n_edge, node_off, edge_off = _host_meta(g)
    s, r = _np(g.senders), _np(g.receivers)
    mats = []
    for i in range(B):
        n = int(n_node[i])
        a = np.zeros((n, n), dtype=np.int64)
        lo, hi = edge_off[i], edge_off[i] + int(n_edge[i])
        a[s[lo:hi] - node_off[i], r[lo:hi] - node_off[i]] = 1
        mats.append(a)
    return mats


def unbatch(g: GraphsTuple) -> dict:
    """Inverse of :func:`batch`, as numpy arrays on the host.

    Homogeneous batches return stacked arrays (``ef: [B, E, DE]`` ...);
    heterogeneous batches return per-graph lists.  bfloat16 features come
    back widened to float32.
    """
    if g.ef is None and g.nf is None and g.gf is None:
        raise ValueError("unbatch needs at least one feature set")
    B, n_node, n_edge, node_off, edge_off = _host_meta(g)
    mats = adjacency_matrices(g)
    ef = _np(g.ef) if g.ef is not None else None
    nf = _np(g.nf) if g.nf is not None else None
    gf = _np(g.gf) if g.gf is not None else None

    ef_l = (None if ef is None else
            [ef[edge_off[i]:edge_off[i] + int(n_edge[i])] for i in range(B)])
    nf_l = (None if nf is None else
            [nf[node_off[i]:node_off[i] + int(n_node[i])] for i in range(B)])
    gf_l = None if gf is None else [gf[i] for i in range(B)]

    if g.homogeneous:
        return {
            "graphs": mats[0],
            "ef": None if ef_l is None else np.stack(ef_l),
            "nf": None if nf_l is None else np.stack(nf_l),
            "gf": None if gf_l is None else np.stack(gf_l),
        }
    return {"graphs": mats, "ef": ef_l, "nf": nf_l, "gf": gf_l}


def efview(g: GraphsTuple, d1, d2, d3) -> np.ndarray:
    """Edge-feature view of graph ``d3``: ``[edge d2, feature d1]`` within
    the graph's edge slots (canonical order), as a host array."""
    if g.ef is None:
        raise ValueError("efview: the batch has no edge features")
    _, _, _, _, edge_off = _host_meta(g)
    return _np(g.ef)[edge_off[d3]:edge_off[d3 + 1]][d2, d1]


def nfview(g: GraphsTuple, d1, d2, d3) -> np.ndarray:
    """Node-feature view of graph ``d3``: ``[node d2, feature d1]``."""
    if g.nf is None:
        raise ValueError("nfview: the batch has no node features")
    _, _, _, node_off, _ = _host_meta(g)
    return _np(g.nf)[node_off[d3]:node_off[d3 + 1]][d2, d1]


def gfview(g: GraphsTuple, d1, d2) -> np.ndarray:
    """Graph-feature view: ``[graph d2, feature d1]``."""
    if g.gf is None:
        raise ValueError("gfview: the batch has no graph features")
    return _np(g.gf)[d2, d1]


def _refuse_capture(what: str) -> None:
    """The real slot count is data-dependent: reading it syncs with the
    device, which a CUDA-graph capture cannot (as JAX refuses under
    ``jit``)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise TypeError(
            f"flat_unpadded_{what} slices to the REAL slot count, which is "
            "data-dependent; it cannot run inside a CUDA-graph capture. A "
            "captured loss should use the masked losses in "
            "graphnets_tpu_torch.training.losses instead.")


def _flat_unpadded(x: torch.Tensor, mask: torch.Tensor, aliased: bool,
                   what: str) -> torch.Tensor:
    _refuse_capture(what)
    if aliased:
        # Uniform layout: padding interleaves per slot, so select by the
        # mask (an index_select by host indices: differentiable).
        idx = np.nonzero(_np(mask))[0]
        return x.index_select(0, torch.as_tensor(idx, device=x.device))
    return x[:int(_np(mask).sum())]


def flat_unpadded_nf(g: GraphsTuple) -> torch.Tensor:
    """All real node features as ``[sum_i N_i, DN]`` (the loss path);
    differentiable, but host-side: the length is read from the mask."""
    if g.nf is None:
        raise ValueError("flat_unpadded_nf: the batch has no node features")
    return _flat_unpadded(g.nf, g.node_mask, g.pad_aliases_real, "nf")


def flat_unpadded_ef(g: GraphsTuple) -> torch.Tensor:
    """All real edge features as ``[sum_i E_i, DE]``; see
    :func:`flat_unpadded_nf`."""
    if g.ef is None:
        raise ValueError("flat_unpadded_ef: the batch has no edge features")
    return _flat_unpadded(g.ef, g.edge_mask, g.pad_aliases_real, "ef")


# Reference-spelled aliases.
flatunpaddednf = flat_unpadded_nf
flatunpaddedef = flat_unpadded_ef


# ---------------------------------------------------------------------------
# Edge collapsing (directed -> undirected features), host-side
# ---------------------------------------------------------------------------


def _collapse_indices(g: GraphsTuple):
    """Per graph, ``(fwd_idx, rev_idx, self_loop)`` of the present
    lower-triangular edges: for each coordinate ``(i >= j)`` in
    column-major order where ``adj[i, j] == 1``, the slot of ``(i, j)``,
    the slot of ``(j, i)`` (-1 when absent: that direction counts as 0)
    and whether it is a self-loop (which maps to itself)."""
    B, n_node, n_edge, node_off, edge_off = _host_meta(g)
    s, r = _np(g.senders), _np(g.receivers)
    out = []
    for b in range(B):
        n = int(n_node[b])
        lo, hi = edge_off[b], edge_off[b] + int(n_edge[b])
        pos = {(int(si - node_off[b]), int(ri - node_off[b])): int(k)
               for k, (si, ri) in enumerate(zip(s[lo:hi], r[lo:hi]))}
        fwd, rev, selfloop = [], [], []
        for j in range(n):           # column-major lower triangle
            for i in range(j, n):
                if (i, j) in pos:
                    fwd.append(pos[(i, j)])
                    rev.append(pos.get((j, i), -1))
                    selfloop.append(i == j)
        out.append((np.array(fwd, np.int64), np.array(rev, np.int64),
                    np.array(selfloop, bool)))
    return out, edge_off


def collapse_ef(g: GraphsTuple) -> List[np.ndarray]:
    """Symmetrised (undirected) edge features per graph, present
    lower-triangular edges only: ``(ef[(i, j)] + ef[(j, i)]) / 2``, a
    self-loop kept as it is."""
    if g.ef is None:
        raise ValueError("collapse_ef: the batch has no edge features")
    info, edge_off = _collapse_indices(g)
    ef = _np(g.ef)
    outs = []
    for b, (fwd, rev, selfloop) in enumerate(info):
        base = ef[edge_off[b]:]
        f = base[fwd] if len(fwd) else np.zeros((0, ef.shape[1]), ef.dtype)
        rv = (np.where((rev >= 0)[:, None], base[np.maximum(rev, 0)], 0.0)
              if len(fwd) else f)
        out = np.where(selfloop[:, None], f, (f + rv) / 2.0)
        outs.append(out.astype(ef.dtype))
    return outs


def collapse_ef_padded(g: GraphsTuple) -> np.ndarray:
    """The padded variant: the full lower-triangular slot space of the
    batch's largest graph, ``[B, PN * (PN + 1) / 2, DE]``; slot ``(i, j)``
    (column-major) holds ``(ef[(i, j)] + ef[(j, i)]) / 2`` with absent
    directions 0, and a self-loop its own value."""
    if g.ef is None:
        raise ValueError("collapse_ef_padded: the batch has no edge "
                         "features")
    B, n_node, n_edge, node_off, edge_off = _host_meta(g)
    s, r = _np(g.senders), _np(g.receivers)
    ef = _np(g.ef)
    DE = ef.shape[1]
    PN = int(n_node.max()) if B else 0
    dense = np.zeros((B, PN, PN, DE), ef.dtype)
    for b in range(B):
        lo, hi = edge_off[b], edge_off[b] + int(n_edge[b])
        dense[b, s[lo:hi] - node_off[b], r[lo:hi] - node_off[b]] = ef[lo:hi]
    sym = (dense + np.swapaxes(dense, 1, 2)) / 2.0
    ii = np.arange(PN)
    sym[:, ii, ii] = dense[:, ii, ii]
    cols = [sym[:, i, j] for j in range(PN) for i in range(j, PN)]
    return (np.stack(cols, axis=1) if cols
            else np.zeros((B, 0, DE), ef.dtype))


def unpadded_collapsed_ef(g: GraphsTuple) -> List[np.ndarray]:
    return collapse_ef(g)


def flat_unpadded_collapsed_ef(g: GraphsTuple) -> np.ndarray:
    """:func:`collapse_ef` concatenated over the batch."""
    return np.concatenate(collapse_ef(g), axis=0)


collapsef = collapse_ef

# Reference-spelled aliases.
GNGraphBatch = GraphsTuple
unpaddedcollapsedef = unpadded_collapsed_ef
flatunpaddedcollapsedef = flat_unpadded_collapsed_ef
