"""GNBlock, the full Graph Network block, in the PyTorch port (counterpart
of ``graphnets_tpu/models/gn_block.py``).

Semantics kept exactly:

* update order edge -> node -> graph, each consuming updated upstream
  features;
* edge input ``[ef, nf[senders], nf[receivers], gf[edge_graph]]``, node
  input ``[sum_incoming(h_ef), nf, gf[node_graph]]``, graph input
  ``[sum_edges(h_ef), sum_nodes(h_nf), gf]``, each through one Linear;
* zero feature dims are legal and zero-width outputs become ``None``;
* ``dropout`` is accepted and never applied, like the reference.

Routes: on a uniform slot layout with kernels on, the edge update and the
edge->node sum run in the fused CUDA kernel (``ops/kernels/edge_update``).
Every other route runs the plain split-linear path: the JAX package's
``ln_matmul`` term, deferred ``sorted_gather_add`` and G = 1 kernel are not
ported yet, so here they keep their pure semantics (the LN of ``ef`` is
materialised and the gathers are ``index_select``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..graph import GraphsTuple
from ..nn.core import Linear, layer_norm
from ..ops import scatter
from ..ops.ln_linear import matmul_f32
from ..utils.config import use_kernels, use_split_linear

__all__ = [
    "GNBlock",
    "get_edge_fn_input",
    "get_node_fn_input",
    "get_graph_fn_input",
    "getedgefninput",
    "getnodefninput",
    "getgraphfninput",
    "zerodim2nothing",
]


def _concat(parts) -> torch.Tensor:
    parts = [p for p in parts if p is not None]
    if not parts:
        raise ValueError("at least one of ef/nf/gf must be present")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def get_edge_fn_input(g: GraphsTuple, ef=..., nf=..., gf=...):
    """Per-edge update input ``[E, DE + 2 DN + DG]`` (absent features add
    no columns)."""
    ef = g.ef if ef is ... else ef
    nf = g.nf if nf is ... else nf
    gf = g.gf if gf is ... else gf
    parts = [ef]
    if nf is not None:
        parts.append(scatter.gather_nodes(nf, g.senders))
        parts.append(scatter.gather_nodes(nf, g.receivers))
    if gf is not None:
        parts.append(scatter.broadcast_globals_to_edges(gf, g.edge_graph))
    return _concat(parts)


def get_node_fn_input(g: GraphsTuple, ef=..., nf=..., gf=...):
    """Per-node update input ``[N, DE' + DN + DG]``; edge features are
    required (the edge update runs first)."""
    ef = g.ef if ef is ... else ef
    nf = g.nf if nf is ... else nf
    gf = g.gf if gf is ... else gf
    if ef is None:
        raise ValueError("the node update needs edge features")
    parts = [scatter.aggregate_edges_for_nodes(ef, g.receivers,
                                               g.num_node_slots, g.edge_mask)]
    if nf is not None:
        parts.append(nf)
    if gf is not None:
        parts.append(scatter.broadcast_globals_to_nodes(gf, g.node_graph))
    return _concat(parts)


def get_graph_fn_input(g: GraphsTuple, ef=..., nf=..., gf=...):
    """Per-graph update input ``[G, DE' + DN' + DG]``; edge and node
    features are required."""
    ef = g.ef if ef is ... else ef
    nf = g.nf if nf is ... else nf
    gf = g.gf if gf is ... else gf
    if ef is None or nf is None:
        raise ValueError("the graph update needs edge and node features")
    parts = [
        scatter.aggregate_edges_for_globals(ef, g.edge_graph,
                                            g.num_graph_slots, g.edge_mask),
        scatter.aggregate_nodes_for_globals(nf, g.node_graph,
                                            g.num_graph_slots, g.node_mask),
    ]
    if gf is not None:
        parts.append(gf)
    return _concat(parts)


getedgefninput = get_edge_fn_input
getnodefninput = get_node_fn_input
getgraphfninput = get_graph_fn_input


def _linear_split(lin: Linear, out_dtype: torch.dtype,
                  terms: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
                  rows: int) -> torch.Tensor:
    """``concat(xs, -1) @ W + b`` as a sum of per-segment products.

    Each ``(x, idx)`` term consumes the next ``x.shape[-1]`` rows of ``W``;
    with ``idx`` the f32 partial product is gathered by ``idx`` after the
    product (gather-after-transform).  Partials accumulate in f32 and the
    sum rounds once, so this is at least as accurate as the concat form.
    """
    w, b = lin.w, lin.b
    acc = None
    off = 0
    for x, idx in terms:
        d = x.shape[-1]
        if d == 0:
            continue
        y = matmul_f32(x, w[off:off + d])
        off += d
        if idx is not None:
            y = y.index_select(0, idx)
        acc = y if acc is None else acc + y
    if acc is None:  # all-zero-width input: a bias broadcast
        acc = torch.zeros(rows, w.shape[1], dtype=torch.float32,
                          device=w.device)
    if b is not None:
        acc = acc + b.float()
    return acc.to(out_dtype)


def zerodim2nothing(g: GraphsTuple) -> GraphsTuple:
    """Zero-width feature tensors become ``None``."""
    def fix(x):
        return None if (x is not None and x.shape[-1] == 0) else x
    return g.with_features(ef=fix(g.ef), nf=fix(g.nf), gf=fix(g.gf))


class GNBlock(nn.Module):
    """``GNBlock(in_dims, out_dims)`` with ``dims = (DE, DN, DG)``; its
    update nets are ``edgefn``, ``nodefn`` and ``graphfn`` (single Linear
    layers).  ``forward(g) -> GraphsTuple`` with updated features."""

    def __init__(self, in_dims: Tuple[int, int, int],
                 out_dims: Tuple[int, int, int], dropout: float = 0.0, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not any(d > 0 for d in in_dims):
            raise ValueError("GNBlock needs one input feature set")
        if not any(d > 0 for d in out_dims):
            raise ValueError("GNBlock needs one output feature set")
        self.in_dims, self.out_dims = tuple(in_dims), tuple(out_dims)
        self.dropout = dropout  # constructed but unused, like the reference
        de, dn, dg = in_dims
        de_o, dn_o, dg_o = out_dims
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.edgefn = Linear(de + 2 * dn + dg, de_o, **kw)
        self.nodefn = Linear(dn + de_o + dg, dn_o, **kw)
        self.graphfn = Linear(dn_o + de_o + dg, dg_o, **kw)

    def forward(self, g: GraphsTuple, training: bool = False,
                generator: Optional[torch.Generator] = None,
                ef_ln: Optional[dict] = None) -> GraphsTuple:
        """``ef_ln``: optional LayerNorm params ``{"scale", "bias"}`` to
        apply to ``ef`` before the edge update (the GNCore hands its
        pre-block edge LN to the fused kernel this way).  Semantics equal
        ``LayerNorm(ef)`` followed by the normal block."""
        de, dn, dg = self.in_dims
        E, N, G = g.num_edge_slots, g.num_node_slots, g.num_graph_slots
        present = [a for a in (g.ef, g.nf, g.gf) if a is not None]
        dtype, dev = present[0].dtype, present[0].device
        ef = g.ef if g.ef is not None else torch.zeros(E, 0, dtype=dtype,
                                                       device=dev)
        nf = g.nf if g.nf is not None else torch.zeros(N, 0, dtype=dtype,
                                                       device=dev)
        gf = g.gf if g.gf is not None else torch.zeros(G, 0, dtype=dtype,
                                                       device=dev)
        widths = (ef.shape[-1], nf.shape[-1], gf.shape[-1])
        if widths != self.in_dims:
            raise ValueError(f"feature dims {widths} != declared in_dims "
                             f"{self.in_dims}")

        if use_split_linear():
            h_ef, agg = self._edge_update_split(g, ef, nf, gf, ef_ln, dtype,
                                                training)
            if agg is None:
                agg = scatter.aggregate_edges_for_nodes(h_ef, g.receivers, N,
                                                        g.edge_mask)
            else:
                # The kernel's f32 sum rounds where segment_sum rounds.
                agg = agg.to(dtype)
            h_nf = _linear_split(self.nodefn, dtype,
                                 [(agg, None), (nf, None),
                                  (gf, g.node_graph)], rows=N)
        else:
            if ef_ln is not None:
                ef = layer_norm(ef, ef_ln["scale"], ef_ln["bias"])
            h_ef = self.edgefn(get_edge_fn_input(g, ef=ef, nf=nf, gf=gf))
            h_nf = self.nodefn(get_node_fn_input(g, ef=h_ef, nf=nf, gf=gf))
        h_gf = self.graphfn(get_graph_fn_input(g, ef=h_ef, nf=h_nf, gf=gf))
        return zerodim2nothing(g.with_features(ef=h_ef, nf=h_nf, gf=h_gf))

    def _edge_update_split(self, g: GraphsTuple, ef, nf, gf, ef_ln, dtype,
                           training: bool):
        """Split-linear edge update: the fused kernel on a uniform layout
        with kernels on, else gather-after-transform partial sums.
        Returns ``(h_ef, agg)``; ``agg`` is the kernel's f32 edge->node sum
        or ``None``."""
        from ..ops.kernels.edge_update import (fused_edge_update_agg,
                                               supports_fused_edge_update)
        de, dn, dg = self.in_dims
        E, N, G = g.num_edge_slots, g.num_node_slots, g.num_graph_slots
        w, b = self.edgefn.w, self.edgefn.b
        if (use_kernels() and g.slot_shape is not None
                and de > 0 and dn > 0 and dg > 0
                and supports_fused_edge_update(E, N, G, de, self.out_dims[0],
                                               *g.slot_shape, ef.dtype)):
            if training:
                raise NotImplementedError(
                    "the fused edge update has no backward yet; train with "
                    "enable_kernels(False)")
            ts = matmul_f32(nf, w[de:de + dn])
            tr = matmul_f32(nf, w[de + dn:de + 2 * dn])
            tg = matmul_f32(gf, w[de + 2 * dn:])
            h, agg = fused_edge_update_agg(ef, ef_ln, w[:de], ts, tr, tg, b,
                                           g.senders, g.receivers,
                                           *g.slot_shape)
            return h.to(dtype), agg
        if ef_ln is not None:
            ef = layer_norm(ef, ef_ln["scale"], ef_ln["bias"])
        return _linear_split(
            self.edgefn, dtype,
            [(ef, None), (nf, g.senders), (nf, g.receivers),
             (gf, g.edge_graph)], rows=E), None
