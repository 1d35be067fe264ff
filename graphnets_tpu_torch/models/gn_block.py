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

Routes: on a uniform slot layout with kernels on, the edge update runs in
the fused CUDA kernel (``ops/kernels/edge_update``) where the JAX package's
gate admits the shape: in inference with the edge->node sum in the same
pass where the gate admits that too (``with_agg``), else, and under
training, without it (its backward composes the segment-sum, gather and
LN->matmul backward kernels) and followed by the sorted segment-sum
kernel, as ``gn_block.py:344-376`` of the JAX package decides.  Every
other batch (``PadSpec.bucketed``, the sort task's pad, a shape the gate
refuses) takes the split-linear path (``gn_block.py:123-229,
434-448``): partial products at N and G rows gathered to the edge slots,
with kernels on the first sorted term deferred to ``sorted_gather_add``
and the row completed inside ``ln_matmul`` with the f32 sum as its addend,
so the LN of ``ef`` and the f32 partial sum never reach device memory.
A single graph (G = 1, the large-graph and sampled-subgraph batches) whose
shape the JAX package's gate admits takes the single-graph kernel
(``ops/kernels/edge_update_g1``, ``gn_block.py:377-433``): the receiver
gather, ``LN(ef) @ W0`` and the sender / graph / bias addends in one pass,
with the edge->node sum in the same pass in inference and, by default,
under training.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..graph import GraphsTuple
from ..nn.core import Linear, layer_norm
from ..ops import scatter
from ..ops.ln_linear import matmul_f32
from ..utils.config import (bf16_gather_partials, g1_agg_fusion_training,
                            use_kernels, use_split_linear)

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
    no columns).  The receivers ascend: their gather is declared sorted."""
    ef = g.ef if ef is ... else ef
    nf = g.nf if nf is ... else nf
    gf = g.gf if gf is ... else gf
    parts = [ef]
    if nf is not None:
        parts.append(scatter.gather_nodes(nf, g.senders))
        parts.append(scatter.gather_nodes(nf, g.receivers, idx_sorted=True))
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
        scatter.aggregate_edges_for_globals(
            ef, g.edge_graph, g.num_graph_slots, g.edge_mask,
            mask_aliases_real=g.pad_aliases_real),
        scatter.aggregate_nodes_for_globals(
            nf, g.node_graph, g.num_graph_slots, g.node_mask,
            mask_aliases_real=g.pad_aliases_real),
    ]
    if gf is not None:
        parts.append(gf)
    return _concat(parts)


getedgefninput = get_edge_fn_input
getnodefninput = get_node_fn_input
getgraphfninput = get_graph_fn_input


def _linear_split(lin: Linear, out_dtype: torch.dtype, terms: Sequence[tuple],
                  rows: int) -> torch.Tensor:
    """``concat(xs, -1) @ W + b`` as a sum of per-segment products.

    ``terms`` is a sequence of ``(x, idx)``, ``(x, idx, ln_params)``,
    ``(x, idx, ln_params, idx_sorted)`` or ``(x, idx, ln_params,
    idx_sorted, windows)``.  Each ``x`` consumes the next ``x.shape[-1]``
    rows of ``W``; with ``idx`` the f32 partial product is gathered by
    ``idx`` after the product (gather-after-transform; ``idx_sorted`` and
    ``windows`` as in ``scatter.take_rows_sorted_grad``).  With
    ``ln_params`` the term is ``LayerNorm(x) @ W_slice``, computed by the
    fused ``ln_matmul`` kernel.  The order of the sum is the JAX package's
    (``gn_block.py:145-229``): the other partials in f32, the bias, then
    with kernels on the first sorted gathered term by ``sorted_gather_add``,
    and last the LN term inside ``ln_matmul`` with that f32 sum as its
    addend: one rounding, and the f32 sum never returns to device memory
    between the two.
    """
    from ..ops.kernels.gather import sorted_gather_add, supports_sorted_gather
    from ..ops.kernels.ln_linear import ln_matmul
    w, b = lin.w, lin.b
    dout = w.shape[1]
    acc = None
    off = 0
    ln_term = None       # (x, ln_params, w_slice): completed last, fused
    fused_gather = None  # (partial table, idx): completed last but one
    for term in terms:
        x, idx = term[0], term[1]
        ln_params = term[2] if len(term) > 2 else None
        idx_sorted = term[3] if len(term) > 3 else False
        windows = term[4] if len(term) > 4 else None
        d = x.shape[-1]
        if d == 0:
            continue
        ws = w[off:off + d]
        off += d
        if ln_params is not None:
            if idx is not None or ln_term is not None:
                raise ValueError("one ungathered LayerNorm term at most")
            ln_term = (x, ln_params, ws)
            continue
        y = matmul_f32(x, ws)
        if idx is not None:
            # Partials gather in f32, except large bandwidth-bound gathers
            # of bf16 inputs, which round to bf16 first (the config gate).
            if (x.dtype == torch.bfloat16
                    and bf16_gather_partials(idx.shape[0])):
                y = y.to(torch.bfloat16)
            if (idx_sorted and fused_gather is None and use_kernels()
                    and supports_sorted_gather(idx.shape[0], y.shape[0],
                                               y.shape[1])):
                fused_gather = (y, idx)
                continue
            y = scatter.take_rows_sorted_grad(y, idx, idx_sorted, windows)
        acc = y.float() if acc is None else acc + y.float()
    if acc is None and ln_term is None and fused_gather is None:
        # All-zero-width input: Linear(0, dout) is a bias broadcast.
        acc = torch.zeros(rows, dout, dtype=torch.float32, device=w.device)
    if b is not None:
        acc = b.float() if acc is None else acc + b.float()
    if fused_gather is not None:
        yt, gidx = fused_gather
        if acc is None:
            acc = scatter.take_rows_sorted_grad(yt, gidx, True).float()
        else:
            acc = sorted_gather_add(yt, gidx,
                                    acc.expand(rows, dout).contiguous())
    if ln_term is not None:
        x, ln_params, ws = ln_term
        if acc is None:
            acc = torch.zeros(rows, dout, dtype=torch.float32,
                              device=w.device)
        return ln_matmul(x, ln_params["scale"], ln_params["bias"], ws,
                         addend=acc.expand(rows, dout).contiguous()
                         ).to(out_dtype)
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

        if ef_ln is not None and not (use_split_linear() and de > 0
                                      and use_kernels()):
            # Materialise the LN: the pure path keeps the module numerics.
            ef = layer_norm(ef, ef_ln["scale"], ef_ln["bias"])
            ef_ln = None
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
                                  (gf, g.node_graph, None, True)], rows=N)
        else:
            h_ef = self.edgefn(get_edge_fn_input(g, ef=ef, nf=nf, gf=gf))
            h_nf = self.nodefn(get_node_fn_input(g, ef=h_ef, nf=nf, gf=gf))
        h_gf = self.graphfn(get_graph_fn_input(g, ef=h_ef, nf=h_nf, gf=gf))
        return zerodim2nothing(g.with_features(ef=h_ef, nf=h_nf, gf=h_gf))

    def _edge_update_split(self, g: GraphsTuple, ef, nf, gf, ef_ln, dtype,
                           training: bool):
        """Split-linear edge update: the fused kernel on a uniform layout
        with kernels on, the single-graph kernel for G = 1, else
        gather-after-transform partial sums (with kernels on completed by
        ``sorted_gather_add`` and ``ln_matmul``).  Returns ``(h_ef, agg)``;
        ``agg`` is a kernel's f32 edge->node sum or ``None``.  Under
        training, and where the gate refuses ``with_agg``, the uniform
        kernel writes ``h`` alone (the JAX package measured the fused sum's
        backward slower than a separate aggregation there); the
        single-graph kernel keeps the sum unless ``g1_agg_fusion_training``
        is off, and writes ``h`` over its dead sender term."""
        from ..ops.kernels.edge_update import (fused_edge_update,
                                               fused_edge_update_agg,
                                               supports_fused_edge_update)
        de, dn, dg = self.in_dims
        E, N, G = g.num_edge_slots, g.num_node_slots, g.num_graph_slots
        w, b = self.edgefn.w, self.edgefn.b
        if (use_kernels() and g.slot_shape is not None
                and de > 0 and dn > 0 and dg > 0
                and supports_fused_edge_update(E, N, G, de, self.out_dims[0],
                                               *g.slot_shape, ef.dtype)):
            ts = matmul_f32(nf, w[de:de + dn])
            tr = matmul_f32(nf, w[de + dn:de + 2 * dn])
            tg = matmul_f32(gf, w[de + 2 * dn:])
            # The sum fuses in inference where the gate admits it too
            # (``gn_block.py:362-365``); training keeps the separate sum.
            if not training and supports_fused_edge_update(
                    E, N, G, de, self.out_dims[0], *g.slot_shape, ef.dtype,
                    with_agg=True):
                h, agg = fused_edge_update_agg(ef, ef_ln, w[:de], ts, tr, tg,
                                               b, g.senders, g.receivers,
                                               *g.slot_shape)
                return h.to(dtype), agg
            return fused_edge_update(ef, ef_ln, w[:de], ts, tr, tg, b,
                                     g.senders, g.receivers,
                                     *g.slot_shape).to(dtype), None
        if use_kernels() and G == 1 and de > 0 and dn > 0:
            from ..ops.kernels.edge_update_g1 import (
                fused_g1_edge_update, fused_g1_edge_update_agg,
                supports_g1_edge_update)
            de_o = self.out_dims[0]
            bf16_parts = (ef.dtype == torch.bfloat16
                          and bf16_gather_partials(E))
            part_itemsize = 2 if bf16_parts else 4
            itemsize = ef.element_size()
            if supports_g1_edge_update(E, N, de, de_o, itemsize,
                                       part_itemsize=part_itemsize):
                pdt = ef.dtype if bf16_parts else torch.float32
                ts = matmul_f32(nf, w[de:de + dn]).to(pdt)
                tr = matmul_f32(nf, w[de + dn:de + 2 * dn]).to(pdt)
                # The senders are in no order: the one random-access
                # stream of the path; its backward sorts once and saves
                # only the ids, so ``src`` is dead after the kernel, which
                # writes h over it where the types match (the JAX kernel's
                # donation, ``edge_update_g1.py:296-301``).
                src = scatter.take_rows_sorted_grad(ts, g.senders)
                gb = torch.zeros(de_o, dtype=torch.float32, device=w.device)
                if dg > 0:
                    gb = gb + matmul_f32(gf, w[de + 2 * dn:])[0]
                if b is not None:
                    gb = gb + b.float()
                if ((not training or g1_agg_fusion_training())
                        and supports_g1_edge_update(
                            E, N, de, de_o, itemsize, with_agg=True,
                            part_itemsize=part_itemsize)):
                    h, agg = fused_g1_edge_update_agg(
                        ef, ef_ln, w[:de], src, tr, g.receivers, gb,
                        src_is_dead=True)
                    return h.to(dtype), agg
                return fused_g1_edge_update(
                    ef, ef_ln, w[:de], src, tr, g.receivers, gb,
                    src_is_dead=True).to(dtype), None
        # The senders are unsorted within each graph but local to it: with
        # many small graphs their backward scatter takes per-graph windows
        # (the windowed kernel) instead of a sort.
        windows = None
        if use_kernels() and G > 1 and N <= 256 * G:
            gi = torch.arange(G + 1, dtype=torch.int32,
                              device=g.node_graph.device)
            windows = (
                torch.searchsorted(g.node_graph, gi).to(torch.int32),
                torch.searchsorted(g.edge_graph, gi).to(torch.int32))
        ef_term = (ef, None) if ef_ln is None else (ef, None, ef_ln)
        return _linear_split(
            self.edgefn, dtype,
            [ef_term, (nf, g.senders, None, False, windows),
             (nf, g.receivers, None, True),
             (gf, g.edge_graph, None, True)], rows=E), None
