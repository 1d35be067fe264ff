"""GraphCast (Lam et al., arXiv:2212.12794 §3 and Supplementary §3; the
released ``graphcast/graphcast.py``, ``deep_typed_graph_net.py``) on a
``typed_graph.TypedGraph`` of the grid and the multi-mesh
(``data/graphcast_mesh``).

Every MLP is ``Linear(din, hidden) -> swish -> Linear(hidden, dout) ->
LayerNorm(dout)`` (:class:`SwishMLP`; the LayerNorm is the usual one,
``(x - mean) / sqrt(var + 1e-5)`` with a learned scale and offset), except
the output MLP, which has none.  Every update is residual.

* **Embed**: the grid nodes, the mesh nodes and the g2m, mesh and m2g
  edges, one MLP each.
* **Encoder**: one bipartite :class:`InteractionNetwork` from the grid to
  the mesh over the g2m edges, and ``v_G += MLP(v_G)``.
* **Processor**: ``n_layers`` interaction networks on the multi-mesh, no
  weights shared; each also updates the mesh edges, ``e_M += e'``.
* **Decoder**: an interaction network from the mesh to the grid over the
  m2g edges, then the output MLP on the grid.

An interaction network's edge MLP takes ``[e, v_s[senders],
v_r[receivers]]``.  Its first layer is computed split, each term on the rows
it lives on: ``e @ W_e + (v_s @ W_s)[senders] + (v_r @ W_r)[receivers] +
b``, the node tables projected before the gathers, and the updated edges
are summed onto their receivers by the sorted segment sum
(``segment_sum(..., sorted_pad_safe=True)``).  The weight is the one
``[3 * d, hidden]`` matrix of the concatenated form, sliced.  That layer
and its swish are one pass, ``ops/kernels/split_edge_layer`` (the receivers
declared sorted): its kernel for CUDA tensors where its gate holds, its
plain version for CPU tensors; a CUDA shape outside the gate, or the
kernels switched off, takes the composed form (``ops/scatter.gather_nodes``,
then ``F.silu``).

With the tracing switch on, the forward puts the stage markers
``encoder``, ``processor`` and ``decoder`` (``utils/profiling.STAGES``),
and identities at the stage boundaries put ``decoder_bwd``,
``processor_bwd`` and ``encoder_bwd`` in the backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import Linear, init_generator
from ..ops.kernels.split_edge_layer import (split_edge_layer,
                                            supports_split_edge_layer)
from ..ops.scatter import gather_nodes, segment_sum
from ..typed_graph import EdgeSet, TypedGraph
from ..utils.config import resolve_device, use_kernels
from ..utils.profiling import PhaseMarkers

__all__ = ["SwishMLP", "InteractionNetwork", "GraphCast"]

LN_EPS = 1e-5


class SwishMLP(nn.Module):
    """``Linear(din, hidden) -> swish -> Linear(hidden, dout)``, then a
    LayerNorm over ``dout`` where ``layer_norm``.  Parameters ``l0.w [din,
    hidden]``, ``l0.b``, ``l1.w``, ``l1.b`` and ``ln.scale`` / ``ln.bias``
    (ones and zeros)."""

    def __init__(self, din: int, dout: int, hidden: int,
                 layer_norm: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = init_generator(generator)
        self.l0 = Linear(din, hidden, device=device, generator=gen)
        self.l1 = Linear(hidden, dout, device=device, generator=gen)
        self.ln = None
        if layer_norm:
            self.ln = nn.Module()
            self.ln.scale = nn.Parameter(torch.ones(dout, device=device))
            self.ln.bias = nn.Parameter(torch.zeros(dout, device=device))

    def tail(self, pre: torch.Tensor) -> torch.Tensor:
        """The MLP from its first layer's output ``pre`` on."""
        return self.out(F.silu(pre))

    def out(self, h: torch.Tensor) -> torch.Tensor:
        """The MLP from its activation ``h`` on: ``l1``, then the
        LayerNorm."""
        y = self.l1(h)
        if self.ln is None:
            return y
        return F.layer_norm(y, y.shape[-1:], self.ln.scale.to(y.dtype),
                            self.ln.bias.to(y.dtype), LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.l0(x.to(self.l0.w.dtype)))


def _takes_split_layer(e: torch.Tensor, latent: int, hidden: int) -> bool:
    """Whether an edge MLP's first layer and swish go through
    ``split_edge_layer``: CPU tensors (its plain version), and tensors on
    the card where the kernels are on and its gate holds (the receivers are
    sorted: ``EdgeSet``'s contract)."""
    if e.device.type == "cpu":
        return True
    return use_kernels() and supports_split_edge_layer(
        e.shape[0], latent, hidden, e.dtype, receivers_sorted=True)


class InteractionNetwork(nn.Module):
    """One message-passing step over an edge set from a sender node set to
    a receiver node set (the same set for the mesh):
    ``e' = MLP_e([e, v_s[senders], v_r[receivers]])`` and ``v_r' = v_r +
    MLP_v([v_r, sum of e' over each receiver's edges])``.
    :meth:`forward` returns ``(e', v_r')``; a caller that keeps the edges
    adds ``e'`` to them."""

    def __init__(self, latent: int, hidden: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = init_generator(generator)
        self.latent = latent
        self.edge = SwishMLP(3 * latent, latent, hidden, device=device,
                             generator=gen)
        self.node = SwishMLP(2 * latent, latent, hidden, device=device,
                             generator=gen)

    def forward(self, e: torch.Tensor, v_s: torch.Tensor, v_r: torch.Tensor,
                es: EdgeSet) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.latent
        w, b = self.edge.l0.w, self.edge.l0.b
        # The node tables' projections are temporaries: nothing holds them
        # past the layer (the decoder's grid table is [N_grid, hidden]).
        if _takes_split_layer(e, d, w.shape[1]):
            e_new = self.edge.out(split_edge_layer(
                e, w[:d], v_s @ w[d:2 * d], v_r @ w[2 * d:], b, es.senders,
                es.receivers))
        else:
            pre = (e @ w[:d]
                   + gather_nodes(v_s @ w[d:2 * d], es.senders)
                   + gather_nodes(v_r @ w[2 * d:], es.receivers,
                                  idx_sorted=True)
                   + b)
            e_new = self.edge.tail(pre)
        agg = segment_sum(e_new, es.receivers, v_r.shape[0],
                          sorted_pad_safe=True)
        wn, bn = self.node.l0.w, self.node.l0.b
        v_new = v_r + self.node.tail(v_r @ wn[:d] + agg @ wn[d:] + bn)
        return e_new, v_new


class GraphCast(nn.Module):
    """GraphCast on a ``TypedGraph`` with node sets ``grid`` (``grid_in``
    input channels a node) and ``mesh`` (``mesh_in``) and edge sets
    ``g2m``, ``mesh`` and ``m2g`` (``edge_in`` features an edge).
    ``forward(x)`` returns the grid prediction ``[N_grid, grid_out]`` (the
    padding rows too) in the parameters' type; inputs are cast to it.
    GraphCast_small: ``latent = hidden = 512``, ``n_layers = 16``,
    ``grid_in = 186``, ``grid_out = 83``."""

    def __init__(self, grid_in: int = 186, grid_out: int = 83,
                 latent: int = 512, hidden: int = 512, n_layers: int = 16,
                 mesh_in: int = 3, edge_in: int = 4, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = init_generator(generator)
        kw = dict(device=device, generator=gen)
        self.grid_embed = SwishMLP(grid_in, latent, hidden, **kw)
        self.mesh_embed = SwishMLP(mesh_in, latent, hidden, **kw)
        self.g2m_embed = SwishMLP(edge_in, latent, hidden, **kw)
        self.mesh_edge_embed = SwishMLP(edge_in, latent, hidden, **kw)
        self.m2g_embed = SwishMLP(edge_in, latent, hidden, **kw)
        self.encoder = InteractionNetwork(latent, hidden, **kw)
        self.grid_update = SwishMLP(latent, latent, hidden, **kw)
        self.processor = nn.ModuleList([InteractionNetwork(latent, hidden,
                                                           **kw)
                                        for _ in range(n_layers)])
        self.decoder = InteractionNetwork(latent, hidden, **kw)
        self.output = SwishMLP(latent, grid_out, hidden, layer_norm=False,
                               **kw)

    def forward(self, x: TypedGraph, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        g2m, mesh, m2g = x.edges["g2m"], x.edges["mesh"], x.edges["m2g"]
        mark = PhaseMarkers(self.output.l0.w.device)
        mark("encoder")
        v_g = self.grid_embed(x.nodes["grid"])
        v_m = self.mesh_embed(x.nodes["mesh"])
        e_m = self.mesh_edge_embed(mesh.features)
        e_m2g = self.m2g_embed(m2g.features)
        _, v_m = self.encoder(self.g2m_embed(g2m.features), v_g, v_m, g2m)
        v_g = v_g + self.grid_update(v_g)
        v_g, v_m, e_m, e_m2g = mark.boundary("encoder_bwd", v_g, v_m, e_m,
                                             e_m2g)
        mark("processor")
        for layer in self.processor:
            e_new, v_m = layer(e_m, v_m, v_m, mesh)
            e_m = e_m + e_new
        v_g, v_m, e_m2g = mark.boundary("processor_bwd", v_g, v_m, e_m2g)
        mark("decoder")
        _, v_g = self.decoder(e_m2g, v_m, v_g, m2g)
        pred, = mark.boundary("decoder_bwd", self.output(v_g))
        return pred
