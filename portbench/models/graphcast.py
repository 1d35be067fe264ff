"""GraphCast (arXiv:2212.12794 §3) for the benchmark: the port's model built
from a configuration, weights made on the device from the seed, and the
model FLOPs of one training step.

The configuration's ``model`` entry names the published settings
(``graphcast/graphcast.py`` ``ModelConfig``): ``resolution``,
``mesh_size`` (levels 0 ... ``mesh_size`` merged), ``latent_size``,
``hidden_size``, ``hidden_layers`` (1: every MLP one hidden layer),
``gnn_msg_steps`` (processor layers), ``input_channels``,
``output_channels``, ``mesh_node_features`` and ``edge_features``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from models import gn


def build(port, model: dict, device) -> torch.nn.Module:
    """The port's ``GraphCast`` for ``model`` on ``device``."""
    if model["hidden_layers"] != 1:
        raise ValueError("the port's MLPs have one hidden layer")
    return port.GraphCast(
        grid_in=model["input_channels"], grid_out=model["output_channels"],
        latent=model["latent_size"], hidden=model["hidden_size"],
        n_layers=model["gnn_msg_steps"], mesh_in=model["mesh_node_features"],
        edge_in=model["edge_features"], device=device)


# The output MLP's last layer (weight and bias) is drawn at this share of
# the others' scale, so the first prediction lies within about 1e-3 of
# persistence (no 6-hour change).  The first step's gradient is then each
# sample's fit to its own targets, which differ from sample to sample,
# rather than the shrinking of a random first prediction, which every
# sample of the same distribution shares: a step trained on part of the
# batch moves that gradient by far more than bf16 rounding does.
OUTPUT_SCALE = 1e-3


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """``models/gn.make_weights`` (matrices glorot-uniform, biases and
    LayerNorm offsets uniform in [-0.1, 0.1), scales in [0.9, 1.1)), with
    the output layer ``output.l1`` times ``OUTPUT_SCALE``."""
    out = gn.make_weights(shapes, seed, device)
    for name in ("output.l1.w", "output.l1.b"):
        out[name].mul_(OUTPUT_SCALE)
    return out


def counts(model: dict) -> Dict[str, int]:
    """One sample's rows that follow from the configuration alone: grid
    and mesh nodes, mesh edges (both directions of every level's 30 * 4^l
    edges) and m2g edges (three a grid node)."""
    res, size = model["resolution"], model["mesh_size"]
    grid = (int(round(180 / res)) + 1) * int(round(360 / res))
    return {"grid": grid, "mesh": 10 * 4 ** size + 2,
            "mesh_edges": 2 * sum(30 * 4 ** lv for lv in range(size + 1)),
            "m2g": 3 * grid}


def _mlp(rows: float, din: int, hidden: int, dout: int) -> float:
    return rows * (din * hidden + hidden * dout)


def _interaction(edges: float, senders: float, receivers: float, d: int,
                 h: int) -> float:
    """An interaction network's products in the split form the port
    computes: the edge MLP's first layer as ``e @ W_e`` on the edges and
    the two node projections on their tables, then its second layer on
    the edges; the node MLP on the receivers."""
    edge = edges * d * h + senders * d * h + receivers * d * h \
        + edges * h * d
    return edge + _mlp(receivers, 2 * d, h, d)


def step_flops(model: dict, rows) -> float:
    """Model FLOPs of one training step on ``rows = (E, N, B)``: real edges
    and nodes of every set and the samples.  The g2m edges are what is
    left of a sample's edges after the mesh's and m2g's.  The forward's
    products counted once (no recompute), the backward as twice the
    forward."""
    E, _, B = rows
    c = counts(model)
    d, h = model["latent_size"], model["hidden_size"]
    g2m = E / B - c["mesh_edges"] - c["m2g"]
    ng, nm = c["grid"], c["mesh"]
    fe = model["edge_features"]
    fwd = (_mlp(ng, model["input_channels"], h, d)
           + _mlp(nm, model["mesh_node_features"], h, d)
           + _mlp(g2m + c["mesh_edges"] + c["m2g"], fe, h, d)
           + _interaction(g2m, ng, nm, d, h) + _mlp(ng, d, h, d)
           + model["gnn_msg_steps"] * _interaction(c["mesh_edges"], nm, nm,
                                                   d, h)
           + _interaction(c["m2g"], nm, ng, d, h)
           + _mlp(ng, d, h, model["output_channels"]))
    return 3.0 * 2.0 * B * fwd
