"""Graph-network models of the benchmark's configurations: the port's
model built from a configuration, weights made on the device from the
seed, and the model FLOPs of one training step.

A configuration with ``x_dims`` and ``y_dims`` is an encode-process-decode
model (``EncodeProcessDecode``: an encoder block, ``n_cores`` cores, a
decoder block); one without is a stack of ``n_cores`` cores
(``GNCoreList``) at ``core_dims``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def build(port, model: dict, device) -> torch.nn.Module:
    """The port's model for ``model`` (the configuration's ``model``
    entry) on ``device``."""
    dims = tuple(model["core_dims"])
    if "x_dims" in model:
        return port.EncodeProcessDecode(
            x_dims=tuple(model["x_dims"]), core_dims=dims,
            y_dims=tuple(model["y_dims"]), n_cores=model["n_cores"],
            device=device)
    return port.GNCoreList([port.GNCore(dims, device=device)
                            for _ in range(model["n_cores"])])


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """f32 weights for the leaves ``shapes`` (name -> shape), drawn on
    ``device`` from ``seed`` in one call: each matrix glorot-uniform, each
    bias and LayerNorm offset uniform in [-0.1, 0.1), each LayerNorm scale
    uniform in [0.9, 1.1).  The tensors are views of one buffer."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        u = flat[off:off + n].view(shape)
        off += n
        if name.endswith(".w"):
            u.mul_(math.sqrt(6.0 / (shape[0] + shape[1])))
        elif name.endswith(".scale"):
            u.mul_(0.1).add_(1.0)
        else:
            u.mul_(0.1)
        out[name] = u
    return out


def _block_flops(din, dout, rows) -> float:
    """Forward matmul FLOPs of one block in the split-linear form: each
    term on the rows it lives on (edge terms on edges, node terms on nodes,
    graph terms on graphs)."""
    (de, dn, dg), (de_o, dn_o, dg_o) = din, dout
    E, N, G = rows
    edge = E * de + 2 * N * dn + G * dg
    node = N * de_o + N * dn + G * dg
    graph = G * (de_o + dn_o + dg)
    return 2.0 * (edge * de_o + node * dn_o + graph * dg_o)


def step_flops(model: dict, rows) -> float:
    """Model FLOPs of one training step on ``rows = (E, N, G)`` real edges,
    nodes and graphs: the forward's products counted once (no recompute),
    the backward as twice the forward."""
    dims = tuple(model["core_dims"])
    fwd = 0.0
    if "x_dims" in model:
        fwd += _block_flops(tuple(model["x_dims"]), dims, rows)
        fwd += _block_flops(dims, tuple(model["y_dims"]), rows)
    per_core = _block_flops(dims, dims, rows) + sum(
        16.0 * r * d * d for r, d in zip(rows, dims))
    fwd += model["n_cores"] * per_core
    return 3.0 * fwd
