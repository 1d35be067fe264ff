"""Plain PyTorch reference of GraphCast (Lam et al., arXiv:2212.12794 §3,
Supplementary §3, eq. 19) and of its AdamW training step, for the
benchmark's comparison.  It imports nothing of the program.

Written from the equations on real rows only: no padding, no kernels, no
split first layers.

* Every MLP is ``Linear -> swish -> Linear -> LayerNorm`` (``(x - mean) /
  sqrt(var + 1e-5) * scale + bias``), the output MLP without the LayerNorm;
  a linear layer is ``x @ w + b`` with ``w [din, dout]``.
* An interaction network's edge update takes the concatenation ``[e,
  v_s[senders], v_r[receivers]]`` through one matrix, the published form;
  its node update ``[v_r, sum of the updated edges over each receiver]``;
  every update is residual.  The encoder runs over the g2m edges and adds
  ``MLP(v_G)`` to the grid; the processor's ``n`` layers update the mesh's
  nodes and edges; the decoder runs over the m2g edges, then the output
  MLP.
* The loss is ``mean_i sum_j a_i w_j (pred_ij - target_ij) ** 2`` over the
  grid nodes of every sample (``a_i`` latitude, ``w_j`` channel weights).
* AdamW and the loop are ``reference/training.py``'s.

``precision`` is ``reference/gn.py``'s: ``"f32"`` (TF32 off), and for the
controls ``"tf32"`` (every product's operands rounded) or ``"fp8"`` (those
and every activation and its gradient kept in fp8).  Each processor layer
runs under activation checkpointing, recomputed in the same arithmetic, so
four samples' f32 activations fit on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import training
from .gn import matmul, store
from .training import Readings

EPS = 1e-5
EDGE_SETS = ("g2m", "mesh", "m2g")


@dataclasses.dataclass
class Batch:
    """A batch on real rows: ``nodes`` (``grid [Ng, C_in]``, ``mesh [Nm,
    F]``), ``edges`` (``g2m``, ``mesh``, ``m2g``: int64 senders and
    receivers into the sender and receiver sets, and ``[E, F]``
    features), the loss's ``node_weights [Ng]`` and ``channel_weights
    [C_out]``, the ``samples`` and the grid nodes of one."""
    nodes: Dict[str, torch.Tensor]
    edges: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    node_weights: torch.Tensor
    channel_weights: torch.Tensor
    samples: int
    grid_nodes: int


def _layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * scale + bias


def _linear(p, name, x, precision):
    return store(matmul(x, p[name + ".w"], precision) + p[name + ".b"],
                 precision)


def mlp(p, name, x, precision):
    h = store(F.silu(_linear(p, name + ".l0", x, precision)), precision)
    y = _linear(p, name + ".l1", h, precision)
    if name + ".ln.scale" not in p:
        return y
    return store(_layer_norm(y, p[name + ".ln.scale"],
                             p[name + ".ln.bias"]), precision)


def interaction(p, name, e, v_s, v_r, senders, receivers, precision):
    """``(e', v_r + MLP_v([v_r, sum e']))`` with ``e' = MLP_e([e,
    v_s[senders], v_r[receivers]])``."""
    e_new = mlp(p, name + ".edge",
                torch.cat([e, v_s[senders], v_r[receivers]], -1), precision)
    agg = torch.zeros(v_r.shape[0], e_new.shape[1], dtype=e_new.dtype,
                      device=e_new.device).index_add(0, receivers, e_new)
    agg = store(agg, precision)
    v_new = store(v_r + mlp(p, name + ".node",
                            torch.cat([v_r, agg], -1), precision), precision)
    return e_new, v_new


def forward(p: Dict[str, torch.Tensor], x: Batch, model: dict,
            precision: str = "f32") -> torch.Tensor:
    """The grid prediction ``[Ng, C_out]``."""
    g2m, mesh, m2g = (x.edges[k] for k in EDGE_SETS)
    v_g = mlp(p, "grid_embed", x.nodes["grid"], precision)
    v_m = mlp(p, "mesh_embed", x.nodes["mesh"], precision)
    e_m = mlp(p, "mesh_edge_embed", mesh[2], precision)
    _, v_m = interaction(p, "encoder", mlp(p, "g2m_embed", g2m[2],
                                           precision),
                         v_g, v_m, g2m[0], g2m[1], precision)
    v_g = store(v_g + mlp(p, "grid_update", v_g, precision), precision)
    senders, receivers = mesh[0], mesh[1]
    for i in range(model["gnn_msg_steps"]):
        def layer(e, v, name=f"processor.{i}"):
            e_new, v = interaction(p, name, e, v, v, senders, receivers,
                                   precision)
            return store(e + e_new, precision), v
        e_m, v_m = checkpoint(layer, e_m, v_m, use_reentrant=False)
    _, v_g = interaction(p, "decoder", mlp(p, "m2g_embed", m2g[2],
                                           precision),
                         v_m, v_g, m2g[0], m2g[1], precision)
    return mlp(p, "output", v_g, precision)


def per_row(pred, target, x: Batch) -> torch.Tensor:
    """``a_i sum_j w_j (pred_ij - target_ij) ** 2``, a grid node each."""
    d = (pred - target).square() * x.channel_weights
    return d.sum(-1) * x.node_weights


def half_batch(x: Batch) -> torch.Tensor:
    """A planted fault: the loss's mean over the first half of the
    samples' grid nodes, as ``keep`` for :func:`train`."""
    rows = x.node_weights.shape[0]
    return torch.arange(rows, device=x.node_weights.device) < (
        x.samples // 2) * x.grid_nodes


def train(params: Dict[str, torch.Tensor], batches: Sequence, model: dict,
          lr: float, precision: str = "f32", keep=None) -> Readings:
    """AdamW steps from ``params`` (left untouched), one per ``(x, y)`` of
    ``batches``; the loss of each step, the norms of the first step's
    gradients and of each parameter's change after the last step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step_loss(p, x, y, keep_t):
        r = per_row(forward(p, x, model, precision), y, x)
        scale = float(r.detach().abs().mean())
        if keep_t is not None:
            r = r[keep_t]
        return r.mean(), scale
    return training.train(params, batches, step_loss, lr, keep)
