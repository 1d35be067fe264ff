"""GraphCast's forward pass and loss in plain f32 torch, from the equations
(Lam et al., arXiv:2212.12794 §3, Supplementary §3, eq. 19): the reference
the port's ``models/graphcast.py`` and ``training/losses.py`` are tested
against.  It imports neither JAX, ``graphnets_tpu`` nor anything of the
port, and takes the graph as index arrays and features on real rows only.

* Every MLP is ``Linear -> swish -> Linear -> LayerNorm`` (``(x - mean) /
  sqrt(var + 1e-5) * scale + bias``), the output MLP without the LayerNorm;
  a linear layer is ``x @ w + b`` with ``w [din, dout]``.
* An edge update takes the concatenation ``[e, v_s[senders],
  v_r[receivers]]`` through one matrix, the published form; a node update
  ``[v_r, sum of the updated edges over each receiver]``; every update is
  residual, and the processor's edges are updated too.
* The loss is ``mean_i sum_j a_i w_j (pred_ij - target_ij) ** 2``.

Parameters are a dict keyed by the port's names (``grid_embed.l0.w``,
``processor.3.edge.ln.scale``, ...).  A graph is a dict: ``nodes``, the
node features ``grid [Ng, Fg]`` and ``mesh [Nm, Fm]``, and ``edges``, for
each edge set ``g2m``, ``mesh`` and ``m2g`` a tuple ``(senders, receivers,
features)`` (int64 ids into the sender and receiver sets).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5


def layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * scale + bias


def mlp(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor
        ) -> torch.Tensor:
    h = F.silu(x @ p[name + ".l0.w"] + p[name + ".l0.b"])
    y = h @ p[name + ".l1.w"] + p[name + ".l1.b"]
    if name + ".ln.scale" not in p:
        return y
    return layer_norm(y, p[name + ".ln.scale"], p[name + ".ln.bias"])


def interaction(p, name, e, v_s, v_r, senders, receivers
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(e', v_r + MLP_v([v_r, sum e']))`` with ``e' = MLP_e([e,
    v_s[senders], v_r[receivers]])``."""
    e_new = mlp(p, name + ".edge",
                torch.cat([e, v_s[senders], v_r[receivers]], -1))
    agg = torch.zeros(v_r.shape[0], e_new.shape[1], dtype=e_new.dtype,
                      device=e_new.device).index_add(0, receivers, e_new)
    return e_new, v_r + mlp(p, name + ".node", torch.cat([v_r, agg], -1))


def forward(p: Dict[str, torch.Tensor], graph: dict, n_layers: int
            ) -> torch.Tensor:
    """The grid prediction ``[Ng, C]``."""
    g2m, mesh, m2g = (graph["edges"][k] for k in ("g2m", "mesh", "m2g"))
    v_g = mlp(p, "grid_embed", graph["nodes"]["grid"])
    v_m = mlp(p, "mesh_embed", graph["nodes"]["mesh"])
    e_m = mlp(p, "mesh_edge_embed", mesh[2])
    _, v_m = interaction(p, "encoder", mlp(p, "g2m_embed", g2m[2]), v_g,
                         v_m, g2m[0], g2m[1])
    v_g = v_g + mlp(p, "grid_update", v_g)
    for i in range(n_layers):
        e_new, v_m = interaction(p, f"processor.{i}", e_m, v_m, v_m,
                                 mesh[0], mesh[1])
        e_m = e_m + e_new
    _, v_g = interaction(p, "decoder", mlp(p, "m2g_embed", m2g[2]), v_m,
                         v_g, m2g[0], m2g[1])
    return mlp(p, "output", v_g)


def loss(pred, target, node_weights, channel_weights) -> torch.Tensor:
    """``mean_i sum_j a_i w_j (pred_ij - target_ij) ** 2`` (eq. 19)."""
    per = (pred - target).square() * channel_weights[None, :]
    return (per.sum(-1) * node_weights).mean()


def loss_and_grads(params: Dict[str, torch.Tensor], graph: dict,
                   target, node_weights, channel_weights, n_layers: int):
    """The loss and its gradient by parameter, in f32."""
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in params.items()}
    lo = loss(forward(p, graph, n_layers), target, node_weights,
              channel_weights)
    lo.backward()
    return lo.detach(), {k: v.grad for k, v in p.items()}
