"""Plain PyTorch reference of the benchmark's graph-network models and of
their AdamW training step.

Written from the published equations (GraphNets.jl's ``GNBlock`` /
``GNCore``, Battaglia et al. 2018, arXiv:1806.01261) and the semantics
the port follows, on real rows only: no padding, no kernels, no
split-linear partials, every feature set concatenated as the equations
write it.  It imports nothing of the program.

* ``LayerNorm`` is Flux's: ``(x - mean) / (std + eps) * scale + bias``
  with the uncorrected std (0 where the variance is 0), eps 1e-5.
* ``Linear`` is ``x @ w + b`` with ``w [din, dout]``.
* A block updates edges, then nodes, then graphs: edge input
  ``[ef, nf[senders], nf[receivers], gf[edge_graph]]``, node input
  ``[sum of updated incoming edges, nf, gf[node_graph]]``, graph input
  ``[sum of updated edges, sum of updated nodes, gf]``; an absent or
  zero-width feature set adds no columns, and a zero-width output is absent.
* A core is ``x + block(LN1(x)) + FFN(LN2(x))`` on each feature set, the
  FFN ``Dense(d, 4d, relu) -> Dense(4d, d)``.
* The loss is the mean softmax cross-entropy over the nodes plus the same
  over the edges.
* AdamW and the training loop are ``reference/training.py``'s, which
  every kind shares (its names are re-exported here).

Parameters are a dict keyed by the dotted names of the model's modules
(``core.0.block.edgefn.w``, ``0.ffwd.eff.0.w``, ...).  ``precision``
names the arithmetic: ``"f32"`` (TF32 off) for the reference, and for
the controls ``"tf32"``, which rounds every operand of every product,
forward and backward, or ``"fp8"``, which does so and also keeps every
activation (each product's output, each sum, LayerNorm's output, the
residual stream) and its gradient in fp8 (e4m3 forward, e5m2 backward,
scaled per tensor), as a bf16 configuration keeps them in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from . import training
from .training import (ADAM_EPS, BETA1, BETA2, WEIGHT_DECAY,  # noqa: F401
                       Readings, adamw_update)

EPS = 1e-5
ROWS = 1 << 17
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


@dataclasses.dataclass
class Graphs:
    """A batch of graphs on real rows: features (``None`` when absent),
    ``senders`` / ``receivers [E]``, the owning graph of each node and
    edge, and the numbers of nodes and graphs."""
    nf: Optional[torch.Tensor]
    ef: Optional[torch.Tensor]
    gf: Optional[torch.Tensor]
    senders: torch.Tensor
    receivers: torch.Tensor
    node_graph: torch.Tensor
    edge_graph: torch.Tensor
    n_node: int
    n_graph: int

    def with_features(self, nf, ef, gf) -> "Graphs":
        return dataclasses.replace(self, nf=nf, ef=ef, gf=gf)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` scaled by its largest magnitude onto ``dtype``'s range,
    rounded to it and scaled back (per-tensor scaling)."""
    amax = x.abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX[dtype] / amax
    return (x.float() * scale).to(dtype).float() / scale


def _round(x: torch.Tensor, precision: str, grad: bool) -> torch.Tensor:
    if precision == "tf32":
        return round_tf32(x)
    if precision == "fp8":
        return round_fp8(x, torch.float8_e5m2 if grad
                         else torch.float8_e4m3fn)
    raise ValueError(f"unknown precision {precision!r}")


class _LowPrecisionMatmul(torch.autograd.Function):
    """``a @ b`` with every operand rounded, forward and backward (the
    gradient in e5m2 under fp8, the usual split)."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return _round(a, precision, False) @ _round(b, precision, False)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.precision
        gq = _round(g, p, True)
        return (gq @ _round(b, p, False).t(),
                _round(a, p, False).t() @ gq, None)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return a @ b
    return _LowPrecisionMatmul.apply(a, b, precision)


class _Store(torch.autograd.Function):
    """An activation stored in fp8: rounded to e4m3 going forward, its
    gradient to e5m2 going back."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


def store(x: Optional[torch.Tensor], precision: str):
    """``x`` as the arithmetic keeps it between operations: fp8 is a
    storage type (every activation held in it, as bf16 is where a
    configuration computes in bf16); TF32 rounds only the products'
    operands, and f32 keeps all."""
    if x is None or precision != "fp8":
        return x
    return _Store.apply(x)


def layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    pos = var > 0
    std = torch.where(pos, torch.where(pos, var, 1.0).sqrt(), 0.0)
    return (x - mean) / (std + EPS) * scale + bias


def linear(p, name, x, precision):
    w, b = p[name + ".w"], p[name + ".b"]
    if w.shape[0] == 0:
        return b.expand(x.shape[0], -1)
    return store(matmul(x, w, precision) + b, precision)


def _cat(parts: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    return torch.cat([t for t in parts if t is not None
                      and t.shape[-1] > 0], -1)


def _segment_sum(x, ids, n):
    return torch.zeros(n, x.shape[1], dtype=x.dtype,
                       device=x.device).index_add(0, ids, x)


def _absent_if_empty(x):
    return None if x is None or x.shape[-1] == 0 else x


def by_rows(fn, *xs):
    """``fn`` applied to blocks of ``ROWS`` rows of ``xs`` (each a tensor
    or ``None``) under activation checkpointing, the results concatenated:
    a row-wise computation whose wide intermediates ([rows, 4d] f32 at a
    million rows) are never alive for all rows at once."""
    n = next(x for x in xs if x is not None).shape[0]
    if n <= ROWS:
        return fn(*xs)
    return torch.cat([
        checkpoint(fn, *[None if x is None else x[i:i + ROWS] for x in xs],
                   use_reentrant=False)
        for i in range(0, n, ROWS)])


def block(p, pre, g: Graphs, precision) -> Graphs:
    nf, ef, gf = g.nf, g.ef, g.gf
    s_ = None if nf is None else nf[g.senders]
    r_ = None if nf is None else nf[g.receivers]
    ge = None if gf is None else gf[g.edge_graph]
    h_ef = by_rows(lambda *t: linear(p, pre + "edgefn", _cat(t), precision),
                   ef, s_, r_, ge)
    agg = store(_segment_sum(h_ef, g.receivers, g.n_node), precision)
    node_in = [agg, nf, None if gf is None else gf[g.node_graph]]
    h_nf = linear(p, pre + "nodefn", _cat(node_in), precision)
    graph_in = [store(_segment_sum(h_ef, g.edge_graph, g.n_graph),
                      precision),
                store(_segment_sum(h_nf, g.node_graph, g.n_graph),
                      precision), gf]
    h_gf = linear(p, pre + "graphfn", _cat(graph_in), precision)
    return g.with_features(_absent_if_empty(h_nf), _absent_if_empty(h_ef),
                           _absent_if_empty(h_gf))


def _ffn(p, name, x, precision):
    h = torch.relu(linear(p, name + ".0", x, precision))
    return linear(p, name + ".1", h, precision)


_SETS = (("ef", "edgeln", "eff"), ("nf", "nodeln", "nff"),
         ("gf", "graphln", "gff"))


def core(p, pre, g: Graphs, precision) -> Graphs:
    ln = {s: store(layer_norm(getattr(g, s), p[pre + "gn1." + n + ".scale"],
                              p[pre + "gn1." + n + ".bias"]), precision)
          for s, n, _ in _SETS}
    b1 = block(p, pre + "block.", g.with_features(ln["nf"], ln["ef"],
                                                  ln["gf"]), precision)
    out = {}
    for s, n, f in _SETS:
        x = getattr(g, s)
        x2 = store(layer_norm(x, p[pre + "gn2." + n + ".scale"],
                              p[pre + "gn2." + n + ".bias"]), precision)
        out[s] = store(x + getattr(b1, s) + by_rows(
            lambda t, f=f: _ffn(p, pre + "ffwd." + f, t, precision), x2),
            precision)
    return g.with_features(out["nf"], out["ef"], out["gf"])


def _core_on_tensors(p, pre, g, precision, nf, ef, gf):
    out = core(p, pre, g.with_features(nf, ef, gf), precision)
    return out.nf, out.ef, out.gf


def forward(p: Dict[str, torch.Tensor], g: Graphs, model: dict,
            precision: str = "f32") -> Graphs:
    """The model on ``g``: an encoder block when ``model`` has ``x_dims``,
    ``n_cores`` cores, a decoder block when it has ``y_dims``.  Each core
    runs under activation checkpointing, so one core's activations are
    alive at a time (the large graph's f32 activations would not fit
    otherwise)."""
    epd = "x_dims" in model
    if epd:
        g = block(p, "encoder.", g, precision)
    # The checkpointed function holds the structure only: a closure over a
    # tensor of the graph it is part of would keep that graph alive.
    bare = g.with_features(None, None, None)
    for i in range(model["n_cores"]):
        pre = f"core.{i}." if epd else f"{i}."
        nf, ef, gf = checkpoint(
            lambda nf, ef, gf, pre=pre: _core_on_tensors(
                p, pre, bare, precision, nf, ef, gf),
            g.nf, g.ef, g.gf, use_reentrant=False)
        g = g.with_features(nf, ef, gf)
    if epd:
        g = block(p, "decoder.", g, precision)
    return g


def cross_entropy(logits, targets, rows=None):
    """Mean over rows of ``-sum(targets * log_softmax(logits))``; ``rows``
    (a boolean mask) keeps a subset."""
    per_row = -(targets * torch.log_softmax(logits, -1)).sum(-1)
    if rows is not None:
        per_row = per_row[rows]
    return per_row.mean()


def loss_scale(pred: Graphs, target: Graphs) -> float:
    """The mean magnitude of the loss's per-row terms, nodes plus edges:
    the scale of its rounding, where the loss itself (a mean of terms of
    both signs against soft targets) can come near 0."""
    with torch.no_grad():
        return sum(float((-(t * torch.log_softmax(x, -1)).sum(-1)).abs()
                         .mean()) for x, t in ((pred.nf, target.nf),
                                               (pred.ef, target.ef)))


def loss(pred: Graphs, target: Graphs, keep=None) -> torch.Tensor:
    """Node plus edge cross-entropy; ``keep = (node_rows, edge_rows)``
    restricts both means (a fault planted for the checks)."""
    nk, ek = keep if keep is not None else (None, None)
    return (cross_entropy(pred.nf, target.nf, nk)
            + cross_entropy(pred.ef, target.ef, ek))


def half_batch(x: Graphs):
    """A planted fault: the loss's mean over half the batch (the rows of
    the first half of the graphs, or of the first half of the rows of one
    graph), as ``keep`` for :func:`train`."""
    if x.n_graph > 1:
        h = x.n_graph // 2
        return x.node_graph < h, x.edge_graph < h
    dev = x.senders.device
    return (torch.arange(x.n_node, device=dev) < x.n_node // 2,
            torch.arange(x.senders.numel(), device=dev)
            < x.senders.numel() // 2)


def train(params: Dict[str, torch.Tensor], batches: Sequence, model: dict,
          lr: float, precision: str = "f32", keep=None) -> Readings:
    """AdamW steps from ``params`` (left untouched), one per ``(x, y)`` of
    ``batches``; the loss of each step, the norms of the first step's
    gradients and of each parameter's change after the last step."""
    def step_loss(p, x, y, keep_t):
        out = forward(p, x, model, precision)
        return loss(out, y, keep_t), loss_scale(out, y)
    return training.train(params, batches, step_loss, lr, keep)
