"""Edge-partitioned stacks and their training step (counterpart of
``graphnets_tpu/parallel/edge_partition_stack.py``).

A whole ``GNCoreList`` or ``EncodeProcessDecode`` runs over an
edge-partitioned graph, every block with the v3 halo
(:func:`..edge_partition.block_local_v3`: one all-to-all and one ``psum``
a block), each rank on its own shard.  LayerNorm, the FFN and the
residual adds are per-row maps, so applying them to a shard's rows gives
the unpartitioned values; only the block's aggregations cross rows.  With
kernels on, the stack takes the unpartitioned ``GNCore``'s kernels: the
pre-block edge LN fused into the edge update, and the second branch with
both residuals in ``ln_ffn_residual``, under the JAX package's training
gates (the row gate on a shard's rows).

Gradients: the parameters are the same on every rank and each rank's
gradient is a partial, summed over the axis (``_comm``'s convention: the
replicated loss seeds its cotangent on coordinate 0 of the axis alone, the
collectives' backwards carry the rest), so the step equals the
unpartitioned ``make_train_step``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call

from ..models.encode_process_decode import EncodeProcessDecode
from ..models.gn_core import GNCore
from ..ops.kernels.fused_ffn import (ln_ffn_residual,
                                     ln_ffn_residual_reference,
                                     supports_fused_ffn)
from ..utils.config import use_kernels
from . import _comm
from .edge_partition import (HaloPlan, PartitionedGraph, _local, axis_group,
                             block_local_v3)

__all__ = [
    "gn_core_partitioned",
    "gn_core_list_partitioned",
    "encode_process_decode_partitioned",
    "partitioned_loss_nf_ef",
    "make_partitioned_train_step",
    "make_partitioned_core_list_train_step",
]


def _core_local(core: GNCore, send_idx, sender_pos, rl, em, nm, nf, ef, gf,
                group, training: bool = False):
    """One shard's GNCore body, ``y = x + Block(LN1(x)) + FF(LN2(x))``:
    the block exchanges halos, the rest is per row.  The FFN branch runs
    without dropout, as the JAX package's."""
    de = core.dims[0]
    gn1, gn2, ffwd = core.gn1, core.gn2, core.ffwd
    kernels = use_kernels()
    if kernels:
        # The edge LN goes into the edge update's matmul.
        b_ef, b_nf, b_gf = block_local_v3(
            core.block, send_idx, sender_pos, rl, em, nm, gn1.nodeln(nf), ef,
            gn1.graphln(gf), group,
            ef_ln={"scale": gn1.edgeln.scale, "bias": gn1.edgeln.bias},
            training=training)
    else:
        b_ef, b_nf, b_gf = block_local_v3(
            core.block, send_idx, sender_pos, rl, em, nm, gn1.nodeln(nf),
            gn1.edgeln(ef), gn1.graphln(gf), group, training=training)

    if (kernels and (core.dropout == 0 or not training)
            and (not training or de <= GNCore._FUSED_FFN_TRAIN_MAX_DIM)):
        def one(x, extra, ln, ff):
            fn = ln_ffn_residual
            if ((training and x.shape[0] < GNCore._FUSED_FFN_TRAIN_MIN_ROWS)
                    or not supports_fused_ffn(x.shape[0], x.shape[1],
                                              x.dtype)):
                # The per-set row gate (rows of this shard) and the JAX
                # kernel's own fallback for a set it does not take.
                fn = ln_ffn_residual_reference
            return fn(x, ln.scale, ln.bias, ff[0].w, ff[0].b, ff[1].w,
                      ff[1].b, extra=extra)

        return (one(ef, b_ef, gn2.edgeln, ffwd.eff),
                one(nf, b_nf, gn2.nodeln, ffwd.nff),
                one(gf, b_gf, gn2.graphln, ffwd.gff))
    f_ef = ffwd.eff(gn2.edgeln(ef))
    f_nf = ffwd.nff(gn2.nodeln(nf))
    f_gf = ffwd.gff(gn2.graphln(gf))
    return ef + b_ef + f_ef, nf + b_nf + f_nf, gf + b_gf + f_gf


def _cores_local(cores, send_idx, sender_pos, rl, em, nm, nf, ef, gf, group,
                 training: bool = False):
    for core in cores.children():
        ef, nf, gf = _core_local(core, send_idx, sender_pos, rl, em, nm, nf,
                                 ef, gf, group, training=training)
    return ef, nf, gf


def _epd_local(model: EncodeProcessDecode, send_idx, sender_pos, rl, em,
               nm, nf, ef, gf, group, training: bool = False):
    """One shard's EncodeProcessDecode body, the whole stack."""
    ef, nf, gf = block_local_v3(model.encoder, send_idx, sender_pos, rl, em,
                                nm, nf, ef, gf, group, training=training)
    ef, nf, gf = _cores_local(model.core, send_idx, sender_pos, rl, em, nm,
                              nf, ef, gf, group, training=training)
    return block_local_v3(model.decoder, send_idx, sender_pos, rl, em, nm,
                          nf, ef, gf, group, training=training)


def _run_partitioned(local_fn, module, pg: PartitionedGraph, plan: HaloPlan,
                     mesh: Optional[DeviceMesh], axis: str,
                     out_dims: Tuple[int, int, int], training: bool
                     ) -> PartitionedGraph:
    """A shard body on this rank's slice; returns this rank's slice of the
    outputs (``gf`` the same on every rank)."""
    group = axis_group(mesh, axis)[0]
    lg, lp = _local(pg, mesh, axis), _local(plan, mesh, axis)
    h_ef, h_nf, h_gf = local_fn(
        module, lp.send_idx[0], lp.sender_pos[0], lg.receivers_local[0],
        lg.edge_mask[0], lg.node_mask[0], lg.nf[0],
        None if lg.ef is None else lg.ef[0], lg.gf, group, training=training)
    de_o, _, dg_o = out_dims
    return lg.replace(ef=h_ef[None] if de_o > 0 else None, nf=h_nf[None],
                      gf=h_gf if dg_o > 0 else None)


def gn_core_partitioned(core: GNCore, pg: PartitionedGraph, plan: HaloPlan,
                        mesh: Optional[DeviceMesh] = None,
                        axis: str = "graph") -> PartitionedGraph:
    """One edge-partitioned GNCore; equals the unpartitioned ``GNCore`` on
    real slots."""
    return _run_partitioned(_core_local, core, pg, plan, mesh, axis,
                            core.dims, False)


def gn_core_list_partitioned(cores, pg: PartitionedGraph, plan: HaloPlan,
                             mesh: Optional[DeviceMesh] = None,
                             axis: str = "graph", training: bool = False
                             ) -> PartitionedGraph:
    """A ``GNCoreList`` over an edge-partitioned graph, the partitioned
    counterpart of the headline stack, with :func:`gn_core_partitioned`'s
    kernels."""
    last = list(cores.children())[-1]
    return _run_partitioned(_cores_local, cores, pg, plan, mesh, axis,
                            last.dims, training)


def encode_process_decode_partitioned(
        model: EncodeProcessDecode, pg: PartitionedGraph, plan: HaloPlan,
        mesh: Optional[DeviceMesh] = None, axis: str = "graph",
        training: bool = False) -> PartitionedGraph:
    """A whole EncodeProcessDecode over an edge-partitioned graph."""
    return _run_partitioned(_epd_local, model, pg, plan, mesh, axis,
                            model.y_dims, training)


def _this_shard(t: torch.Tensor, rows: torch.Tensor, mesh, axis: str
                ) -> torch.Tensor:
    """This rank's ``[rows, C]`` slice of ``[S, rows, C]`` targets (or of a
    ``[1, rows, C]`` slice), on ``rows``' device."""
    _, size, coord = axis_group(mesh, axis)
    if t.shape[0] not in (1, size):
        raise ValueError(f"targets of {t.shape[0]} shards on an axis "
                         f"{axis!r} of {size} ranks")
    return t[coord if t.shape[0] == size else 0].to(rows.device)


def _ce_terms(logits, targets, mask):
    """``(sum of the masked per-row cross-entropy, number of real rows)``
    in f32."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    per_row = -(targets.float() * logz).sum(-1)
    m = mask.float()
    return (per_row * m).sum(), m.sum()


def partitioned_loss_nf_ef(pred: PartitionedGraph, y_nf: torch.Tensor,
                           y_ef: torch.Tensor,
                           mesh: Optional[DeviceMesh] = None,
                           axis: str = "graph") -> torch.Tensor:
    """Node CE plus edge CE, each a mean over the real slots of every shard
    (``training.losses.graph_loss_nf_ef`` of the whole graph).  ``pred`` is
    this rank's slice (a partitioned stack's output); ``y_nf [S, Npad, C]``
    / ``y_ef [S, Epad, C]`` are the targets in ``pg``'s layout (or this
    rank's ``[1, ...]`` slice).  The numerators and the counts are summed
    over the axis in one ``psum``; the loss is the same on every rank."""
    nf_sum, nf_cnt = _ce_terms(pred.nf[0], _this_shard(y_nf, pred.nf, mesh,
                                                       axis),
                               pred.node_mask[0])
    ef_sum, ef_cnt = _ce_terms(pred.ef[0], _this_shard(y_ef, pred.ef, mesh,
                                                       axis),
                               pred.edge_mask[0])
    terms = _comm.psum(torch.stack([nf_sum, nf_cnt, ef_sum, ef_cnt]),
                       axis_group(mesh, axis)[0])
    return (terms[0] / terms[1].clamp(min=1.0)
            + terms[2] / terms[3].clamp(min=1.0))


class _Call(nn.Module):
    """``fn(model, ...)`` as a module, so ``functional_call`` can swap the
    model's parameters (the compute-dtype casts) for one call."""

    def __init__(self, fn, model: nn.Module):
        super().__init__()
        self.fn, self.model = fn, model

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def _make_step(fn, model: nn.Module, optimizer: torch.optim.Optimizer,
               plan: HaloPlan, mesh: Optional[DeviceMesh], axis: str,
               loss_fn: Optional[Callable], compute_dtype):
    loss_fn = loss_fn or partitioned_loss_nf_ef
    group, size, coord = axis_group(mesh, axis)
    params = dict(model.named_parameters())
    plist = list(params.values())
    device = plist[0].device
    plan = _local(plan, mesh, axis)
    call = _Call(fn, model)
    # The loss is the same on every rank: its cotangent is seeded on
    # coordinate 0 alone, and the partial gradients are summed.
    seed = torch.tensor(1.0 if coord == 0 else 0.0, device=device)
    flat = None
    if size > 1:
        if len({p.dtype for p in plist}) != 1:
            raise TypeError("make_partitioned_train_step: parameters of one "
                            "dtype")
        sizes = [p.numel() for p in plist]
        flat = torch.empty(sum(sizes), dtype=plist[0].dtype, device=device)
        views = [v.view_as(p) for v, p in zip(flat.split(sizes), plist)]

    def step(pg: PartitionedGraph, y_nf: torch.Tensor, y_ef: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        run = params if compute_dtype is None else {
            n: p.to(compute_dtype) for n, p in params.items()}
        pred = functional_call(call, {f"model.{n}": p for n, p in run.items()},
                               (pg, plan, mesh, axis), {"training": True})
        loss = loss_fn(pred, y_nf, y_ef, mesh, axis)
        loss.backward(seed)
        grads = []
        for p in plist:
            if p.grad is None:     # as in make_train_step
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if flat is not None:
            # One all-reduce a step: the sum of the partial gradients.
            torch.cat([g.reshape(-1) for g in grads], out=flat)
            _comm.all_reduce_(flat, group)
            torch._foreach_copy_(grads, views)
        optimizer.step()
        return {"loss": loss.detach()}

    # What capture_step restores after its warm-up calls.
    step.model, step.optimizer = model, optimizer
    return step


def make_partitioned_train_step(model: EncodeProcessDecode, optimizer,
                                plan: HaloPlan,
                                mesh: Optional[DeviceMesh] = None,
                                axis: str = "graph",
                                loss_fn: Optional[Callable] = None,
                                compute_dtype: Optional[torch.dtype] = None
                                ) -> Callable:
    """``step(pg, y_nf, y_ef) -> {"loss"}`` over an edge-partitioned graph:
    the loss of :func:`encode_process_decode_partitioned` under training
    (``loss_fn(pred, y_nf, y_ef, mesh, axis)``, by default
    :func:`partitioned_loss_nf_ef`), its backward through the collectives,
    the partial gradients summed over the axis in one all-reduce, one
    ``optimizer`` step.  ``compute_dtype`` casts the (f32 master)
    parameters for the forward, as ``make_train_step`` does; ``pg``'s
    features are the caller's.  ``plan`` is sliced and moved once.  The
    step equals the unpartitioned ``make_train_step``, and captures as a
    CUDA graph (``capture_step``) on one rank, where it runs no
    collective."""
    return _make_step(
        lambda m, pg, plan, mesh, axis, training: (
            encode_process_decode_partitioned(m, pg, plan, mesh, axis,
                                              training)),
        model, optimizer, plan, mesh, axis, loss_fn, compute_dtype)


def make_partitioned_core_list_train_step(cores, optimizer, plan: HaloPlan,
                                          mesh: Optional[DeviceMesh] = None,
                                          axis: str = "graph",
                                          loss_fn: Optional[Callable] = None,
                                          compute_dtype: Optional[
                                              torch.dtype] = None
                                          ) -> Callable:
    """:func:`make_partitioned_train_step` for a ``GNCoreList``."""
    return _make_step(
        lambda m, pg, plan, mesh, axis, training: (
            gn_core_list_partitioned(m, pg, plan, mesh, axis, training)),
        cores, optimizer, plan, mesh, axis, loss_fn, compute_dtype)
