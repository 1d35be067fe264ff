"""Tensor parallelism: large ``Linear`` weights sharded over a ``model``
mesh axis (counterpart of ``graphnets_tpu/parallel/tensor_parallel.py``).

:func:`param_shardings` is the JAX package's rule letter for letter on the
port's ``[din, dout]`` weights (the same layout as JAX's): a 2-D weight of
at least ``min_size`` elements shards its larger matmul dim when that dim
divides, column-parallel (``Shard(1)``) when ``dout >= din``, else
row-parallel (``Shard(0)``); everything else is replicated.
:func:`shard_params` leaves each rank holding only its shard of each
sharded weight, so an optimizer built afterwards keeps only that shard's
moments.

The compute differs from GSPMD's: a sharded weight is gathered whole at
use (:func:`gathered_params`) and its gradient reduce-scattered in the
``model`` group, so every kernel gets the whole weight it takes in one
process (``GNBlock`` slices the edge weight into its ``ef`` / sender /
receiver / global blocks, which a row shard would cut across).  Every rank
of a ``model`` group computes the same loss, so the reduce-scatter is
divided by the group's size: the gradient of one loss, not of their sum.
Megatron's split of the FFN pair's activations (the JAX docstring's
column- then row-parallel matmuls with one reduce) is not done here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

from ..params import shard_of
from . import _comm

__all__ = ["param_shardings", "shard_params", "gathered_params",
           "TensorParallel"]


def param_shardings(model: nn.Module, mesh: DeviceMesh, axis: str = "model",
                    min_size: int = 1 << 14) -> Dict[str, Placement]:
    """The placement of every parameter of ``model`` on mesh axis
    ``axis``, by name (JAX's ``param_shardings``)."""
    tp = mesh.size(mesh.mesh_dim_names.index(axis))

    def rule(x: torch.Tensor) -> Placement:
        if x.dim() == 2 and x.numel() >= min_size:
            din, dout = x.shape
            if dout >= din and dout % tp == 0:
                return Shard(1)
            if din % tp == 0:
                return Shard(0)
        return Replicate()

    return {n: rule(p) for n, p in model.named_parameters()}


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What :func:`shard_params` did to a model: the sharded dim of each
    sharded parameter, the ``model`` group and its size."""
    dims: Mapping[str, int]
    group: object
    size: int


def shard_params(model: nn.Module, mesh: DeviceMesh, axis: str = "model",
                 min_size: int = 1 << 14) -> nn.Module:
    """Replace each parameter that :func:`param_shardings` shards by this
    rank's shard of it (``params.shard_of``), in place, and record the
    layout as ``model.tensor_parallel``.  Returns ``model``.  A sharded
    model runs through :func:`gathered_params` (``make_dp_train_step`` with
    ``param_shardings``); its modules alone see only the shards."""
    placements = param_shardings(model, mesh, axis, min_size)
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    rank = mesh.get_local_rank(axis)
    dims = {}
    for name, placement in placements.items():
        if not isinstance(placement, Shard):
            continue
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        full = getattr(owner, leaf)
        owner.register_parameter(leaf, nn.Parameter(
            shard_of(full.detach(), placement, rank, size).clone()))
        dims[name] = placement.dim
    model.tensor_parallel = TensorParallel(dims, mesh.get_group(axis), size)
    return model


class _GatherWeight(torch.autograd.Function):
    """The whole weight from the ``model`` group's shards; its backward is
    the reduce-scatter of the gradient, divided by the group's size (every
    rank of the group computed the same loss)."""

    @staticmethod
    def forward(ctx, shard, dim, tp: TensorParallel):
        ctx.dim, ctx.tp = dim, tp
        return _comm.all_gather(shard, dim, tp.group)

    @staticmethod
    def backward(ctx, g):
        return (_comm.reduce_scatter(g, ctx.dim, ctx.tp.group)
                / ctx.tp.size, None, None)


def gathered_params(model: nn.Module, params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """``params`` with each sharded weight of ``model`` gathered whole
    (differentiably); the others as they are."""
    tp: TensorParallel = model.tensor_parallel
    return {n: _GatherWeight.apply(p, tp.dims[n], tp) if n in tp.dims else p
            for n, p in params.items()}
