"""Data parallelism over a device mesh (counterpart of
``graphnets_tpu/parallel/data_parallel.py``).

Each rank owns a *shard* of whole graphs, built as its own batch with the
same static pad sizes as every other shard.  :func:`stack_shards` stacks
shards on a new leading axis (the JAX layout) and :func:`shard_batch`
takes this rank's shard of such a stack, by its coordinate on the mesh's
``data`` axis.  Where JAX's ``jit`` lets GSPMD insert the gradient
``psum``, :func:`make_dp_train_step` runs this rank's forward and backward
on its shard and all-reduces the gradients over the ``data`` group, in one
flat buffer: one collective a step, called at every world size.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call

from ..graph import GraphsTuple
from ..training.losses import graph_loss_nf_ef
from ..utils.tree import map_tensors
from . import _comm
from .mesh import sharded_leading
from .tensor_parallel import gathered_params

__all__ = ["stack_shards", "shard_batch", "make_dp_train_step",
           "dp_batch_sharding", "shard_generator"]


def stack_shards(shards: Sequence[GraphsTuple]) -> GraphsTuple:
    """Stack per-rank ``GraphsTuple``s (identical pad sizes) on a new
    leading axis.  Node and edge indices stay local to each shard; the
    host metadata (``slot_shape``, ...) must agree."""
    assert len({(g.num_node_slots, g.num_edge_slots, g.num_graph_slots)
                for g in shards}) == 1, "shards must share pad sizes"
    kw = {}
    for f in dataclasses.fields(shards[0]):
        vals = [getattr(g, f.name) for g in shards]
        if all(isinstance(v, torch.Tensor) for v in vals):
            kw[f.name] = torch.stack(vals)
        elif any(isinstance(v, torch.Tensor) for v in vals) or any(
                v != vals[0] for v in vals):
            raise ValueError(f"stack_shards: the shards' {f.name} differ")
    return dataclasses.replace(shards[0], **kw)


def dp_batch_sharding(mesh: DeviceMesh, axis: str = "data"
                      ) -> Callable[[torch.Tensor], tuple]:
    """The placements of a stacked batch's tensors: the leading (shard)
    axis over ``axis``."""
    return lambda x: sharded_leading(mesh, axis)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(g: GraphsTuple, mesh: DeviceMesh, axis: str = "data"
                ) -> GraphsTuple:
    """This rank's shard of a stacked batch: index ``i`` of the leading
    axis, ``i`` the rank's coordinate on ``axis``, on the mesh's device."""
    i, device = mesh.get_local_rank(axis), _mesh_device(mesh)
    return map_tensors(lambda t: t[i].to(device), g)


def shard_generator(generator: torch.Generator, index: int
                    ) -> torch.Generator:
    """Shard ``index``'s dropout generator, the counterpart of
    ``fold_in(step_rng, index)``: a generator on ``generator``'s device
    seeded ``SeedSequence([generator.initial_seed(), index])``'s first
    32-bit word."""
    seed = int(np.random.SeedSequence(
        [generator.initial_seed(), index]).generate_state(1)[0])
    return torch.Generator(device=generator.device).manual_seed(seed)


def make_dp_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh: DeviceMesh,
    loss_fn: Callable = graph_loss_nf_ef,
    axis: str = "data",
    training: bool = True,
    param_shardings=None,
    compute_dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
) -> Callable[[GraphsTuple, GraphsTuple], Dict[str, torch.Tensor]]:
    """Build ``step(x, y) -> {"loss"}`` for this rank's shard ``x, y``
    (:func:`shard_batch`): the loss of ``model`` on it, its backward, the
    gradients all-reduced over the ``axis`` group, one ``optimizer`` step.

    The loss is the mean over shards: each rank's gradients and loss go
    into one flat buffer, which is summed over the ``axis`` group and
    divided by its size (at world size 1 too), and the returned loss is
    that mean.  ``compute_dtype`` casts the (f32 master) parameters for
    the forward, as ``make_train_step`` does.  With ``param_shardings``
    (``True``; the model passed through ``tensor_parallel.shard_params``,
    and the optimizer built on its shards) each sharded weight is gathered
    whole for the forward and its gradient reduce-scattered over the
    ``model`` axis before the ``axis`` all-reduce.

    Dropout: shard ``i`` (the rank's coordinate on ``axis``) draws from
    ``shard_generator(generator, i)``, made once and advanced step by
    step.  Contract: the step equals one process that runs the same shards
    in turn, shard ``i`` with that generator, and averages their losses
    (the counterpart of JAX's ``fold_in(step_rng, i)``).

    The buffer lives as long as the step, so the step captures as a CUDA
    graph (``capture_step``) with the collective inside; every parameter
    has one dtype."""
    group = mesh.get_group(axis)
    dp = mesh.size(mesh.mesh_dim_names.index(axis))
    if param_shardings and not hasattr(model, "tensor_parallel"):
        raise ValueError("make_dp_train_step: param_shardings needs a model "
                         "sharded by tensor_parallel.shard_params")
    sharded = bool(param_shardings)
    params = dict(model.named_parameters())
    plist = list(params.values())
    dtypes = {p.dtype for p in plist}
    if len(dtypes) != 1:
        raise TypeError(f"make_dp_train_step: parameters of one dtype, got "
                        f"{dtypes}")
    sizes = [p.numel() for p in plist]
    flat = torch.empty(sum(sizes) + 1, dtype=plist[0].dtype,
                       device=plist[0].device)
    views = [v.view_as(p) for v, p in zip(flat[:-1].split(sizes), plist)]
    shard_gen = (None if generator is None
                 else shard_generator(generator, mesh.get_local_rank(axis)))

    def step(x: GraphsTuple, y: GraphsTuple) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        run = gathered_params(model, params) if sharded else params
        if compute_dtype is not None:
            run = {n: p.to(compute_dtype) for n, p in run.items()}
        pred = functional_call(model, run, (x,), {"training": training,
                                                  "generator": shard_gen})
        loss = loss_fn(pred, y)
        loss.backward()
        grads = []
        for p in plist:
            if p.grad is None:     # as in make_train_step
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        torch.cat([g.reshape(-1) for g in grads]
                  + [loss.detach().reshape(1).to(flat.dtype)], out=flat)
        _comm.all_reduce_(flat, group)
        flat.div_(dp)
        torch._foreach_copy_(grads, views)
        optimizer.step()
        return {"loss": flat[-1].clone()}

    # What capture_step restores after its warm-up calls.
    step.model, step.optimizer = model, optimizer
    step.generators = () if shard_gen is None else (shard_gen,)
    return step
