"""The collectives the parallel modules use, on one process group each.

NCCL takes CUDA tensors and gloo CPU ones; gloo refuses most collectives
and ``send`` / ``recv`` of CUDA tensors.  Where a group's backend is gloo
and the tensor lies on the card (two ranks sharing one card, which NCCL
refuses), each call copies the tensor to the host, runs the collective
there and copies the result back, and counts the call in
``HOST_STAGED``, so a caller can say that it ran so.  Nothing else
changes device or backend.  ``COLLECTIVES`` counts every call, so a
caller can show which collectives a path ran.

:func:`psum`, :func:`all_gather_grad` and :func:`all_to_all_grad` are the
three collectives the edge-partitioned blocks differentiate through.  A
value the ranks hold alike (a parameter, a graph update computed from
summed pools) carries a *partial* cotangent on each rank, whose sum over
the ranks is the gradient; a value each rank holds its own (a shard's
rows) carries its whole cotangent.  So the backward of ``psum`` (shards
in, the same sum out) is an all-reduce of the partials, that of the
all-gather a reduce-scatter, and that of the all-to-all, which is its
own inverse, the same all-to-all.  Over a group of one rank each is the
identity and runs nothing, as JAX's collective over an axis of size 1.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

COLLECTIVES = 0     # calls of the functions below
HOST_STAGED = 0     # of those, the ones staged through the host (gloo)


def _host(t: torch.Tensor, group) -> bool:
    global COLLECTIVES, HOST_STAGED
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    COLLECTIVES += 1
    HOST_STAGED += staged
    return staged


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place."""
    if _host(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` written into ``t`` on every rank of
    ``group``."""
    if _host(t, group):
        h = t.cpu()
        dist.broadcast(h, src=src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim``, in group
    rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if _host(t, group):
        src = src.cpu()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``t`` over
    ``group``."""
    n = dist.get_world_size(group)
    host = _host(t, group)
    parts = [c.contiguous() for c in torch.chunk(t.cpu() if host else t,
                                                 n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(t.device)


def send(t: torch.Tensor, dst: int, group) -> None:
    """Send ``t`` to global rank ``dst``."""
    dist.send(t.cpu() if _host(t, group) else t.contiguous(), dst=dst,
              group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor shaped as ``like`` received from global rank ``src``."""
    if _host(like, group):
        h = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(h, src=src, group=group)
        return h.to(like.device)
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    dist.recv(out, src=src, group=group)
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t [S, ...]`` split on dim 0 over the group's S ranks: row ``s`` of
    the result is row ``r`` of rank ``s``'s ``t``, ``r`` this rank (JAX's
    ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``)."""
    src = t.contiguous()
    if _host(t, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def group_size(group) -> int:
    """The number of ranks of ``group``; 1 for ``None`` (one process)."""
    return 1 if group is None else dist.get_world_size(group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor); its backward is the
    all-reduce of the cotangents."""
    return t if group_size(group) == 1 else _Psum.apply(t, group)


def all_gather_grad(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`all_gather` with a gradient: its backward is the
    reduce-scatter (sum) of the cotangent."""
    return t if group_size(group) == 1 else _AllGather.apply(t, dim, group)


def all_to_all_grad(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all` with a gradient: its backward is the same
    all-to-all of the cotangent."""
    return t if group_size(group) == 1 else _AllToAll.apply(t, group)
