"""The collectives the parallel modules use, on one process group each.

NCCL takes CUDA tensors and gloo CPU ones; gloo refuses most collectives
and ``send`` / ``recv`` of CUDA tensors.  Where a group's backend is gloo
and the tensor lies on the card (two ranks sharing one card, which NCCL
refuses), each call copies the tensor to the host, runs the collective
there and copies the result back, and counts the call in
``HOST_STAGED``, so a caller can say that it ran so.  Nothing else
changes device or backend.  ``COLLECTIVES`` counts every call, so a
caller can show which collectives a path ran.
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
