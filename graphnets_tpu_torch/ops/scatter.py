"""Gather / segment-aggregation primitives of the PyTorch port (forward
semantics of ``graphnets_tpu/ops/scatter.py``).

All aggregations accumulate in float32 and mask padded slots, so padding
never contaminates real slots.  For at most 64 segments over at least four
rows a segment (the graph pools, a small batch's node sums) the sum is a
one-hot float32 product, as the JAX package's one-hot matmul at
``Precision.HIGHEST`` (``scatter.py:240-254``): a fixed summation order,
so such steps repeat bit for bit on the card, where an ``index_add_``'s
float atomics do not.  The product and its backward run in IEEE float32
whatever the global TF32 switch says (``torch.backends.cuda.matmul``), as
JAX pins ``HIGHEST``.  With kernels on, a ``sorted_pad_safe`` sum over more than
64 segments (the edge->node sum, and the graph pools of a batch with more
than 64 graph slots) takes the sorted segment-sum kernel instead
(``ops/kernels/segment_sum``), as the JAX package does
(``scatter.py:227-232``).

:func:`take_rows_sorted_grad` is a row gather whose backward scatter-add
runs as such a sorted f32 sum (``scatter.py:91-190``): directly for
ascending ids, through the windowed kernel for ids local to their graph
(the senders), after one stable sort otherwise.  Where the windowed
kernel's gate refuses the shape with kernels on, a bf16 senders' sum runs
as the JAX package's fallback does: in bf16, rows in edge order
(``segment_sum.edge_order_segment_sum``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..utils.config import debug_checks, get_config, use_kernels

__all__ = [
    "gather_nodes",
    "gather_nodes_grad",
    "take_rows_sorted_grad",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "aggregate_edges_for_nodes",
    "aggregate_edges_for_globals",
    "aggregate_nodes_for_globals",
    "broadcast_globals_to_edges",
    "broadcast_globals_to_nodes",
]


def _mask_rows(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask[:, None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


@contextlib.contextmanager
def _ieee_f32_matmul():
    """cuBLAS float32 products without TF32 inside the block, the caller's
    switch restored after it."""
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    if prev == "ieee":
        yield
        return
    m.fp32_precision = "ieee"
    try:
        yield
    finally:
        m.fp32_precision = prev


class _OneHotSum(torch.autograd.Function):
    """``onehot.T @ x`` for a float 0/1 ``onehot``; forward and backward
    products in IEEE float32, so every term is exact and only the sum
    rounds."""

    @staticmethod
    def forward(ctx, onehot, x):
        ctx.save_for_backward(onehot)
        with _ieee_f32_matmul():
            return onehot.t() @ x

    @staticmethod
    def backward(ctx, grad):
        onehot, = ctx.saved_tensors
        with _ieee_f32_matmul():
            return None, onehot @ grad


class _TakeRows(torch.autograd.Function):
    """``x[idx]``; the backward is a sorted f32 segment sum."""

    @staticmethod
    def forward(ctx, x, idx, idx_sorted):
        ctx.save_for_backward(idx)
        ctx.meta = (x.shape[0], idx_sorted)
        if idx_sorted and use_kernels():
            # Ascending ids: the sorted-gather kernel where the JAX
            # package's kernel takes the shape.
            from .kernels import gather
            if gather.supports_sorted_gather(idx.shape[0], x.shape[0],
                                             x.shape[1], x.element_size()):
                return gather.sorted_gather(x, idx)
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n, idx_sorted = ctx.meta
        return _take_rows_grad(g, idx, n, idx_sorted), None, None


def _take_rows_grad(g: torch.Tensor, idx: torch.Tensor, n: int,
                    idx_sorted: bool) -> torch.Tensor:
    """The pullback of ``x[idx]`` onto ``x``'s ``n`` rows: a sorted f32
    segment sum, in ``g``'s type."""
    g = g.contiguous()
    if not idx_sorted:
        # One stable sort gives the segment ids and the permutation.
        seg, perm = torch.sort(idx, stable=True)
        g, idx = g.index_select(0, perm), seg
    return segment_sum(g, idx, n, sorted_pad_safe=True).to(g.dtype)


class _TakeRowsWindowed(torch.autograd.Function):
    """``x[idx]`` for ids unsorted within each graph but local to it; the
    backward is the windowed segment sum (no sort, no permutation)."""

    @staticmethod
    def forward(ctx, x, idx, node_offsets, edge_offsets):
        ctx.save_for_backward(idx, node_offsets, edge_offsets)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        from .kernels import segment_sum as kss
        idx, node_offsets, edge_offsets = ctx.saved_tensors
        n = ctx.num_rows
        g = g.contiguous()
        if use_kernels() and kss.supports_sorted_segment_sum(
                g.shape[0], n, g.shape[1]):
            dx = kss.windowed_segment_sum(g, idx, n, node_offsets,
                                          edge_offsets)
        elif use_kernels() and g.dtype == torch.bfloat16:
            # The JAX package's kernel route on a shape its kernel refuses
            # (``segment_sum.py:270-271``): a sum in bf16, rows in edge
            # order, as ``jax.ops.segment_sum`` sums on JAX's CPU backend.
            # (On f32 rows that sum and this f32 one differ only in their
            # order.)
            dx = kss.edge_order_segment_sum(g, idx, n)
        else:
            dx = segment_sum(g, idx, n)
        return dx.to(g.dtype), None, None, None


def take_rows_sorted_grad(x: torch.Tensor, idx: torch.Tensor,
                          idx_sorted: bool = False,
                          windows=None) -> torch.Tensor:
    """``x[idx]`` whose backward scatter-add runs sorted, in f32.

    ``idx_sorted=True`` declares the ids ascending (the canonical
    receivers, ``edge_graph``, ``node_graph``): no sort in the backward,
    and the forward takes the sorted-gather kernel where its gate holds.
    ``windows=(node_offsets, edge_offsets)`` (``[G + 1]`` int32 each)
    declares ids unsorted within graphs but local to them (the senders):
    the backward takes the windowed kernel.  Otherwise the backward sorts
    the ids once.  Only the order of the f32 sums differs between the
    three."""
    if windows is not None and not idx_sorted:
        return _TakeRowsWindowed.apply(x, idx, windows[0], windows[1])
    return _TakeRows.apply(x, idx, idx_sorted)


def gather_nodes(nf: torch.Tensor, idx: torch.Tensor,
                 idx_sorted: bool = False, windows=None) -> torch.Tensor:
    """``nf[idx]``: node rows gathered onto edge slots; the backward runs
    sorted (see :func:`take_rows_sorted_grad`)."""
    if get_config().sorted_scatter_grad:
        return take_rows_sorted_grad(nf, idx, idx_sorted, windows)
    return nf.index_select(0, idx)


def gather_nodes_grad(g: torch.Tensor, idx: torch.Tensor, num_rows: int,
                      idx_sorted: bool = False) -> torch.Tensor:
    """The gradient of :func:`gather_nodes` ``(nf, idx, idx_sorted)`` with
    respect to ``nf`` (``num_rows`` rows) for the cotangent ``g``, in its
    type, as that function's own backward takes it."""
    if get_config().sorted_scatter_grad:
        return _take_rows_grad(g, idx, num_rows, idx_sorted)
    return g.new_zeros((num_rows,) + tuple(g.shape[1:])).index_add_(0, idx,
                                                                     g)


def segment_sum(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                sorted_pad_safe: bool = False) -> torch.Tensor:
    """Masked segment sum with float32 accumulation, cast back to
    ``x.dtype``.

    ``sorted_pad_safe`` declares the batch layout's contract: ids ascend
    and padded rows target only segments no real row targets, so the mask
    is redundant.  With kernels on and more than 64 segments such a sum
    takes the sorted segment-sum kernel, which skips the mask.  Under
    ``GRAPHNETS_TPU_TORCH_DEBUG=1`` the contract is enforced (a host check
    that raises on a violation)."""
    if sorted_pad_safe and debug_checks():
        from ..utils.debug import check_sorted_pad_safe
        check_sorted_pad_safe(segment_ids, mask)
    if sorted_pad_safe and use_kernels() and num_segments > 64:
        from .kernels.segment_sum import (sorted_segment_sum,
                                          supports_sorted_segment_sum)
        if supports_sorted_segment_sum(x.shape[0], num_segments,
                                       x.shape[-1]):
            return sorted_segment_sum(x, segment_ids, num_segments)
    if num_segments == 1:
        # A single graph's pools: a column sum (an ``index_add_`` of a
        # million rows into one would serialise on its atomics).
        return _mask_rows(x, mask).sum(0, keepdim=True,
                                       dtype=torch.float32).to(x.dtype)
    if num_segments <= 64 and x.shape[0] >= 4 * num_segments:
        # Few segments: the mask folded into a one-hot, an f32 product of
        # exact terms in a fixed order (rows with an id out of range drop
        # out, as in JAX's product).
        onehot = segment_ids[:, None] == torch.arange(
            num_segments, dtype=segment_ids.dtype, device=x.device)
        if mask is not None:
            onehot = onehot & mask[:, None]
        flat = x.reshape(x.shape[0], -1).float()
        out = _OneHotSum.apply(onehot.float(), flat)
        return out.reshape((num_segments,) + tuple(x.shape[1:])).to(x.dtype)
    acc = torch.zeros((num_segments,) + tuple(x.shape[1:]),
                      dtype=torch.float32, device=x.device)
    acc.index_add_(0, segment_ids, _mask_rows(x, mask).float())
    return acc.to(x.dtype)


def segment_mean(x: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: Optional[torch.Tensor] = None,
                 indices_are_sorted: bool = True) -> torch.Tensor:
    """Masked mean per segment: :func:`segment_sum` (rounded to
    ``x.dtype``) divided, in ``x.dtype``, by the count of real rows, at
    least 1 (``scatter.py:259-268``).  ``indices_are_sorted`` is JAX's
    hint; the port needs none."""
    s = segment_sum(x, segment_ids, num_segments, mask)
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    if mask is not None:
        ones = torch.where(mask, ones, 0.0)
    counts = torch.zeros(num_segments, dtype=torch.float32,
                         device=x.device).index_add_(0, segment_ids, ones)
    return s / counts.clamp(min=1.0)[:, None].to(s.dtype)


def segment_max(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                indices_are_sorted: bool = True) -> torch.Tensor:
    """Masked maximum per segment (``scatter.py:271-280``): masked rows
    are filled with the dtype's lowest finite value, and an empty or fully
    masked segment is reported as 0."""
    neg = torch.finfo(x.dtype).min
    if mask is not None:
        x = torch.where(mask[:, None], x, torch.full((), neg, dtype=x.dtype,
                                                     device=x.device))
    out = torch.full((num_segments,) + tuple(x.shape[1:]), neg,
                     dtype=x.dtype, device=x.device)
    idx = segment_ids.long().view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    out = out.scatter_reduce(0, idx, x, "amax", include_self=True)
    return torch.where(out <= neg, torch.zeros((), dtype=x.dtype,
                                               device=x.device), out)


def aggregate_edges_for_nodes(ef: torch.Tensor, receivers: torch.Tensor,
                              num_nodes: int,
                              edge_mask: Optional[torch.Tensor]
                              ) -> torch.Tensor:
    """Sum of incoming-edge features per destination node (receivers
    ascend and padded edges target padding nodes)."""
    return segment_sum(ef, receivers, num_nodes, edge_mask,
                       sorted_pad_safe=True)


def aggregate_edges_for_globals(ef: torch.Tensor, edge_graph: torch.Tensor,
                                num_graphs: int,
                                edge_mask: Optional[torch.Tensor],
                                mask_aliases_real: bool = False
                                ) -> torch.Tensor:
    """Sum-pool over real edges per graph (``edge_graph`` ascends).

    ``mask_aliases_real`` (``GraphsTuple.pad_aliases_real``): the uniform
    slot layout gives padded edges their slot's graph id, so the mask
    matters; the padded rows are zeroed before the sorted sum, after which
    sharing a segment with them is harmless (``scatter.py:297-312`` of the
    JAX package)."""
    if mask_aliases_real and edge_mask is not None:
        ef, edge_mask = _mask_rows(ef, edge_mask), None
    return segment_sum(ef, edge_graph, num_graphs, edge_mask,
                       sorted_pad_safe=True)


def aggregate_nodes_for_globals(nf: torch.Tensor, node_graph: torch.Tensor,
                                num_graphs: int,
                                node_mask: Optional[torch.Tensor],
                                mask_aliases_real: bool = False
                                ) -> torch.Tensor:
    """Sum-pool over real nodes per graph; ``mask_aliases_real`` as in
    :func:`aggregate_edges_for_globals`."""
    if mask_aliases_real and node_mask is not None:
        nf, node_mask = _mask_rows(nf, node_mask), None
    return segment_sum(nf, node_graph, num_graphs, node_mask,
                       sorted_pad_safe=True)


def broadcast_globals_to_edges(gf: torch.Tensor,
                               edge_graph: torch.Tensor) -> torch.Tensor:
    """Graph features tiled onto edge slots (``edge_graph`` ascends)."""
    if get_config().sorted_scatter_grad:
        return take_rows_sorted_grad(gf, edge_graph, idx_sorted=True)
    return gf.index_select(0, edge_graph)


def broadcast_globals_to_nodes(gf: torch.Tensor,
                               node_graph: torch.Tensor) -> torch.Tensor:
    """Graph features tiled onto node slots (``node_graph`` ascends)."""
    if get_config().sorted_scatter_grad:
        return take_rows_sorted_grad(gf, node_graph, idx_sorted=True)
    return gf.index_select(0, node_graph)
