"""Sorted row gather (counterpart of ``graphnets_tpu/ops/pallas/gather.py``).

    out[e] = table[idx[e]]    (zeros where idx[e] is outside [0, N))

Kernel: ``csrc/gather.cu``.  It replaces the Pallas kernel of
``sorted_gather`` (``gather.py:121-251,321-338``).  On the H100 it is a
copy bound by memory (~13.4 MB at 16384 rows of 384 bf16, ~4 us): each
thread moves 16 bytes, with no arithmetic, so the output is bit-equal to
the table rows.  Out-of-range ids read zeros, the Pallas kernel's contract
(``gather.py:325-329``), not ``index_select``'s error.

:func:`sorted_gather` is differentiable; its backward is
``sorted_segment_sum`` (``gather.py:263-267``).  It takes
:func:`sorted_gather_plain` for CPU tensors only; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["sorted_gather", "sorted_gather_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches, for proving the path was taken


def sorted_gather_plain(table: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` in plain torch, with zeros for out-of-range ids."""
    n = table.shape[0]
    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    rows = table.index_select(0, idx.clamp(0, max(n - 1, 0)))
    return torch.where(valid.view(-1, *([1] * (table.dim() - 1))), rows,
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    if lib.gn_sorted_gather.argtypes is None:
        lib.gn_sorted_gather.argtypes = \
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gn_sorted_gather.restype = ctypes.c_int
    return lib


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"sorted_gather: table must be [N, d] and idx [E], "
                         f"got {tuple(table.shape)} and {tuple(idx.shape)}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16:
        raise ValueError(f"sorted_gather: rows of {row_bytes} bytes; the "
                         "kernel copies 16-byte pieces")
    if idx.dtype != torch.int32:
        raise TypeError("sorted_gather: idx must be int32")
    for t in (table, idx):
        if not t.is_cuda or t.device != table.device:
            raise ValueError(f"sorted_gather: inputs must be on "
                             f"{table.device}")
        if not t.is_contiguous():
            raise ValueError("sorted_gather: inputs must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("sorted_gather: table must be 16-byte aligned")
    out = torch.empty(idx.shape[0], table.shape[1], dtype=table.dtype,
                      device=table.device)
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.gn_sorted_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            table.shape[0], row_bytes,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sorted_gather")
    LAUNCHES += 1
    return out


def _gather(table, idx):
    if table.device.type == "cpu":
        return sorted_gather_plain(table, idx)
    return _launch(table, idx)


class _SortedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return _gather(table, idx)

    @staticmethod
    def backward(ctx, g):
        from .segment_sum import sorted_segment_sum
        (idx,) = ctx.saved_tensors
        return sorted_segment_sum(g, idx, ctx.num_rows).to(g.dtype), None


def sorted_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for ascending ``idx`` (the canonical receivers);
    out-of-range ids read zeros.  Differentiable in ``table``."""
    return _SortedGather.apply(table, idx)
