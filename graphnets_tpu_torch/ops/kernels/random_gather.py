"""Random row gather (counterpart of
``graphnets_tpu/ops/pallas/random_gather.py``).

    out[e] = table[idx[e]]    for ids in any order, every id in [0, N)

Kernel: ``csrc/random_gather.cu``.  It replaces the Pallas kernel of
``random_gather`` (``random_gather.py:57-119``), which issued one row-sized
DMA per output row.  On the H100 it is a copy bound by memory (~0.58 GB at a
``[65,536, 256]`` bf16 table and 1,048,576 ids, ~0.17 ms); a warp keeps
several independent row reads in flight, 16 bytes a lane.  The ids are not
checked, as in the JAX package's contract: an id outside ``[0, N)`` reads
outside the table.

No model path calls it (in neither package): it is the measurement of the
sender gather of the single-graph edge update against ``index_select``.
:func:`random_gather` is differentiable; its backward sorts the ids once and
takes the sorted segment sum (``random_gather.py:128-137``).  It takes
``index_select`` for CPU tensors and for shapes outside
:func:`supports_random_gather` (the JAX package takes ``jnp.take`` there);
a CUDA tensor inside the gate launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .gather import _pick

__all__ = ["random_gather", "random_gather_plain", "supports_random_gather",
           "LAUNCHES"]

LAUNCHES = 0      # kernel launches, for proving the path was taken
_UNROLL = 8


def supports_random_gather(num_out: int, num_rows: int, dim: int) -> bool:
    """The JAX package's gate (``random_gather.py:51-54``)."""
    te = _pick(num_out, (2048, 1024, 512))
    return (te is not None and dim % 128 == 0 and num_rows >= 1
            and te % _UNROLL == 0)


def random_gather_plain(table: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` in plain torch."""
    return table.index_select(0, idx.long())


def _lib() -> ctypes.CDLL:
    lib = _build.load("random_gather")
    if lib.gn_random_gather.argtypes is None:
        lib.gn_random_gather.argtypes = \
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.gn_random_gather.restype = ctypes.c_int
    return lib


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"random_gather: table must be [N, d] and idx [E], "
                         f"got {tuple(table.shape)} and {tuple(idx.shape)}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16:
        raise ValueError(f"random_gather: rows of {row_bytes} bytes; the "
                         "kernel copies 16-byte pieces")
    if idx.dtype != torch.int32:
        raise TypeError("random_gather: idx must be int32")
    for t in (table, idx):
        if not t.is_cuda or t.device != table.device:
            raise ValueError(f"random_gather: inputs must be on "
                             f"{table.device}")
        if not t.is_contiguous():
            raise ValueError("random_gather: inputs must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("random_gather: table must be 16-byte aligned")
    out = torch.empty(idx.shape[0], table.shape[1], dtype=table.dtype,
                      device=table.device)
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.gn_random_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            row_bytes, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "random_gather")
    LAUNCHES += 1
    return out


class _RandomGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        if table.device.type == "cpu":
            return random_gather_plain(table, idx)
        return _launch(table, idx)

    @staticmethod
    def backward(ctx, g):
        # The unsorted scatter-add through the sorted route: one stable
        # sort gives the segment ids and the permutation.
        from ..scatter import segment_sum
        (idx,) = ctx.saved_tensors
        seg, perm = torch.sort(idx, stable=True)
        dx = segment_sum(g.contiguous().index_select(0, perm), seg,
                         ctx.num_rows, sorted_pad_safe=True)
        return dx.to(g.dtype), None


def random_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for in-range ids in any order.  Differentiable in
    ``table``."""
    if not supports_random_gather(idx.shape[0], table.shape[0],
                                  table.shape[1]):
        return table.index_select(0, idx.long().clamp(0, table.shape[0] - 1))
    return _RandomGather.apply(table, idx)
