"""Sorted row gather (counterpart of ``graphnets_tpu/ops/pallas/gather.py``).

    out[e] = table[idx[e]]    (zeros where idx[e] is outside [0, N))
    out[e] = table[idx[e]] + addend[e]    (the fused form, f32 sum)

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

:func:`sorted_gather_add` is the fused form (``gather.py:297-318``): the
sum is taken in f32 and rounded once to the wider of the two types, so the
separate ``[E, d]`` add stream of the split-linear edge update disappears.
It replaces the same Pallas kernel with its accumulator started from the
addend block; here it is a streamed copy-and-add bound by memory (~52 MB
at 16384 rows of 384 f32, ~15.5 us).  Its backward is
``sorted_segment_sum`` for the table and a cast for the addend
(``gather.py:286-291``).  :func:`supports_sorted_gather` is the JAX
package's routing gate: both packages defer the same split-linear term.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["sorted_gather", "sorted_gather_plain", "sorted_gather_add",
           "sorted_gather_add_plain", "supports_sorted_gather", "LAUNCHES",
           "ADD_LAUNCHES"]

LAUNCHES = 0      # sorted_gather launches, for proving the path was taken
ADD_LAUNCHES = 0  # sorted_gather_add launches
_DTYPES = (torch.bfloat16, torch.float32)


def _pick(n: int, candidates):
    """The first of ``candidates`` that divides ``n`` (``gather.py:53-57``)."""
    for c in candidates:
        if n % c == 0 and n >= c:
            return c
    return None


def _pick_tn(num_rows: int, num_out: int, te: int) -> int:
    """The JAX kernel's table chunk height (``gather.py:60-70``): about
    twice a tile's expected id span, within [32, 512], dividing the table
    height.  Only the gates read it; the CUDA kernels have no such chunk."""
    span = max(32, 2 * te * num_rows // max(num_out, 1))
    tn = 32
    while tn * 2 <= min(span, 512):
        tn *= 2
    while tn > 32 and num_rows % tn != 0:
        tn //= 2
    return tn


_VMEM_BUDGET = 12 << 20


def supports_sorted_gather(num_out: int, num_rows: int, dim: int,
                           itemsize: int = 4) -> bool:
    """The JAX package's gate (``gather.py:76-90``), term for term:
    lane-aligned rows, an output row count divisible by 512, 256 or 128, a
    table of a multiple of 32 rows, and its kernel's tiles within its VMEM
    budget (which refuses ``dim >= 2048`` or so).  The CUDA kernels need
    none of this; the gate keeps both packages on the same route."""
    te = _pick(num_out, (512, 256, 128))
    if (dim % 128 != 0 or te is None or num_rows % 32 != 0
            or num_rows < 32):
        return False
    tn = _pick_tn(num_rows, num_out, te)
    vmem = (2 * tn * dim * itemsize + te * dim * 4 + te * dim * itemsize
            + te * dim * 4)
    return vmem <= _VMEM_BUDGET


def _rows_or_zeros(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n = table.shape[0]
    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    rows = table.index_select(0, idx.clamp(0, max(n - 1, 0)))
    return torch.where(valid.view(-1, *([1] * (table.dim() - 1))), rows,
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))


def sorted_gather_plain(table: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` in plain torch, with zeros for out-of-range ids."""
    return _rows_or_zeros(table, idx)


def sorted_gather_add_plain(table: torch.Tensor, idx: torch.Tensor,
                            addend: torch.Tensor) -> torch.Tensor:
    """``table[idx] + addend`` in plain torch: zeros for out-of-range ids,
    the sum in f32, one rounding to the wider of the two types."""
    dt = torch.promote_types(table.dtype, addend.dtype)
    return (_rows_or_zeros(table, idx).float() + addend.float()).to(dt)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    if lib.gn_sorted_gather.argtypes is None:
        lib.gn_sorted_gather.argtypes = \
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gn_sorted_gather.restype = ctypes.c_int
        lib.gn_sorted_gather_add.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.gn_sorted_gather_add.restype = ctypes.c_int
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


def _debug_check(idx: torch.Tensor, num_rows: int, what: str) -> None:
    """Under ``GRAPHNETS_TPU_TORCH_DEBUG=1``: the kernel's unchecked
    preconditions, ids ascending and within the table
    (``gather.py:93-116`` of the JAX package), raise when broken."""
    from ...utils.config import debug_checks
    if debug_checks():
        from ...utils.debug import check_sorted_in_range
        check_sorted_in_range(idx, num_rows, what)


def sorted_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for ascending ``idx`` (the canonical receivers);
    out-of-range ids read zeros.  Differentiable in ``table``."""
    _debug_check(idx, table.shape[0], "sorted_gather")
    return _SortedGather.apply(table, idx)


def _launch_add(table: torch.Tensor, idx: torch.Tensor,
                addend: torch.Tensor) -> torch.Tensor:
    global ADD_LAUNCHES
    if table.dim() != 2 or idx.dim() != 1 or tuple(addend.shape) != (
            idx.shape[0], table.shape[1]):
        raise ValueError(
            f"sorted_gather_add: table must be [N, d], idx [E] and addend "
            f"[E, d], got {tuple(table.shape)}, {tuple(idx.shape)} and "
            f"{tuple(addend.shape)}")
    if table.dtype not in _DTYPES or addend.dtype not in _DTYPES:
        raise TypeError(f"sorted_gather_add: table and addend must be bf16 "
                        f"or f32, got {table.dtype} and {addend.dtype}")
    if table.shape[1] % 8:
        raise ValueError(f"sorted_gather_add: d = {table.shape[1]}; the "
                         "kernel moves 4 values a thread from 16-byte "
                         "aligned rows (d % 8 == 0)")
    if idx.dtype != torch.int32:
        raise TypeError("sorted_gather_add: idx must be int32")
    for t in (table, idx, addend):
        if not t.is_cuda or t.device != table.device:
            raise ValueError(f"sorted_gather_add: inputs must be on "
                             f"{table.device}")
        if not t.is_contiguous():
            raise ValueError("sorted_gather_add: inputs must be contiguous")
    if table.data_ptr() % 16 or addend.data_ptr() % 16:
        raise ValueError("sorted_gather_add: table and addend must be "
                         "16-byte aligned")
    out = torch.empty(idx.shape[0], table.shape[1], device=table.device,
                      dtype=torch.promote_types(table.dtype, addend.dtype))
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.gn_sorted_gather_add(
            table.data_ptr(), idx.data_ptr(), addend.data_ptr(),
            out.data_ptr(), idx.shape[0], table.shape[0], table.shape[1],
            int(table.dtype == torch.bfloat16),
            int(addend.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sorted_gather_add")
    ADD_LAUNCHES += 1
    return out


class _SortedGatherAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, addend):
        ctx.save_for_backward(idx)
        ctx.meta = (table.shape[0], table.dtype, addend.dtype)
        if table.device.type == "cpu":
            return sorted_gather_add_plain(table, idx, addend)
        return _launch_add(table, idx, addend)

    @staticmethod
    def backward(ctx, g):
        from .segment_sum import sorted_segment_sum
        (idx,) = ctx.saved_tensors
        num_rows, table_dtype, addend_dtype = ctx.meta
        g = g.contiguous()
        return (sorted_segment_sum(g, idx, num_rows).to(table_dtype), None,
                g.to(addend_dtype))


def sorted_gather_add(table: torch.Tensor, idx: torch.Tensor,
                      addend: torch.Tensor) -> torch.Tensor:
    """``table[idx] + addend`` in one pass for ascending ``idx``: the sum in
    f32, rounded once to ``promote_types(table, addend)``; out-of-range ids
    read zeros.  Differentiable in ``table`` and ``addend``."""
    _debug_check(idx, table.shape[0], "sorted_gather_add")
    return _SortedGatherAdd.apply(table, idx, addend)
