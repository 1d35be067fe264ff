"""Sorted and windowed segment sums (counterpart of
``graphnets_tpu/ops/pallas/segment_sum.py``).

    out[n] = x.dtype( f32 sum of x[e] over the rows with seg[e] == n )

Kernel: ``csrc/segment_sum.cu``.  It replaces the Pallas kernel of
``sorted_segment_sum`` and ``windowed_segment_sum``
(``segment_sum.py:62-221``).
On the H100 both are bound by memory (~13.4 MB at E = 16384, d = 384 into
1024 segments, ~4 us), so each edge row is read once and summed on the
CUDA cores in a fixed order, with no atomics: a warp owns a sorted segment
(binary search over the ascending ids), and a windowed tile of 128
segments walks its graphs' edge window in per-warp parts whose
accumulators are added in warp order.  The source note in the ``.cu``
file has the details.

:func:`sorted_segment_sum` is differentiable; its backward is the sorted
gather (``segment_sum.py:233-239``).  :func:`windowed_segment_sum` is not
differentiated: it serves as a backward scatter only.  Both take their
plain versions for CPU tensors only; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["sorted_segment_sum", "sorted_segment_sum_plain",
           "windowed_segment_sum", "windowed_segment_sum_plain",
           "supports_sorted_segment_sum", "LAUNCHES", "WINDOWED_LAUNCHES"]

LAUNCHES = 0            # sorted kernel launches, for proving the path
WINDOWED_LAUNCHES = 0   # windowed kernel launches
_DTYPES = (torch.bfloat16, torch.float32)


def supports_sorted_segment_sum(num_rows: int, num_segments: int,
                                dim: int) -> bool:
    """The JAX package's gate for its kernel route (``segment_sum.py:54``):
    lane-aligned rows, a row count divisible by 128."""
    return (dim % 128 == 0 and num_rows >= 128 and num_rows % 128 == 0
            and num_segments >= 1)


def _sum_f32(x: torch.Tensor, seg: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """An f32 segment sum rounded once to ``x.dtype``.  Rows with ids
    outside ``[0, num_segments)`` go to a spare segment that is cut off."""
    seg = seg.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    acc = torch.zeros((num_segments + 1,) + tuple(x.shape[1:]),
                      dtype=torch.float32, device=x.device)
    acc.index_add_(0, seg, x.float())
    return acc[:num_segments].to(x.dtype)


def sorted_segment_sum_plain(x: torch.Tensor, seg: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """The sorted kernel's function in plain torch."""
    return _sum_f32(x, seg, num_segments)


def windowed_segment_sum_plain(x, seg, num_segments: int, node_offsets,
                               edge_offsets) -> torch.Tensor:
    """The windowed kernel's function in plain torch: the same f32 sum (the
    windows only restrict where the kernel looks for a segment's rows)."""
    return _sum_f32(x, seg, num_segments)


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_sum")
    if lib.gn_sorted_segment_sum.argtypes is None:
        lib.gn_sorted_segment_sum.argtypes = \
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.gn_sorted_segment_sum.restype = ctypes.c_int
        lib.gn_windowed_segment_sum.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gn_windowed_segment_sum.restype = ctypes.c_int
    return lib


def _check(what: str, x: torch.Tensor, ids) -> None:
    if x.dim() != 2 or x.dtype not in _DTYPES or x.shape[1] % 4:
        raise ValueError(f"{what}: x must be [E, d] bf16 or f32 with "
                         f"d % 4 == 0, got {tuple(x.shape)} {x.dtype}")
    for t in ids:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: ids and offsets must be int32")
    for t in (x, *ids):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: all inputs must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if ids[0].shape != (x.shape[0],):
        raise ValueError(f"{what}: ids have shape {tuple(ids[0].shape)}, "
                         f"expected ({x.shape[0]},)")


def _launch_sorted(x, seg, num_segments: int) -> torch.Tensor:
    global LAUNCHES
    _check("sorted_segment_sum", x, (seg,))
    E, D = x.shape
    out = torch.empty(num_segments, D, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.gn_sorted_segment_sum(
            x.data_ptr(), seg.data_ptr(), out.data_ptr(), E, num_segments, D,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sorted_segment_sum")
    LAUNCHES += 1
    return out


def _sorted(x, seg, num_segments: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return sorted_segment_sum_plain(x, seg, num_segments)
    return _launch_sorted(x, seg, num_segments)


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, num_segments):
        ctx.save_for_backward(seg)
        return _sorted(x, seg, num_segments)

    @staticmethod
    def backward(ctx, g):
        from .gather import sorted_gather
        (seg,) = ctx.saved_tensors
        return sorted_gather(g, seg), None, None


def sorted_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum of the rows of ``x`` by ascending ``seg`` ids (the
    canonical receivers); rows with ids outside ``[0, num_segments)``
    are dropped.  Differentiable in ``x``."""
    return _SortedSegmentSum.apply(x, seg, num_segments)


def windowed_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                         num_segments: int, node_offsets: torch.Tensor,
                         edge_offsets: torch.Tensor) -> torch.Tensor:
    """Segment sum for ids unsorted within each graph but local to it (the
    canonical senders): graph ``b`` owns segments
    ``node_offsets[b]:node_offsets[b+1]`` and rows
    ``edge_offsets[b]:edge_offsets[b+1]`` (``[G + 1]`` int32 each).  Not
    differentiated."""
    global WINDOWED_LAUNCHES
    if x.device.type == "cpu":
        return windowed_segment_sum_plain(x, seg, num_segments, node_offsets,
                                          edge_offsets)
    _check("windowed_segment_sum", x, (seg, node_offsets, edge_offsets))
    if node_offsets.shape != edge_offsets.shape or node_offsets.dim() != 1:
        raise ValueError("windowed_segment_sum: offsets must both be [G + 1]")
    D = x.shape[1]
    G = node_offsets.shape[0] - 1
    out = torch.empty(num_segments, D, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.gn_windowed_segment_sum(
            x.data_ptr(), seg.data_ptr(), node_offsets.data_ptr(),
            edge_offsets.data_ptr(), G, out.data_ptr(), num_segments, D,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "windowed_segment_sum")
    WINDOWED_LAUNCHES += 1
    return out
