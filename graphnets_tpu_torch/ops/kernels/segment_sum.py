"""Sorted and windowed segment sums (counterpart of
``graphnets_tpu/ops/pallas/segment_sum.py``).

    out[n] = x.dtype( f32 sum of x[e] over the rows with seg[e] == n )

Kernel: ``csrc/segment_sum.cu``.  It replaces the Pallas kernel of
``sorted_segment_sum`` and ``windowed_segment_sum``
(``segment_sum.py:62-221``).
On the H100 both are bound by memory (~13.4 MB at E = 16384, d = 384 into
1024 segments, ~4 us; ~570 MB, ~0.17 ms, at the large graph's 1,048,576
rows), so each edge row is read once with 16-byte loads and summed on the
CUDA cores in a fixed order, with no float atomics.  Sorted ids: a block
owns a fixed chunk of rows (:func:`sorted_plan`: 64 x 2^k rows, about two
blocks an SM), stages their ids once and sums each run of equal ids in
edge order; a run that crosses a chunk edge leaves a partial row, and the
last of its chunks to finish (a self-resetting counter of its segment)
adds the partial rows in chunk order: one launch, the same work a block
whatever the segment lengths (a sampled batch's pad node takes ~51,670 of
56,320 rows).  Rejected: a warp a segment with two binary searches over
all E ids and a second launch for long segments (0.0114 ms at the headline
shape, 0.280 ms at the large graph; H100 80GB HBM3, 700 W).  Windowed ids:
a tile of 16 segments sorts the edges of its graphs' window that are its
own by segment (a stable counting sort in shared memory) and adds each
segment's rows in edge order in registers.  Few rows (the sort task's 512,
:func:`small_plan`): both sums take one pass with many blocks instead, a
block a tile of segments and a slab of columns whose sub-warps add
contiguous parts of the tile's rows into partial rows in shared memory,
then write each row once, the parts in order.  The source note in the
``.cu`` file has the details.

:func:`sorted_segment_sum` is differentiable; its backward is the sorted
gather (``segment_sum.py:233-239``).  :func:`windowed_segment_sum` is not
differentiated: it serves as a backward scatter only.  Both take their
plain versions for CPU tensors only; a CUDA tensor launches the kernel or
raises.  :func:`edge_order_segment_sum` is the sum that the JAX package
takes where its kernel refuses a shape (``jax.ops.segment_sum`` in the
rows' own type): rows added in edge order, every add rounded (bit-equal to
``jax.ops.segment_sum`` on JAX's CPU backend).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

__all__ = ["sorted_segment_sum", "sorted_segment_sum_plain",
           "windowed_segment_sum", "windowed_segment_sum_plain",
           "edge_order_segment_sum", "edge_order_segment_sum_plain",
           "supports_sorted_segment_sum", "sorted_plan", "small_plan",
           "SmallPlan", "LAUNCHES", "WINDOWED_LAUNCHES"]

LAUNCHES = 0            # sorted kernel launches, for proving the path
WINDOWED_LAUNCHES = 0   # windowed kernel launches
_DTYPES = (torch.bfloat16, torch.float32)
_MIN_CHUNK, _MAX_CHUNK = 64, 2048    # rows of a sorted-sum chunk
_counters: dict = {}    # device -> the sorted kernel's int32 counters
# The one-pass kernel for few rows (csrc/segment_sum.cu, kSmall*), where
# it beats the large-row kernels (chip_smoke.py --phase sums, H100).
_SMALL_LANES = 8        # 16-byte vectors of a sub-warp: a column slab
_SMALL_SUBWARPS = 32    # sub-warps of a block (256 threads)
_SMALL_TILES = (4, 8, 16)   # segments of a block, the fewest that fit
_SMALL_MAX_ROWS = 2048  # rows at most
_SMALL_MAX_WINDOW = 512     # windowed: rows a graph at most, on average


def supports_sorted_segment_sum(num_rows: int, num_segments: int,
                                dim: int) -> bool:
    """The JAX package's gate for its kernel route (``segment_sum.py:54``):
    lane-aligned rows, a row count divisible by 128."""
    return (dim % 128 == 0 and num_rows >= 128 and num_rows % 128 == 0
            and num_segments >= 1)


def sorted_plan(num_rows: int, dim: int, dtype=torch.bfloat16,
                sms: int = 132):
    """``(rows_per_chunk, chunks, slabs)`` of the sorted kernel, whose
    blocks are chunks x column slabs.  A slab is 32 lanes' 16-byte vectors
    (4 values: f32, or bf16 with ``dim % 8 != 0``; else 8), or 64 lanes'
    where a row has more than 32.  Chunks are 64 x 2^k rows (at most 2048),
    the smallest that give at most two blocks an SM.  Scratch:
    ``2 * chunks * dim`` f32 partial values, and a counter and two span
    slots per segment and slab."""
    vec = 8 if dtype == torch.bfloat16 and dim % 8 == 0 else 4
    per_slab = 64 if dim // vec > 32 else 32
    slabs = -(-(dim // vec) // per_slab)
    rows = _MIN_CHUNK
    while -(-num_rows // rows) * slabs > 2 * sms and rows < _MAX_CHUNK:
        rows *= 2
    return rows, max(1, -(-num_rows // rows)), slabs


class SmallPlan(NamedTuple):
    """The one-pass kernel's launch: ``tiles`` x ``slabs`` blocks of
    ``subwarps`` x 8 threads; a block sums the rows of ``tile`` segments
    over 8 vectors of ``vec`` values, sub-warp k the k-th of ``subwarps``
    contiguous parts of the tile's rows, into ``shared_bytes`` of f32
    partial rows."""
    tile: int
    subwarps: int
    vec: int
    tiles: int
    slabs: int
    shared_bytes: int


def small_plan(num_rows: int, num_segments: int, dim: int,
               dtype=torch.bfloat16, sms: int = 132,
               graphs: Optional[int] = None,
               edge_order: bool = False) -> Optional[SmallPlan]:
    """The one-pass kernel's plan for a sum of ``num_rows`` rows of
    ``dim`` values into ``num_segments`` (sorted ids, or windowed ids over
    ``graphs`` windows), or None where the large-row kernels are faster:
    more than ``_SMALL_MAX_ROWS`` rows, more than two blocks an SM at the
    largest tile, or windows of more than ``_SMALL_MAX_WINDOW`` rows on
    average (each block reads its graphs' whole windows).  Vectors of 16
    bytes (8 bf16 values, or 4), 8 a slab; tiles of 4, 8 or 16 segments,
    the fewest that give at most a block an SM; 32 sub-warps a block.
    ``edge_order``: the edge-order sum (ids sorted stably, any row count
    and width; one sub-warp walks a tile's rows in order).  The crossovers
    and sizes were measured on the H100 (``chip_smoke.py --phase
    sums``)."""
    if num_segments < 1 or dim < 1:
        return None
    if dtype == torch.bfloat16 and dim % 8 == 0:
        vec = 8
    elif dim % 4 == 0:
        vec = 4
    elif edge_order:
        vec = 1
    else:
        return None
    slabs = -(-(dim // vec) // _SMALL_LANES)
    for tile in _SMALL_TILES:
        tiles = -(-num_segments // tile)
        if tiles * slabs <= sms:
            break
    if edge_order:
        subwarps = 1
    elif (num_rows > _SMALL_MAX_ROWS or tiles * slabs > 2 * sms
          or (graphs is not None
              and num_rows > _SMALL_MAX_WINDOW * max(graphs, 1))):
        return None
    else:
        subwarps = _SMALL_SUBWARPS
    return SmallPlan(tile, subwarps, vec, tiles, slabs,
                     subwarps * tile * _SMALL_LANES * vec * 4)


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
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.gn_sorted_segment_sum.restype = ctypes.c_int
        lib.gn_windowed_segment_sum.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gn_windowed_segment_sum.restype = ctypes.c_int
        lib.gn_small_segment_sum.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.gn_small_segment_sum.restype = ctypes.c_int
    return lib


def _check(what: str, x: torch.Tensor, ids, any_width=False) -> None:
    if (x.dim() != 2 or x.dtype not in _DTYPES
            or (x.shape[1] % 4 and not any_width)):
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


def _zeroed_counters(n: int, device) -> torch.Tensor:
    """``n`` int32 counters that are zero, kept per device: the kernel
    leaves them zero, so a replayed CUDA graph finds them zeroed.  A
    larger buffer replaces a smaller one, which stays allocated: a CUDA
    graph captured with it still uses it."""
    bufs = _counters.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1 << 16), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_small(what: str, x, seg, num_segments: int, plan: SmallPlan,
                  windows=None, edge_order: bool = False) -> torch.Tensor:
    """One launch of the one-pass kernel; ``windows``: the windowed ids'
    ``(node_offsets, edge_offsets)``, else the ids ascend; ``edge_order``
    (ascending ids only): every add rounded to ``x.dtype``."""
    E, D = x.shape
    out = torch.empty(num_segments, D, dtype=x.dtype, device=x.device)
    no, eo = windows if windows is not None else (seg, seg)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.gn_small_segment_sum(
            x.data_ptr(), seg.data_ptr(), no.data_ptr(), eo.data_ptr(),
            no.shape[0] - 1, out.data_ptr(), E, num_segments, D, plan.tile,
            plan.subwarps, plan.vec, int(x.dtype == torch.bfloat16),
            int(windows is None), int(edge_order),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, what)
    return out


def _launch_sorted_small(x, seg, num_segments: int,
                         plan: SmallPlan) -> torch.Tensor:
    global LAUNCHES
    _check("sorted_segment_sum", x, (seg,))
    out = _launch_small("sorted_segment_sum", x, seg, num_segments, plan)
    LAUNCHES += 1
    return out


def _launch_sorted(x, seg, num_segments: int) -> torch.Tensor:
    global LAUNCHES
    _check("sorted_segment_sum", x, (seg,))
    E, D = x.shape
    out = torch.empty(num_segments, D, dtype=x.dtype, device=x.device)
    lib = _lib()
    rows, chunks, slabs = sorted_plan(E, D, x.dtype, _sms(x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty(2 * chunks, D, **f32)
    counters = _zeroed_counters(num_segments * slabs, x.device)
    spans = torch.empty(2 * num_segments * slabs, dtype=torch.int32,
                        device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gn_sorted_segment_sum(
            x.data_ptr(), seg.data_ptr(), out.data_ptr(), part.data_ptr(),
            counters.data_ptr(), spans.data_ptr(), E, num_segments, D, rows,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sorted_segment_sum")
    LAUNCHES += 1
    return out


def _sorted(x, seg, num_segments: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return sorted_segment_sum_plain(x, seg, num_segments)
    if x.dim() == 2:
        plan = small_plan(x.shape[0], num_segments, x.shape[1], x.dtype,
                          _sms(x.device))
        if plan is not None:
            return _launch_sorted_small(x, seg, num_segments, plan)
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
    if x.device.type == "cpu":
        return windowed_segment_sum_plain(x, seg, num_segments, node_offsets,
                                          edge_offsets)
    plan = None
    if x.dim() == 2 and node_offsets.dim() == 1:
        plan = small_plan(x.shape[0], num_segments, x.shape[1], x.dtype,
                          _sms(x.device), graphs=node_offsets.shape[0] - 1)
    if plan is not None:
        return _launch_windowed_small(x, seg, num_segments, node_offsets,
                                      edge_offsets, plan)
    return _launch_windowed(x, seg, num_segments, node_offsets, edge_offsets)


def _check_windows(what: str, x, seg, node_offsets, edge_offsets) -> None:
    _check(what, x, (seg, node_offsets, edge_offsets))
    if node_offsets.shape != edge_offsets.shape or node_offsets.dim() != 1:
        raise ValueError(f"{what}: offsets must both be [G + 1]")


def _launch_windowed_small(x, seg, num_segments: int, node_offsets,
                           edge_offsets, plan: SmallPlan) -> torch.Tensor:
    global WINDOWED_LAUNCHES
    _check_windows("windowed_segment_sum", x, seg, node_offsets,
                   edge_offsets)
    out = _launch_small("windowed_segment_sum", x, seg, num_segments, plan,
                        (node_offsets, edge_offsets))
    WINDOWED_LAUNCHES += 1
    return out


def _launch_windowed(x, seg, num_segments: int, node_offsets,
                     edge_offsets) -> torch.Tensor:
    global WINDOWED_LAUNCHES
    _check_windows("windowed_segment_sum", x, seg, node_offsets,
                   edge_offsets)
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


def edge_order_segment_sum_plain(x: torch.Tensor, seg: torch.Tensor,
                                 num_segments: int) -> torch.Tensor:
    """:func:`edge_order_segment_sum` in plain torch: the k-th row of each
    segment (in edge order) is added in the k-th of as many rounds as the
    longest segment has rows, each add rounded to ``x.dtype``."""
    seg = seg.long()
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    keep = torch.nonzero((seg >= 0) & (seg < num_segments)).flatten()
    if keep.numel() == 0:
        return out
    ids, order = torch.sort(seg[keep], stable=True)
    rows = keep[order]
    first = torch.searchsorted(ids, ids)   # where each id's run starts
    rank = torch.arange(ids.numel(), device=x.device) - first
    for k in range(int(rank.max()) + 1):
        at = rank == k
        n, r = ids[at], rows[at]
        out[n] = (out[n].float() + x[r].float()).to(x.dtype)
    return out


def edge_order_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """The segment sum of ``jax.ops.segment_sum`` on rows of ``x.dtype``
    (bit-equal to it on JAX's CPU backend): each segment's rows added in
    edge order into an accumulator of ``x.dtype``, every add rounded; rows
    with ids outside ``[0, num_segments)`` dropped.  On the card the ids
    are sorted stably and the rows gathered in that order, then one thread
    a column walks each tile's rows: a fixed order, linear in the rows, at
    any row count and width.  It serves the windowed sum's fallback, so it
    counts in ``WINDOWED_LAUNCHES``.  Not differentiated."""
    global WINDOWED_LAUNCHES
    if x.device.type == "cpu":
        return edge_order_segment_sum_plain(x, seg, num_segments)
    what = "edge_order_segment_sum"
    _check(what, x, (seg,), any_width=True)
    plan = small_plan(x.shape[0], num_segments, x.shape[1], x.dtype,
                      _sms(x.device), edge_order=True)
    if plan is None:
        raise ValueError(f"{what}: no segments")
    ids, perm = torch.sort(seg, stable=True)
    out = _launch_small(what, x.index_select(0, perm), ids, num_segments,
                        plan, edge_order=True)
    WINDOWED_LAUNCHES += 1
    return out
