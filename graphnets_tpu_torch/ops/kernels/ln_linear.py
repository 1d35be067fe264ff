"""``LayerNorm(x) @ w [+ addend]`` fused, forward and backward (counterpart
of ``graphnets_tpu/ops/pallas/ln_linear.py``).

Forward kernel: ``csrc/ln_linear_fwd.cu``.  It replaces the Pallas kernel
of ``ln_matmul`` (``ln_linear.py:100-159,298-308``), with its arithmetic:
f32 row statistics in the Flux convention, the normalised row rounded to
``x.dtype``, the product accumulated in f32; without ``addend`` the f32
partial comes back, with it ``(product + addend)`` rounded once to
``x.dtype``.  The normalised ``[T, d]`` rows never reach device memory.
On the H100 the bucketed headline shape (T = 16384, d = dout = 384, bf16
rows, f32 addend) is bound by memory (~50.6 MB for 4.8 GFLOP, ~15 us); the
sort task's (T = 512, f32) by f32 operations (~2.3 us).  bf16 rows run on
the ``wgmma`` + TMA core of the edge updates (``csrc/edge_wgmma.cuh``:
persistent blocks, x read once and normalised once for all of ``dout``,
the addend staged by TMA during the products); f32 rows on the CUDA cores
in true f32, on a grid that :func:`f32_plan` sizes to fill the card.
Rejected: the WMMA tile that normalised x once per 128 output columns
(0.0861 ms at the bucketed headline shape, 0.0291 ms at the sort task's;
H100 80GB HBM3, 700 W).

Backward kernel: ``csrc/ln_linear_bwd.cu``.  It replaces the Pallas kernel
``_bwd_kernel`` (``ln_linear.py:165-246``), with its arithmetic: the LN
statistics are recomputed from ``x``, and the Flux std convention and the
var == 0 guard hold.  On the H100 it is bound by memory in bf16 (~38.6 MB
for 9.7 GFLOP at T = 16384, d = dout = 384, ~11.5 us).  The TPU kernel
carried dW, dscale and dbias across its sequential grid; here bf16 rows of
d = 128 / 256 / 384 / 512 take two ``wgmma`` passes fed by TMA: a row pass
that writes dx, the bf16 normalised rows and per-block column sums, and a
dW pass over row ranges whose last blocks add the partials in a fixed
order (no atomics).  f32 rows of those widths (bound by f32 operations:
4.10 ms at T = 1,048,576, d = dout = 256) take the same two passes on the
register-blocked CUDA-core tile of ``csrc/f32_tile.cuh``, as
:func:`f32_backward_plan` sizes them.  Every other width takes a row pass
in two steps, a split-K dW pass and three fixed-order reductions.  One
call of :func:`ln_linear_backward` runs the passes and counts as one
launch.  The source notes in the ``.cu``
files have the details.

:func:`ln_matmul` is differentiable: its backward is
:func:`ln_linear_backward`, and the gradient of ``addend`` is the
cotangent cast to the addend's type (``ln_linear.py:275-292``).  Both take
their plain versions (``ops.ln_linear``) for CPU tensors only; a CUDA
tensor launches the kernel or raises.  A shape outside
:func:`supports_ln_matmul` takes the plain composition on any device, as
in the JAX package; the gate is the JAX package's (``ln_linear.py:81-85``),
for bf16 and f32 rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ..ln_linear import ln_linear_backward_plain, ln_matmul_reference
from . import _build

__all__ = ["ln_matmul", "supports_ln_matmul", "ln_linear_backward",
           "supports_ln_linear_backward", "f32_plan", "f32_backward_plan",
           "LAUNCHES", "FWD_LAUNCHES"]

LAUNCHES = 0            # backward launches, for proving the path was taken
FWD_LAUNCHES = 0        # ln_matmul (forward) launches
_DIMS = (128, 256, 384, 512)
_DTYPES = (torch.bfloat16, torch.float32)
_ROWS = 32              # rows per block of the two-step row pass
_TC_ROWS = 64           # rows of a tensor-core row-pass tile
_TC_TILE = 128          # dW tile (both dims) of the tensor-core dW pass


def supports_ln_linear_backward(n_rows: int, d: int, dout: int,
                                dtype: torch.dtype) -> bool:
    """Shapes the kernel takes: bf16 or f32 rows, ``d`` and ``dout``
    multiples of 128 (every shape of :func:`supports_ln_matmul`)."""
    return (dtype in _DTYPES and n_rows >= 1 and d >= 128 and d % 128 == 0
            and dout >= 128 and dout % 128 == 0)


def _one_step_rows(d: int, dout: int, dtype: torch.dtype) -> bool:
    """Whether the rows take a one-kernel row pass (the widths it is built
    for, any ``dout``: ``wgmma`` for bf16 rows, register-blocked CUDA-core
    tiles for f32 rows) or the row pass in two steps through an f32
    ``[T, d]`` scratch (every other width)."""
    return d in _DIMS


_VMEM_BUDGET = 12 << 20


def supports_ln_matmul(n_rows: int, d: int, dout: int,
                       dtype: torch.dtype = torch.bfloat16) -> bool:
    """The JAX package's gate (``ln_linear.py:81-85``: lane-aligned ``d``
    and ``dout``, whole 8-row tiles, its kernel's VMEM term) for bf16 or
    f32 rows.  The CUDA kernels add no term of their own."""
    fits = d * dout * 6 + 256 * (d * 14 + dout * 6) <= _VMEM_BUDGET
    return (d % 128 == 0 and dout % 128 == 0 and n_rows % 8 == 0
            and n_rows >= 8 and fits and dtype in _DTYPES)


def _rows_per_split(T: int, d: int, dout: int, tile: int, device) -> int:
    """Rows per block of the split-K dW pass (``tile`` x ``tile`` tiles of
    dW): about two blocks an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = (d // tile) * (dout // tile)
    splits = max(1, min(-(-2 * sms // tiles), -(-T // _ROWS)))
    return -(-T // (splits * _ROWS)) * _ROWS


def _backward_args():
    return [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("ln_linear_bwd")
    if lib.gn_ln_linear_backward.argtypes is None:
        for fn in (lib.gn_ln_linear_backward, lib.gn_ln_linear_backward_f32):
            fn.argtypes = _backward_args()
            fn.restype = ctypes.c_int
        fn = lib.gn_ln_linear_backward_tc
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.gn_ln_linear_backward_f32_tiles
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _tc_plan(T: int, d: int, dout: int, sms: int):
    """``(row_blocks, splits, rows_per_split)`` of the tensor-core passes:
    one persistent row-pass block an SM (at most one a tile), and row
    ranges of the dW pass (whole 64-row stages) that give about one block
    an SM."""
    row_blocks = min(-(-T // _TC_ROWS), sms)
    tiles = (d // _TC_TILE) * (dout // _TC_TILE)
    splits = max(1, min(-(-sms // tiles), -(-T // 64)))
    rows_per_split = -(-T // (splits * 64)) * 64
    return row_blocks, -(-T // rows_per_split), rows_per_split


def f32_plan(T: int, dout: int, sms: int = 132):
    """``(tile_rows, tile_cols, blocks)`` of ``ln_matmul``'s f32 rows:
    32 x 128 tiles where they give every SM a block, else 16 x 64 (the
    sort task's T = 512, dout = 384: 192 blocks instead of 48)."""
    for rows, cols in ((32, 128), (16, 64)):
        blocks = -(-T // rows) * (dout // cols)
        if blocks >= sms:
            break
    return rows, cols, blocks


_F32_SMALL = 16         # rows of an f32 row tile where the rows are few
_F32_TILE = 128         # dW tile (both dims) of the f32 dW pass


class F32BackwardPlan(NamedTuple):
    """The grids of the f32 LN->matmul backward at ``d`` in 128 .. 512."""
    tile_rows: int      # rows of a row-pass tile
    row_tiles: int      # ceil(T / tile_rows): row-pass blocks, dW units
    tiles: int          # 128 x 128 tiles of dW
    splits: int         # row ranges of the dW pass, in whole row tiles


def f32_backward_plan(T: int, d: int, dout: int,
                      sms: int = 132) -> F32BackwardPlan:
    """The f32 backward's grids.  Row pass: a block a tile of 128 rows at
    d = 128 and 64 above, across all d columns; where those leave SMs
    without a tile, 16-row tiles in two steps (the product in 16 x 128
    tiles, then the pullback).  dW pass: 128 x 128 tiles of dW, each split
    over ranges of whole row tiles: where T has the tiles, as many ranges
    as make whole waves of two blocks an SM (tiles x splits a multiple of
    2 x ``sms``), else at most one wave of ranges of about 64 rows or
    more."""
    tile_rows = 128 if d == 128 else 64
    if -(-T // tile_rows) < sms:
        tile_rows = _F32_SMALL
    row_tiles = -(-T // tile_rows)
    tiles = (d // _F32_TILE) * (dout // _F32_TILE)
    wave = 2 * sms
    whole = wave // math.gcd(tiles, wave)  # splits for whole waves
    splits = (whole if row_tiles >= whole
              else max(1, min(row_tiles, wave // tiles, T // 64)))
    return F32BackwardPlan(tile_rows, row_tiles, tiles, splits)


def f32_split_rows(plan: F32BackwardPlan, T: int):
    """The ``[k0, k1)`` rows of each range of the f32 dW pass, as the
    kernel computes them."""
    at = lambda i: min(T, plan.tile_rows
                       * (i * plan.row_tiles // plan.splits))
    return [(at(i), at(i + 1)) for i in range(plan.splits)]


def f32_backward_scratch(plan: F32BackwardPlan, T: int, d: int, dout: int):
    """Shapes of the scratch the f32 entry is given, in its order: f32
    ``xn``, ``dxn`` (16-row tiles only), ``part_rows``, ``part_dw``,
    ``part_sd``, and the dW tiles' int32 ``counters``."""
    small = plan.tile_rows == _F32_SMALL
    return {"xn": (T, d), "dxn": (T, d) if small else (0,),
            "part_rows": (plan.row_tiles, 2, d),
            "part_dw": (plan.splits, d, dout),
            "part_sd": (plan.splits, 2, d), "counters": (plan.tiles,)}


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("ln_linear_fwd")
    fn = lib.gn_ln_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, scale, bias, w, g, passes: int = 7):
    """The kernels on the card.  ``passes`` selects the passes of the
    widths with a one-kernel row pass (1: row pass, 2: dW pass, 4: its
    fused reduction); anything but 7 is for timing a pass alone and leaves
    some outputs unset."""
    global LAUNCHES
    T, d = x.shape
    dout = w.shape[1]
    if not supports_ln_linear_backward(T, d, dout, x.dtype):
        raise ValueError(f"ln_linear_backward: unsupported x "
                         f"{tuple(x.shape)} {x.dtype}, dout={dout} (bf16 or "
                         f"f32, d % 128 == 0, dout % 128 == 0)")
    shapes = {"w": (w, (d, dout)), "g": (g, (T, dout)),
              "scale": (scale, (d,)), "bias": (bias, (d,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ln_linear_backward: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    args = [x, g.to(x.dtype), w.to(x.dtype), scale.float(), bias.float()]
    for t in args:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ln_linear_backward: all inputs must be on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("ln_linear_backward: inputs must be contiguous "
                             "and 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=x.device)
    is_f32 = x.dtype == torch.float32
    dx = torch.empty_like(x)
    dw = torch.empty(d, dout, **f32)
    ds = torch.empty(d, **f32)
    db = torch.empty(d, **f32)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    one_step = _one_step_rows(d, dout, x.dtype)
    if one_step and is_f32:
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        plan = f32_backward_plan(T, d, dout, sms)
        shapes = f32_backward_scratch(plan, T, d, dout)
        scratch = [torch.empty(shape, **f32) for shape in shapes.values()]
        scratch[-1] = torch.empty(shapes["counters"], dtype=torch.int32,
                                  device=x.device)
        # W^T [dout, d], the row pass's row-major B operand.
        args[2] = args[2].t().contiguous()
        with torch.cuda.device(x.device):
            err = lib.gn_ln_linear_backward_f32_tiles(
                *[t.data_ptr() for t in (*args, dx, dw, ds, db, *scratch)],
                T, d, dout, plan.tile_rows, plan.splits, passes, stream)
    elif one_step:
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        row_blocks, splits, rows_per_split = _tc_plan(T, d, dout, sms)
        scratch = [torch.empty_like(x), torch.empty(row_blocks, 2, d, **f32),
                   torch.empty(splits, d, dout, **f32),
                   torch.empty((d // _TC_TILE) * (dout // _TC_TILE),
                               dtype=torch.int32, device=x.device)]
        with torch.cuda.device(x.device):
            err = lib.gn_ln_linear_backward_tc(
                *[t.data_ptr() for t in (*args, dx, dw, ds, db, *scratch)],
                T, d, dout, row_blocks, splits, rows_per_split, passes,
                stream)
    else:
        rows_per_split = _rows_per_split(T, d, dout, 64 if is_f32 else 128,
                                         x.device)
        splits = -(-T // rows_per_split)
        blocks = -(-T // _ROWS)
        scratch = [torch.empty(T, 2, **f32),
                   torch.empty(splits, d, dout, **f32),
                   torch.empty(blocks, d, **f32),
                   torch.empty(blocks, d, **f32), torch.empty(T, d, **f32)]
        entry = (lib.gn_ln_linear_backward_f32 if is_f32
                 else lib.gn_ln_linear_backward)
        with torch.cuda.device(x.device):
            err = entry(
                *[t.data_ptr() for t in (*args, dx, dw, ds, db, *scratch)],
                T, d, dout, rows_per_split, 1, stream)
    _build.check(lib, err, "ln_linear_backward")
    LAUNCHES += 1
    return dx, ds, db, dw


def ln_linear_backward(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Gradients of ``x.dtype(LayerNorm(x; scale, bias)) @ w`` for the
    cotangent ``g [T, dout]``: ``(dx [T, d] in x.dtype, dscale [d],
    dbias [d], dw [d, dout])``, the last three in f32."""
    if x.device.type == "cpu":
        return ln_linear_backward_plain(x, scale, bias, w, g)
    return _launch(x, scale, bias, w, g)


def _launch_forward(x, scale, bias, w, addend):
    global FWD_LAUNCHES
    T, d = x.shape
    dout = w.shape[1]
    if not supports_ln_matmul(T, d, dout, x.dtype):
        raise ValueError(f"ln_matmul: unsupported x {tuple(x.shape)} "
                         f"{x.dtype}, dout={dout}")
    shapes = {"w": (w, (d, dout)), "scale": (scale, (d,)),
              "bias": (bias, (d,))}
    if addend is not None:
        shapes["addend"] = (addend, (T, dout))
        if addend.dtype not in _DTYPES:
            raise TypeError(f"ln_matmul: addend must be bf16 or f32, got "
                            f"{addend.dtype}")
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ln_matmul: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    args = [x, w.to(x.dtype), scale.float(), bias.float()]
    for t in args + ([] if addend is None else [addend]):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ln_matmul: all inputs must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("ln_matmul: inputs must be contiguous and "
                             "16-byte aligned")
    kind = 0 if addend is None else (1 if addend.dtype == torch.float32
                                     else 2)
    out = torch.empty(T, dout, device=x.device,
                      dtype=torch.float32 if addend is None else x.dtype)
    is_f32 = x.dtype == torch.float32
    tile_rows = 0
    if is_f32:
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        tile_rows = f32_plan(T, dout, sms)[0]
    lib = _fwd_lib()
    with torch.cuda.device(x.device):
        err = lib.gn_ln_matmul(
            *[t.data_ptr() for t in args],
            None if addend is None else addend.data_ptr(), out.data_ptr(),
            T, d, dout, int(is_f32), kind, tile_rows,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "ln_matmul")
    FWD_LAUNCHES += 1
    return out


class _LnMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, w, addend):
        ctx.save_for_backward(x, scale, bias, w)
        ctx.addend_dtype = None if addend is None else addend.dtype
        if x.device.type == "cpu":
            return ln_matmul_reference(x, scale, bias, w, addend)
        return _launch_forward(x, scale, bias, w, addend)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w = ctx.saved_tensors
        g = g.contiguous()
        dx, ds, db, dw = ln_linear_backward(x, scale, bias, w, g)
        d_addend = (None if ctx.addend_dtype is None
                    else g.to(ctx.addend_dtype))
        return (dx, ds.to(scale.dtype), db.to(bias.dtype), dw.to(w.dtype),
                d_addend)


def ln_matmul(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              w: torch.Tensor, addend: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """``LayerNorm(x; scale, bias) @ w [+ addend]`` in one pass.

    Without ``addend`` the result is the f32 partial product; with it
    (``[T, dout]``, f32 or bf16) the completed row in ``x.dtype``, rounded
    once.  Differentiable in every tensor argument."""
    if not supports_ln_matmul(x.shape[0], x.shape[1], w.shape[1], x.dtype):
        return ln_matmul_reference(x, scale, bias, w, addend)
    return _LnMatmul.apply(x, scale, bias, w, addend)
