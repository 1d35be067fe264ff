"""Fused LayerNorm -> FeedForward -> residual, forward and backward
(counterpart of ``graphnets_tpu/ops/pallas/fused_ffn.py``).

    y = bf16( xf + ((bf16(relu(bf16(LN(x)) @ W1 + b1)) @ W2 + b2)
                    + f32(extra)) )

Both kernels take what the JAX gate takes (:func:`supports_fused_ffn`:
d = 128, 256, 384 or 512, whole 8-row tiles) on bf16 and f32 rows; a CUDA
tensor outside it raises a ``ValueError``.

Kernel: ``csrc/fused_ffn.cu``.  It replaces the Pallas forward kernel of
``ln_ffn_residual`` (``fused_ffn.py:79-97,130-170``).  On the H100 it is
bound by the tensor cores (38.7 GFLOP against ~40 MB at T = 16384,
d = 384).  bf16 rows run on ``wgmma`` fed by TMA: the
weight slices stream through a ring in shared memory, and each 64-wide
hidden slice goes from the first product's accumulator, through bias, relu
and rounding, straight into the second product's A operand in registers,
so the ``[rows, 4d]`` hidden activation never leaves them; f32 rows take
true-f32 multiply-adds on the CUDA cores, register-blocked, with the
weight slices in a ``cp.async`` ring.  With few row tiles, up to 8 (f32:
16) blocks split the hidden dimension (:func:`_splits`,
:func:`_splits_f32`).  The source note in the ``.cu`` file has the
details.

Backward kernel: ``csrc/fused_ffn_bwd.cu``.  It replaces the Pallas kernel
of ``_fused_backward`` (``fused_ffn.py:176-283``), with its arithmetic:
only ``x`` is kept from the forward, the LN statistics and the hidden
activation are recomputed.  On the H100 it is bound by the tensor cores
(2.75 TFLOP against 1.6 GB at T = 1,048,576, d = 256).  The five products
the function needs run as warp-specialised ``wgmma`` passes fed by TMA
(bf16 rows; for f32 rows true-f32 CUDA-core passes on one register-blocked
128 x 128 tile, given W1^T and W2^T): hp and dh per row
tile, which write ``h`` and ``dhp`` once to device memory in x's type;
``dxn``; then dW1 and dW2 split over row ranges.  Partials are added in a
fixed order (no atomics).  One call of :func:`ln_ffn_backward` runs the
passes and counts as one launch.

:func:`ln_ffn_residual` is differentiable with the JAX package's contract
(``fused_ffn.py:298-339``): ``extra`` is not saved and its gradient is the
cotangent cast to its type; the cotangent is cast to ``x.dtype`` before
the backward.  Forward and backward take :func:`ln_ffn_residual_plain` and
:func:`ln_ffn_backward_plain` for CPU tensors only; a CUDA tensor launches
the kernels or raises.
:func:`ln_ffn_residual_reference` is the unfused module composition, with
its own rounding points, for shapes the kernel does not take.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...nn.core import EPS, layer_norm
from ..ln_linear import matmul_f32
from . import _build

__all__ = ["ln_ffn_residual", "ln_ffn_residual_plain",
           "ln_ffn_residual_reference", "supports_fused_ffn",
           "ln_ffn_backward", "ln_ffn_backward_plain", "LAUNCHES",
           "BWD_LAUNCHES"]

LAUNCHES = 0                    # kernel launches, for proving the path
BWD_LAUNCHES = 0                # backward launches
_DTYPES = (torch.bfloat16, torch.float32)   # row types the kernels take
_VMEM_BUDGET = 12 << 20         # the JAX gate's budget (``fused_ffn.py:108``)


def supports_fused_ffn(n_rows: int, d: int,
                       dtype: torch.dtype = torch.bfloat16) -> bool:
    """The JAX package's gate (``fused_ffn.py:99-105``), letter for letter:
    a lane-aligned width, whole 8-row tiles, and both weights plus one
    8-row tile within the VMEM budget (f32 assumed), which lets d = 128,
    256, 384 and 512 through.  The kernels take bf16 and f32 rows."""
    dh = 4 * d
    fits = 2 * d * dh * 4 + 8 * (d * 12 + dh * 8) <= _VMEM_BUDGET
    return (dtype in _DTYPES and d % 128 == 0 and n_rows % 8 == 0
            and n_rows >= 8 and fits)


def ln_ffn_residual_reference(x, scale, bias, w1, b1, w2, b2, extra=None):
    """``x [+ extra] + Linear2(relu(Linear1(LN(x))))`` with the rounding
    points of the unfused module path (every op rounds to ``x.dtype``)."""
    xn = layer_norm(x, scale, bias)
    h = torch.relu(xn @ w1.to(x.dtype) + b1.to(x.dtype))
    out = x + (h @ w2.to(x.dtype) + b2.to(x.dtype))
    if extra is not None:
        out = out + extra
    return out


def ln_ffn_residual_plain(x, scale, bias, w1, b1, w2, b2, extra=None):
    """The kernel's function in plain torch, with its rounding points: LN
    and the relu hidden round to ``x.dtype``, products accumulate in f32,
    and the sum ``xf + ((y + b2) + extra)`` rounds once.  Weights are cast
    to ``x.dtype`` as the module path casts them."""
    xn = layer_norm(x, scale, bias)
    h = torch.relu(matmul_f32(xn, w1) + b1.float()).to(x.dtype)
    y = matmul_f32(h, w2) + b2.float()
    if extra is not None:
        y = y + extra.to(x.dtype).float()
    return (x.float() + y).to(x.dtype)


def _splits(T: int, rows: int, device) -> int:
    """Blocks per row tile (split over the hidden dimension): enough to
    give every SM a block when there are few row tiles, at most 8."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = 1
    while splits < 8 and -(-T // rows) * splits * 2 <= sms:
        splits *= 2
    return splits


def _splits_f32(T: int, rows: int, slices: int, device) -> int:
    """f32 rows: the most blocks per row tile (a divisor of the kernel's
    hidden slices, at most 16) that the SMs hold at one block each; 1 once
    the row tiles fill the card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-T // rows)
    return max(s for s in range(1, 17)
               if slices % s == 0 and (s == 1 or tiles * s <= sms))


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ffn")
    fn = lib.gn_ln_ffn_residual
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in ("gn_ln_ffn_residual_rows", "gn_ln_ffn_residual_f32_rows",
                     "gn_ln_ffn_residual_f32_slices"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _check_args(what, x, tensors):
    """Device and layout checks shared by the forward and the backward."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: all inputs must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and "
                             f"16-byte aligned")


def _check_shapes(what, shapes):
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def _launch(x, scale, bias, w1, b1, w2, b2, extra):
    global LAUNCHES
    T, d = x.shape
    if not supports_fused_ffn(T, d, x.dtype):
        raise ValueError(f"ln_ffn_residual: unsupported x {tuple(x.shape)} "
                         f"{x.dtype} (bf16 or f32 rows, the JAX gate's "
                         f"widths and row counts)")
    shapes = {"w1": (w1, (d, 4 * d)), "b1": (b1, (4 * d,)),
              "w2": (w2, (4 * d, d)), "b2": (b2, (d,)),
              "scale": (scale, (d,)), "bias": (bias, (d,))}
    if extra is not None:
        shapes["extra"] = (extra, (T, d))
    _check_shapes("ln_ffn_residual", shapes)
    args = [x, None if extra is None else extra.to(x.dtype), scale.float(),
            bias.float(), w1.to(x.dtype), b1.float(), w2.to(x.dtype),
            b2.float()]
    _check_args("ln_ffn_residual", x, args)
    out = torch.empty_like(x)
    lib = _lib()
    is_f32 = x.dtype == torch.float32
    if is_f32:
        rows = lib.gn_ln_ffn_residual_f32_rows(d)
        splits = _splits_f32(T, rows, lib.gn_ln_ffn_residual_f32_slices(d),
                             x.device)
    else:
        rows = lib.gn_ln_ffn_residual_rows(d)
        splits = _splits(T, rows, x.device)
    partial = counters = None
    if splits > 1:
        partial = torch.empty(splits * T * d, dtype=torch.float32,
                              device=x.device)
        counters = torch.zeros(-(-T // rows), dtype=torch.int32,
                               device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gn_ln_ffn_residual(
            *[None if t is None else t.data_ptr()
              for t in (*args, out, partial, counters)],
            T, d, splits, int(is_f32), stream)
    _build.check(lib, err, "ln_ffn_residual")
    LAUNCHES += 1
    return out


def ln_ffn_backward_plain(x, scale, bias, w1, b1, w2, g):
    """The backward kernel's function in plain torch, with its rounding
    points (``_bwd_kernel``, ``fused_ffn.py:176-230``): LN statistics and
    the hidden activation recomputed from ``x``, the relu mask taken from
    the f32 pre-activation, ``dhp`` rounded to ``x.dtype`` before its two
    products, every product accumulated in f32.

    Returns ``(dx [T, d] in x.dtype, dscale [d], dbias [d], dw1 [d, 4d],
    db1 [4d], dw2 [4d, d], db2 [d])``, all but ``dx`` in f32."""
    xf = x.float()
    d = xf.shape[-1]
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    pos = var > 0
    std = torch.where(pos, torch.where(pos, var, 1.0).sqrt(), 0.0)
    s = std + EPS
    sigma = torch.where(pos, std, 1.0)
    z = (xf - mu) / s
    gamma = scale.float()
    xn = (z * gamma + bias.float()).to(x.dtype)
    hp = matmul_f32(xn, w1) + b1.float()
    h = torch.relu(hp).to(x.dtype)
    gc = g.to(x.dtype)
    gf = gc.float()
    db2 = gf.sum(0)
    dw2 = h.float().t() @ gf
    dh = matmul_f32(gc, w2.t())
    dhp = torch.where(hp > 0, dh, 0.0)
    db1 = dhp.sum(0)
    dhp_c = dhp.to(x.dtype)
    dw1 = xn.float().t() @ dhp_c.float()
    dxn = matmul_f32(dhp_c, w1.t())
    dscale = (dxn * z).sum(0)
    dbias = dxn.sum(0)
    dz = dxn * gamma
    mean_dz = dz.sum(-1, keepdim=True) / d
    mean_dzz = (dz * z).sum(-1, keepdim=True) / d
    mean_z = z.sum(-1, keepdim=True) / d
    dxf = (dz - mean_dz) / s - (z - mean_z) * (mean_dzz / sigma)
    return (dxf + gf).to(x.dtype), dscale, dbias, dw1, db1, dw2, db2


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_ffn_bwd")
    fn = lib.gn_ln_ffn_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gn_ln_ffn_backward_tile_rows.argtypes = [ctypes.c_int]
        lib.gn_ln_ffn_backward_tile_rows.restype = ctypes.c_int
    return lib


def _weight_splits(T: int, tiles: int, sms: int) -> int:
    """Row ranges of the weight pass: the count (at most 16, each range at
    least 256 rows) that finishes the ``tiles`` output tiles in the fewest
    waves of blocks per row, one block an SM."""
    best, best_cost = 1, None
    for s in range(1, 17):
        if s > 1 and T < 256 * s:
            break
        cost = -(-tiles * s // sms) / s
        if best_cost is None or cost < best_cost - 1e-9:
            best, best_cost = s, cost
    return best


def _weight_splits_f32(T: int, tiles: int, sms: int):
    """Row ranges of the f32 weight pass and the rows of each (a multiple
    of 64, at least 256 unless there is one range): at least two blocks an
    SM (``tiles x splits >= 2 x sms``) where T allows, and among those the
    fewest ranges whose blocks fill their waves of two blocks an SM within
    10% of the best split (each range adds a partial product to add)."""
    slots = 2 * sms
    options = {}
    for want in range(1, 65):
        rows = -(-T // (want * 64)) * 64
        splits = -(-T // rows)
        if splits == 1 or rows >= 256:
            options[splits] = rows
    full = [s for s in options if tiles * s >= slots] or list(options)
    cost = lambda s: -(-tiles * s // slots) / s
    best = min(cost(s) for s in full)
    splits = min(s for s in full if cost(s) <= 1.1 * best)
    return splits, options[splits]


def _launch_backward(x, scale, bias, w1, b1, w2, g):
    global BWD_LAUNCHES
    T, d = x.shape
    if not supports_fused_ffn(T, d, x.dtype):
        raise ValueError(f"ln_ffn_backward: unsupported x {tuple(x.shape)} "
                         f"{x.dtype} (bf16 or f32 rows, the JAX gate's "
                         f"widths and row counts)")
    _check_shapes("ln_ffn_backward",
                  {"w1": (w1, (d, 4 * d)), "b1": (b1, (4 * d,)),
                   "w2": (w2, (4 * d, d)), "g": (g, (T, d)),
                   "scale": (scale, (d,)), "bias": (bias, (d,))})
    is_f32 = x.dtype == torch.float32
    w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
    args = [x, g.to(x.dtype), scale.float(), bias.float(), w1c,
            w1c.t().contiguous(), w2c.t().contiguous() if is_f32 else None,
            b1.float(), w2c]
    _check_args("ln_ffn_backward", x, args)
    lib = _bwd_lib()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile = lib.gn_ln_ffn_backward_tile_rows(int(is_f32))
    post_blocks = max(1, min(-(-T // 8), 4 * sms))
    tiles = 2 * (4 * d // tile) * (d // tile)
    if is_f32:
        splits, rows_per_split = _weight_splits_f32(T, tiles, sms)
    else:
        splits = _weight_splits(T, tiles, sms)
        rows_per_split = -(-T // (splits * 64)) * 64
        splits = -(-T // rows_per_split)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    outs = [torch.empty(d, **f32), torch.empty(d, **f32),
            torch.empty(d, 4 * d, **f32), torch.empty(4 * d, **f32),
            torch.empty(4 * d, d, **f32), torch.empty(d, **f32)]
    scratch = [torch.empty_like(x), torch.empty(T, 3, **f32),
               torch.empty(T, 4 * d, dtype=x.dtype, device=x.device),
               torch.empty(T, 4 * d, dtype=x.dtype, device=x.device),
               torch.empty(T, d, **f32),
               torch.empty(-(-T // tile), 4 * d, **f32),
               torch.empty(3, post_blocks, d, **f32),
               torch.empty(splits, d, 4 * d, **f32),
               torch.empty(splits, 4 * d, d, **f32)]
    with torch.cuda.device(x.device):
        err = lib.gn_ln_ffn_backward(
            *[None if t is None else t.data_ptr()
              for t in (*args, dx, *outs, *scratch)],
            T, d, int(is_f32), post_blocks, splits, rows_per_split,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "ln_ffn_backward")
    BWD_LAUNCHES += 1
    return (dx, *outs)


def ln_ffn_backward(x, scale, bias, w1, b1, w2, g):
    """Gradients of ``ln_ffn_residual`` (without ``extra``) for the
    cotangent ``g [T, d]``: ``(dx, dscale, dbias, dw1, db1, dw2, db2)``,
    ``dx`` in ``x.dtype`` and the rest in f32."""
    if x.device.type == "cpu":
        return ln_ffn_backward_plain(x, scale, bias, w1, b1, w2, g)
    return _launch_backward(x, scale, bias, w1, b1, w2, g)


class _LnFfnResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, extra):
        # ``extra`` is not saved: only its type rides along.
        ctx.save_for_backward(x, scale, bias, w1, b1, w2)
        ctx.meta = (b2.dtype, None if extra is None else extra.dtype)
        if x.device.type == "cpu":
            return ln_ffn_residual_plain(x, scale, bias, w1, b1, w2, b2,
                                         extra)
        return _launch(x, scale, bias, w1, b1, w2, b2, extra)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w1, b1, w2 = ctx.saved_tensors
        b2_dtype, extra_dtype = ctx.meta
        d_extra = None if extra_dtype is None else g.to(extra_dtype)
        dx, ds, db, dw1, db1, dw2, db2 = ln_ffn_backward(
            x, scale, bias, w1, b1, w2, g.contiguous())
        return (dx, ds.to(scale.dtype), db.to(bias.dtype), dw1.to(w1.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2_dtype),
                d_extra)


def ln_ffn_residual(x, scale, bias, w1, b1, w2, b2,
                    extra: Optional[torch.Tensor] = None):
    """``x [+ extra] + FF(LN(x))`` in one pass per row tile, differentiable
    in every tensor argument.  The output is a new tensor; ``extra`` is
    only read."""
    return _LnFfnResidual.apply(x, scale, bias, w1, b1, w2, b2, extra)
