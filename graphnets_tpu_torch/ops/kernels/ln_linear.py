"""Backward of ``bf16(LayerNorm(x)) @ w`` (counterpart of ``_backward`` in
``graphnets_tpu/ops/pallas/ln_linear.py``): dx, dscale, dbias and dW.

Kernel: ``csrc/ln_linear_bwd.cu``.  It replaces the Pallas kernel
``_bwd_kernel`` (``ln_linear.py:165-246``), with its arithmetic: the LN
statistics are recomputed from ``x``, and the Flux std convention and the
var == 0 guard hold.  On the H100 it is bound by memory (~38.6 MB for
9.7 GFLOP at T = 16384, d = dout = 384, ~11.5 us).  The TPU kernel carried
dW, dscale and dbias across its sequential grid; here a row pass writes
dx and per-block column sums, a split-K pass computes partial dW tiles on
the tensor cores, and a last pass adds the partials in a fixed order (no
atomics).  One call of :func:`ln_linear_backward` runs the three passes
and counts as one launch.  The source note in the ``.cu`` file has the
details.

:func:`ln_linear_backward` takes ``ops.ln_linear.ln_linear_backward_plain``
for CPU tensors only; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ln_linear import ln_linear_backward_plain
from . import _build

__all__ = ["ln_linear_backward", "supports_ln_linear_backward", "LAUNCHES"]

LAUNCHES = 0            # kernel launches, for proving the path was taken
_DIMS = (128, 256, 384)
_SMEM_LIMIT = 232448    # dynamic shared memory a block may use on Hopper
_ROWS = 32              # rows per block of the row pass


def _smem_bytes(d: int, dout: int) -> int:
    """Shared memory of a row-pass block, as ``rows_smem_bytes``: x and g
    rows, the W ring (two 32-column slices) or the f32 dxn rows, and the
    row statistics."""
    ring = max(2 * d * 40 * 2, _ROWS * (d + 4) * 4)
    return _ROWS * ((d + 8) * 2 + (dout + 8) * 2 + 3 * 4) + ring


def supports_ln_linear_backward(n_rows: int, d: int, dout: int,
                                dtype: torch.dtype) -> bool:
    """Shapes the kernel takes: bf16 rows, ``d`` in 128 / 256 / 384,
    ``dout`` a multiple of 128 whose g rows fit in shared memory."""
    return (dtype == torch.bfloat16 and d in _DIMS and n_rows >= 1
            and dout >= 128 and dout % 128 == 0
            and _smem_bytes(d, dout) <= _SMEM_LIMIT)


def _rows_per_split(T: int, d: int, dout: int, device) -> int:
    """Rows per block of the split-K dW pass: about two blocks an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = (d // 128) * (dout // 128)
    splits = max(1, min(-(-2 * sms // tiles), -(-T // _ROWS)))
    return -(-T // (splits * _ROWS)) * _ROWS


def _lib() -> ctypes.CDLL:
    lib = _build.load("ln_linear_bwd")
    fn = lib.gn_ln_linear_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, scale, bias, w, g):
    global LAUNCHES
    T, d = x.shape
    dout = w.shape[1]
    if not supports_ln_linear_backward(T, d, dout, x.dtype):
        raise ValueError(f"ln_linear_backward: unsupported x "
                         f"{tuple(x.shape)} {x.dtype}, dout={dout} (bf16, d "
                         f"in {_DIMS}, dout % 128 == 0)")
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
    rows_per_split = _rows_per_split(T, d, dout, x.device)
    splits = -(-T // rows_per_split)
    blocks = -(-T // _ROWS)
    dx = torch.empty_like(x)
    dw = torch.empty(d, dout, **f32)
    ds = torch.empty(d, **f32)
    db = torch.empty(d, **f32)
    scratch = [torch.empty(T, 2, **f32), torch.empty(splits, d, dout, **f32),
               torch.empty(blocks, d, **f32), torch.empty(blocks, d, **f32)]
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.gn_ln_linear_backward(
            *[t.data_ptr() for t in (*args, dx, dw, ds, db, *scratch)],
            T, d, dout, rows_per_split,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "ln_linear_backward")
    LAUNCHES += 1
    return dx, ds, db, dw


def ln_linear_backward(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Gradients of ``bf16(LayerNorm(x; scale, bias)) @ w`` for the
    cotangent ``g [T, dout]``: ``(dx [T, d] in x.dtype, dscale [d],
    dbias [d], dw [d, dout])``, the last three in f32."""
    if x.device.type == "cpu":
        return ln_linear_backward_plain(x, scale, bias, w, g)
    return _launch(x, scale, bias, w, g)
