"""Fused LayerNorm -> FeedForward -> residual, forward (counterpart of
``graphnets_tpu/ops/pallas/fused_ffn.py``).

    y = bf16( xf + ((bf16(relu(bf16(LN(x)) @ W1 + b1)) @ W2 + b2)
                    + f32(extra)) )

Kernel: ``csrc/fused_ffn.cu``.  It replaces the Pallas forward kernel of
``ln_ffn_residual`` (``fused_ffn.py:79-97,130-170``).  On the H100 it is
bound by the tensor cores (38.7 GFLOP against ~40 MB at T = 16384,
d = 384), so it keeps the ``[rows, 4d]`` hidden activation on the SM and
streams the hidden dimension in slices into an f32 accumulator held in
registers.  The source note in the ``.cu`` file has the details.

:func:`ln_ffn_residual` takes :func:`ln_ffn_residual_plain` for CPU tensors
only; a CUDA tensor launches the kernel or raises.
:func:`ln_ffn_residual_reference` is the unfused module composition, with
its own rounding points, for shapes the kernel does not take.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...nn.core import layer_norm
from ..ln_linear import matmul_f32
from . import _build

__all__ = ["ln_ffn_residual", "ln_ffn_residual_plain",
           "ln_ffn_residual_reference", "supports_fused_ffn", "LAUNCHES"]

LAUNCHES = 0                    # kernel launches, for proving the path
_DIMS = (128, 256, 384)         # feature dims the kernel is built for
_ROWS = 64                      # rows per block


def supports_fused_ffn(n_rows: int, d: int,
                       dtype: torch.dtype = torch.bfloat16) -> bool:
    """Shapes the kernel takes: bf16 rows, any row count >= 1 (the ragged
    row tile is masked), ``d`` in 128 / 256 / 384 (at 512 a block's
    operands outgrow shared memory)."""
    return dtype == torch.bfloat16 and d in _DIMS and n_rows >= 1


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


def _splits(T: int, device) -> int:
    """Blocks per 64-row tile (split over the hidden dimension): enough to
    give every SM a block when there are few row tiles, at most 8."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = 1
    while splits < 8 and -(-T // _ROWS) * splits * 2 <= sms:
        splits *= 2
    return splits


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ffn")
    fn = lib.gn_ln_ffn_residual
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, scale, bias, w1, b1, w2, b2, extra):
    global LAUNCHES
    T, d = x.shape
    if not supports_fused_ffn(T, d, x.dtype):
        raise ValueError(f"ln_ffn_residual: unsupported x {tuple(x.shape)} "
                         f"{x.dtype} (bf16, d in {_DIMS})")
    shapes = {"w1": (w1, (d, 4 * d)), "b1": (b1, (4 * d,)),
              "w2": (w2, (4 * d, d)), "b2": (b2, (d,)),
              "scale": (scale, (d,)), "bias": (bias, (d,))}
    if extra is not None:
        shapes["extra"] = (extra, (T, d))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ln_ffn_residual: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    args = [x, None if extra is None else extra.to(x.dtype), scale.float(),
            bias.float(), w1.to(x.dtype), b1.float(), w2.to(x.dtype),
            b2.float()]
    for t in args:
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ln_ffn_residual: all inputs must be on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("ln_ffn_residual: inputs must be contiguous")
    out = torch.empty_like(x)
    splits = _splits(T, x.device)
    partial = counters = None
    if splits > 1:
        partial = torch.empty(splits * T * d, dtype=torch.float32,
                              device=x.device)
        counters = torch.zeros(-(-T // _ROWS), dtype=torch.int32,
                               device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gn_ln_ffn_residual(
            *[None if t is None else t.data_ptr()
              for t in (*args, out, partial, counters)],
            T, d, splits, stream)
    _build.check(lib, err, "ln_ffn_residual")
    LAUNCHES += 1
    return out


def ln_ffn_residual(x, scale, bias, w1, b1, w2, b2,
                    extra: Optional[torch.Tensor] = None):
    """``x [+ extra] + FF(LN(x))`` in one pass per row tile.  The output is
    a new tensor; ``extra`` is only read."""
    if x.device.type == "cpu":
        return ln_ffn_residual_plain(x, scale, bias, w1, b1, w2, b2, extra)
    return _launch(x, scale, bias, w1, b1, w2, b2, extra)
