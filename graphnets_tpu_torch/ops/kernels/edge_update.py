"""Fused edge update with the edge->node sum, for uniform slot layouts
(counterpart of ``graphnets_tpu/ops/pallas/edge_update.py``).

    h   = bf16( f32(LN(ef)·bf16 @ W0) + ts[senders] + tr[receivers]
                + tg[edge_graph] + b )
    agg = f32 sum of the rounded h over edges, by receiver

Kernel: ``csrc/edge_update.cu``.  It replaces the Pallas kernel
``fused_edge_update_agg`` (``edge_update.py:122-245,328-361``).  On the H100
it is bound by memory (~30 MB for 4.8 GFLOP at E = 16384, de = dout = 384),
so it reads every row once, reads the f32 partial rows directly instead of
the TPU's one-hot gathers, and sums edges into nodes with no atomics: a
block owns whole receiver segments (receivers ascend) and writes each agg
row once.  The source note in the ``.cu`` file has the details.

:func:`fused_edge_update_agg` takes :func:`fused_edge_update_agg_plain` for
CPU tensors only; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...nn.core import layer_norm
from ..ln_linear import matmul_f32
from . import _build

__all__ = ["fused_edge_update_agg", "fused_edge_update_agg_plain",
           "supports_fused_edge_update", "LAUNCHES"]

LAUNCHES = 0            # kernel launches, for proving the path was taken
_SMEM_LIMIT = 232448    # dynamic shared memory a block may use on Hopper
_EDGES_PER_BLOCK = 128  # target edge rows per block (whole receivers)


def _smem_bytes(de: int) -> int:
    """Shared memory of one block, as ``gn_edge_update_agg_smem``."""
    return de * 136 * 2 + 64 * (de + 8) * 2 + 64 * 132 * 4 + 130 * 4


def supports_fused_edge_update(E: int, N: int, G: int, de: int, dout: int,
                               n_slots: int, e_slots: int,
                               dtype: torch.dtype) -> bool:
    """Shapes the kernel takes: bf16 edges on a uniform layout of G >= 2
    graphs, feature dims multiples of 128, and the block's W0 tile plus one
    64-row chunk within shared memory (de <= 384)."""
    if dtype != torch.bfloat16:
        return False
    if G < 2 or N != G * n_slots or E != G * e_slots:
        return False
    if de < 128 or dout < 128 or de % 128 or dout % 128:
        return False
    return _smem_bytes(de) <= _SMEM_LIMIT


def fused_edge_update_agg_plain(ef, scale, bias, w0, ts, tr, tg, b,
                                senders, receivers, e_slots: int,
                                use_ln: bool = True):
    """The kernel's function in plain torch, with its rounding points: the
    LN output rounds to ``ef.dtype`` before the product, the partials add
    in f32 in the kernel's order, ``h`` rounds once, and ``agg`` sums the
    rounded ``h`` in f32."""
    E = ef.shape[0]
    xn = layer_norm(ef, scale, bias) if use_ln else ef
    acc = matmul_f32(xn, w0)
    edge_graph = torch.arange(E, device=ef.device) // e_slots
    acc = acc + ts.float().index_select(0, senders)
    acc = acc + tr.float().index_select(0, receivers)
    acc = acc + tg.float().index_select(0, edge_graph)
    h = (acc + b.float()).to(ef.dtype)
    agg = torch.zeros(ts.shape[0], h.shape[1], dtype=torch.float32,
                      device=ef.device)
    agg.index_add_(0, receivers, h.float())
    return h, agg


def _lib() -> ctypes.CDLL:
    lib = _build.load("edge_update")
    fn = lib.gn_edge_update_agg
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(ef, scale, bias, w0, ts, tr, tg, b, senders, receivers,
            e_slots: int, use_ln: bool):
    global LAUNCHES
    E, de = ef.shape
    N, dout = ts.shape
    G = tg.shape[0]
    if ef.dtype != torch.bfloat16:
        raise TypeError(f"fused_edge_update_agg: ef must be bfloat16, got "
                        f"{ef.dtype}")
    if not supports_fused_edge_update(E, N, G, de, dout, N // G, e_slots,
                                      ef.dtype):
        raise ValueError(f"fused_edge_update_agg: unsupported shape E={E} "
                         f"N={N} G={G} de={de} dout={dout}")
    expect = {"w0": (w0, (de, dout)), "ts": (ts, (N, dout)),
              "tr": (tr, (N, dout)), "tg": (tg, (G, dout)),
              "senders": (senders, (E,)), "receivers": (receivers, (E,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_edge_update_agg: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    for name, t in (("ts", ts), ("tr", tr), ("tg", tg)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_edge_update_agg: {name} must be float32")
    for name, t in (("senders", senders), ("receivers", receivers)):
        if t.dtype != torch.int32:
            raise TypeError(f"fused_edge_update_agg: {name} must be int32")
    args = [ef, w0.to(torch.bfloat16), ts, tr, tg, b.float(),
            scale.float(), bias.float(), senders, receivers]
    for t in args:
        if not t.is_cuda or t.device != ef.device:
            raise ValueError("fused_edge_update_agg: all inputs must be on "
                             f"{ef.device}")
        if not t.is_contiguous():
            raise ValueError("fused_edge_update_agg: inputs must be "
                             "contiguous")
    h = torch.empty(E, dout, dtype=torch.bfloat16, device=ef.device)
    agg = torch.empty(N, dout, dtype=torch.float32, device=ef.device)
    nodes_per_block = max(1, _EDGES_PER_BLOCK * N // E)
    lib = _lib()
    with torch.cuda.device(ef.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gn_edge_update_agg(
            *[t.data_ptr() for t in args], h.data_ptr(), agg.data_ptr(),
            E, N, de, dout, e_slots, nodes_per_block, int(use_ln), stream)
    _build.check(lib, err, "fused_edge_update_agg")
    LAUNCHES += 1
    return h, agg


def fused_edge_update_agg(ef, ln_params: Optional[dict], w0, ts, tr, tg, b,
                          senders, receivers, n_slots: int, e_slots: int):
    """One-pass edge update plus edge->node sum on a uniform layout.

    ``ts``/``tr``/``tg``: f32 partials ``nf @ W1``, ``nf @ W2``,
    ``gf @ W3``.  ``ln_params``: optional ``{"scale", "bias"}`` to
    LayerNorm ``ef`` before its product.  Returns ``h [E, dout]`` in
    ``ef.dtype`` and ``agg [N, dout]`` in f32.  Receivers must ascend (the
    canonical edge order); ``n_slots`` is implied by ``N // G`` and kept
    for the JAX signature.
    """
    use_ln = ln_params is not None
    de, dout = ef.shape[1], w0.shape[1]
    scale = ln_params["scale"] if use_ln else torch.ones(de, device=ef.device)
    bias = ln_params["bias"] if use_ln else torch.zeros(de, device=ef.device)
    if b is None:
        b = torch.zeros(dout, device=ef.device)
    if ef.device.type == "cpu":
        return fused_edge_update_agg_plain(ef, scale, bias, w0, ts, tr, tg, b,
                                           senders, receivers, e_slots,
                                           use_ln)
    return _launch(ef, scale, bias, w0, ts, tr, tg, b, senders, receivers,
                   e_slots, use_ln)
