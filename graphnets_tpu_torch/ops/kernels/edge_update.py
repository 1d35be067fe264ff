"""Fused edge update, with or without the edge->node sum, for uniform
slot layouts (counterpart of ``graphnets_tpu/ops/pallas/edge_update.py``).

    h   = bf16( f32(LN(ef)·bf16 @ W0) + ts[senders] + tr[receivers]
                + tg[edge_graph] + b )
    agg = f32 sum of the rounded h over edges, by receiver

Kernel: ``csrc/edge_update.cu`` on the wgmma + TMA core of
``csrc/edge_wgmma.cuh``.  It replaces the Pallas kernel of
``fused_edge_update_agg`` and ``fused_edge_update``
(``edge_update.py:122-245,308-361``); the second writes h alone.  On the
H100 it is bound by memory (~30 MB for 4.8 GFLOP at E = 16384,
de = dout = 384), so it reads every row once and normalises it once for all
output columns, streams W0 in k-chunks (shared memory does not depend on
de), reads the f32 partial rows directly instead of the TPU's one-hot
gathers, and sums edges into nodes with no atomics: each 64-row tile sums
its own rows by receiver (receivers ascend) and a second pass completes the
nodes that cross a tile boundary, in tile order.  The source notes in the
``.cu`` / ``.cuh`` files have the details.

:func:`supports_fused_edge_update` is the JAX package's gate
(``edge_update.py:80-111``), term for term: its tile choice, its VMEM
budget and the ``with_agg`` term decide which shapes take the kernel in
both packages.  The CUDA kernel itself serves every width the gate admits.

:func:`fused_edge_update` is differentiable: its backward composes the
port's other kernels as ``edge_update.py:262-302`` does (the LN->matmul
backward, the windowed sum for the senders, the sorted sum for the
receivers, and a reshape-sum for ``tg`` and ``b``).
:func:`fused_edge_update_agg` is differentiable too, through both outputs:
its backward adds the sorted gather of ``agg``'s cotangent to ``h``'s at
the composed path's rounding point and then takes the same backward
(``edge_update.py:264-275``).  Both take their plain versions for CPU
tensors only; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...nn.core import layer_norm
from ..ln_linear import matmul_f32
from . import _build
from .gather import _gather
from .ln_linear import ln_linear_backward
from .segment_sum import sorted_segment_sum, windowed_segment_sum

__all__ = ["fused_edge_update", "fused_edge_update_plain",
           "fused_edge_update_agg", "fused_edge_update_agg_plain",
           "supports_fused_edge_update", "LAUNCHES", "LAUNCHES_NO_AGG"]

LAUNCHES = 0            # fused_edge_update_agg launches, for the path proof
LAUNCHES_NO_AGG = 0     # fused_edge_update launches
_VMEM_BUDGET = 12 << 20


def _pick_k(G: int, n_slots: int, e_slots: int) -> Optional[int]:
    """The JAX kernel's tile choice (``edge_update.py:80-92``): edge tile
    ``k * e_slots`` rows, node window ``k * n_slots`` rows; the first
    divisor ``k`` of G whose tile reaches 512 rows, else the largest that
    tiles at all."""
    best = None
    for k in range(1, G + 1):
        if G % k:
            continue
        te, nw = k * e_slots, k * n_slots
        if te % 128 or nw % 8 or nw > 2048 or te > 8192:
            continue
        if te >= 512:
            return k
        best = k
    return best


def supports_fused_edge_update(E: int, N: int, G: int, de: int, dout: int,
                               n_slots: int, e_slots: int,
                               dtype: torch.dtype,
                               with_agg: bool = False) -> bool:
    """The JAX package's gate (``edge_update.py:95-111``): bf16 edges on a
    uniform layout of G >= 2 graphs, feature dims multiples of 128, a tile
    from :func:`_pick_k`, and the TPU kernel's VMEM use within its 12 MiB
    budget (``with_agg`` adds the f32 sum's double-buffered tile).  The
    budget is a route rule here: it keeps both packages on the same route
    and rounding points."""
    if dtype != torch.bfloat16:
        return False
    if G < 2 or N != G * n_slots or E != G * e_slots:
        return False
    if de < 128 or dout < 128 or de % 128 or dout % 128:
        return False
    k = _pick_k(G, n_slots, e_slots)
    if k is None:
        return False
    te, nw = k * e_slots, k * n_slots
    vmem = (te * (de + dout) * 2 + de * dout * 2 + 4 * nw * dout * 2
            + te * dout * 4 + te * de * 4 + 2 * nw * te * 2)
    if with_agg:
        vmem += 2 * nw * dout * 4
    return vmem <= _VMEM_BUDGET


def fused_edge_update_plain(ef, scale, bias, w0, ts, tr, tg, b, senders,
                            receivers, e_slots: int, use_ln: bool = True):
    """The kernel's ``h`` in plain torch, with its rounding points: the LN
    output rounds to ``ef.dtype`` before the product, the partials add in
    f32 in the kernel's order, and ``h`` rounds once."""
    E = ef.shape[0]
    xn = layer_norm(ef, scale, bias) if use_ln else ef
    acc = matmul_f32(xn, w0)
    edge_graph = torch.arange(E, device=ef.device) // e_slots
    acc = acc + ts.float().index_select(0, senders)
    acc = acc + tr.float().index_select(0, receivers)
    acc = acc + tg.float().index_select(0, edge_graph)
    return (acc + b.float()).to(ef.dtype)


def fused_edge_update_agg_plain(ef, scale, bias, w0, ts, tr, tg, b,
                                senders, receivers, e_slots: int,
                                use_ln: bool = True):
    """:func:`fused_edge_update_plain` and ``agg``, the f32 sum of the
    rounded ``h`` by receiver."""
    h = fused_edge_update_plain(ef, scale, bias, w0, ts, tr, tg, b, senders,
                                receivers, e_slots, use_ln)
    agg = torch.zeros(ts.shape[0], h.shape[1], dtype=torch.float32,
                      device=ef.device)
    agg.index_add_(0, receivers, h.float())
    return h, agg


def _lib() -> ctypes.CDLL:
    lib = _build.load("edge_update")
    fn = lib.gn_edge_update
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gn_edge_update_tile_rows.restype = ctypes.c_int
    return lib


def _launch(ef, scale, bias, w0, ts, tr, tg, b, senders, receivers,
            e_slots: int, use_ln: bool, with_agg: bool):
    global LAUNCHES, LAUNCHES_NO_AGG
    E, de = ef.shape
    N, dout = ts.shape
    G = tg.shape[0]
    if ef.dtype != torch.bfloat16:
        raise TypeError(f"fused_edge_update: ef must be bfloat16, got "
                        f"{ef.dtype}")
    if not supports_fused_edge_update(E, N, G, de, dout, N // G, e_slots,
                                      ef.dtype, with_agg=with_agg):
        raise ValueError(f"fused_edge_update: unsupported shape E={E} "
                         f"N={N} G={G} de={de} dout={dout} "
                         f"with_agg={with_agg}")
    expect = {"w0": (w0, (de, dout)), "ts": (ts, (N, dout)),
              "tr": (tr, (N, dout)), "tg": (tg, (G, dout)),
              "senders": (senders, (E,)), "receivers": (receivers, (E,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_edge_update: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    for name, t in (("ts", ts), ("tr", tr), ("tg", tg)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_edge_update: {name} must be float32")
    for name, t in (("senders", senders), ("receivers", receivers)):
        if t.dtype != torch.int32:
            raise TypeError(f"fused_edge_update: {name} must be int32")
    args = [ef, w0.to(torch.bfloat16), ts, tr, tg, b.float(),
            scale.float(), bias.float(), senders, receivers]
    for t in args:
        if not t.is_cuda or t.device != ef.device:
            raise ValueError("fused_edge_update: all inputs must be on "
                             f"{ef.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_edge_update: inputs must be "
                             "contiguous and 16-byte aligned")
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=ef.device)
    h = torch.empty(E, dout, dtype=torch.bfloat16, device=ef.device)
    agg = first = last = None
    if with_agg:
        tiles = -(-E // lib.gn_edge_update_tile_rows())
        agg = torch.zeros(N, dout, **f32)
        first, last = torch.empty(tiles, dout, **f32), \
            torch.empty(tiles, dout, **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(ef.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gn_edge_update(
            *[t.data_ptr() for t in args], h.data_ptr(), ptr(agg),
            ptr(first), ptr(last), E, N, de, dout, e_slots, int(use_ln),
            stream)
    _build.check(lib, err, "fused_edge_update")
    if with_agg:
        LAUNCHES += 1
        return h, agg
    LAUNCHES_NO_AGG += 1
    return h


def _defaults(ef, ln_params, ts, b):
    """``(use_ln, scale, bias, b)`` with identity LN and zero bias where
    absent."""
    use_ln = ln_params is not None
    de, dout = ef.shape[1], ts.shape[1]
    scale = ln_params["scale"] if use_ln else torch.ones(de, device=ef.device)
    bias = ln_params["bias"] if use_ln else torch.zeros(de, device=ef.device)
    if b is None:
        b = torch.zeros(dout, device=ef.device)
    return use_ln, scale, bias, b


def _save(ctx, ef, scale, bias, w0, tg, senders, receivers, n_slots,
          e_slots, use_ln):
    ctx.save_for_backward(ef, scale, bias, w0, senders, receivers)
    ctx.layout = (n_slots, e_slots, use_ln, tg.shape[0])


def _backward(ctx, g):
    """The gradients of both fused edge updates given ``h``'s cotangent
    ``g`` (``edge_update.py:276-302``): the LN->matmul backward, the
    argsort-free scatters and the column sums."""
    ef, scale, bias, w0, senders, receivers = ctx.saved_tensors
    n_slots, e_slots, use_ln, G = ctx.layout
    g = g.contiguous()
    if use_ln:
        d_ef, ds, db_ln, dw0 = ln_linear_backward(ef, scale, bias, w0, g)
    else:
        gc = g.to(ef.dtype)
        d_ef = matmul_f32(gc, w0.t()).to(ef.dtype)
        dw0 = matmul_f32(ef.t(), gc)
        ds, db_ln = torch.zeros_like(scale), torch.zeros_like(bias)
    # The argsort-free scatters of edge_update.py:292-300.
    N = n_slots * G
    gi = torch.arange(G + 1, dtype=torch.int32, device=g.device)
    d_ts = windowed_segment_sum(g, senders, N, gi * n_slots,
                                gi * e_slots).float()
    d_tr = sorted_segment_sum(g, receivers, N).float()
    gf = g.float()
    d_tg = gf.view(G, e_slots, -1).sum(1)
    d_b = gf.sum(0)
    return (d_ef, ds.to(scale.dtype), db_ln.to(bias.dtype),
            dw0.to(w0.dtype), d_ts, d_tr, d_tg, d_b, None, None, None,
            None, None)


class _FusedEdgeUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ef, scale, bias, w0, ts, tr, tg, b, senders, receivers,
                n_slots, e_slots, use_ln):
        _save(ctx, ef, scale, bias, w0, tg, senders, receivers, n_slots,
              e_slots, use_ln)
        if ef.device.type == "cpu":
            return fused_edge_update_plain(ef, scale, bias, w0, ts, tr, tg, b,
                                           senders, receivers, e_slots,
                                           use_ln)
        return _launch(ef, scale, bias, w0, ts, tr, tg, b, senders,
                       receivers, e_slots, use_ln, with_agg=False)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g)


class _FusedEdgeUpdateAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ef, scale, bias, w0, ts, tr, tg, b, senders, receivers,
                n_slots, e_slots, use_ln):
        _save(ctx, ef, scale, bias, w0, tg, senders, receivers, n_slots,
              e_slots, use_ln)
        if ef.device.type == "cpu":
            return fused_edge_update_agg_plain(ef, scale, bias, w0, ts, tr,
                                               tg, b, senders, receivers,
                                               e_slots, use_ln)
        return _launch(ef, scale, bias, w0, ts, tr, tg, b, senders,
                       receivers, e_slots, use_ln, with_agg=True)

    @staticmethod
    def backward(ctx, g, g_agg):
        # agg sums the rounded h by receiver: its pullback is the sorted
        # gather, added at the composed path's rounding point in g's type
        # (edge_update.py:264-275).
        receivers = ctx.saved_tensors[5]
        gathered = _gather(g_agg.to(g.dtype).contiguous(), receivers)
        g = (g.float() + gathered.float()).to(g.dtype)
        return _backward(ctx, g)


def fused_edge_update(ef, ln_params: Optional[dict], w0, ts, tr, tg, b,
                      senders, receivers, n_slots: int, e_slots: int):
    """One-pass edge update on a uniform layout, differentiable (the
    training route).  Arguments and ``h`` as in
    :func:`fused_edge_update_agg`; receivers must ascend."""
    use_ln, scale, bias, b = _defaults(ef, ln_params, ts, b)
    return _FusedEdgeUpdate.apply(ef, scale.float(), bias.float(), w0, ts,
                                  tr, tg, b.float(), senders, receivers,
                                  n_slots, e_slots, use_ln)


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
    use_ln, scale, bias, b = _defaults(ef, ln_params, ts, b)
    return _FusedEdgeUpdateAgg.apply(ef, scale.float(), bias.float(), w0, ts,
                                     tr, tg, b.float(), senders, receivers,
                                     n_slots, e_slots, use_ln)
