"""Single-graph (G = 1) edge update in one pass (counterpart of
``graphnets_tpu/ops/pallas/edge_update_g1.py``).

    h[e]   = ef.dtype( ((f32(src[e]) + gb) + f32(tr[rl[e]]))
                       + [LN](ef[e]) @ W0 )
    agg[n] = f32 sum of the rounded h[e] over the edges with rl[e] == n

Kernel: ``csrc/edge_update_g1.cu``; bf16 rows on the wgmma + TMA core
of ``csrc/edge_wgmma.cuh``, f32 rows (the JAX package's default
precision, bound by f32 operations: 2.05 ms at the shape below) on the
register-blocked CUDA-core tile of ``csrc/f32_tile.cuh``, 64 rows across
256 output columns (:func:`g1_f32_plan`).  It replaces the Pallas kernel of
``fused_g1_edge_update`` and ``fused_g1_edge_update_agg``
(``edge_update_g1.py:119-358``).  On the H100 it is bound by memory (about
1.7 GB at E = 1,048,576, N = 65,536, 256 -> 256 in bf16, ~0.5 ms), so ef,
src and h stream once, every row is normalised once for all output
columns, W0 stays in shared memory where it fits, the normalised rows and
the f32 partial sum stay on the SM, and the receiver rows of ``tr`` are
read directly (ascending ``rl`` keeps a tile's window in L2).  The
edge->node sum is taken per tile for the nodes wholly inside it and through
two partial rows per tile for the nodes on its boundaries, which a second
small kernel adds in tile order: no atomics.  The source notes in the
``.cu`` / ``.cuh`` files have the details.

As the JAX package donates ``src`` to ``h`` when their types match
(``edge_update_g1.py:296-301``), ``GNBlock`` passes ``src_is_dead=True``
for its own dead sender term: ``h`` is then written over ``src`` (the
``autograd.Function`` marks it dirty and returns it).  A call without the
keyword writes a fresh buffer and leaves its arguments untouched.

:func:`supports_g1_edge_update` is the JAX package's gate, term for term
(``edge_update_g1.py:64-107``), so both packages route the same shapes; the
CUDA kernel's shared memory does not depend on the widths and adds no term.
A shape outside the gate takes the composed reference on any device, as in
the JAX package.

Both entry points are differentiable.  The backward composes the port's
kernels as ``edge_update_g1.py:398-481`` does: ``ln_linear_backward`` for
d ef / d scale / d bias / d W0 (the plain product pair without the LN),
``sorted_segment_sum`` for d tr, the cotangent itself for d src, an f32 row
sum for d gb; the agg variant first rounds the agg cotangent to
``ef.dtype``, gathers it back to the edges with ``sorted_gather`` and adds
it to the cotangent of ``h`` in f32 with one rounding.  They take their
plain versions for CPU tensors only; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ln_linear import (ln_linear_backward_plain, ln_matmul_reference,
                         matmul_f32)
from . import _build
from .gather import _pick, _pick_tn, sorted_gather
from .ln_linear import ln_linear_backward, supports_ln_matmul
from .segment_sum import sorted_segment_sum

__all__ = ["fused_g1_edge_update", "fused_g1_edge_update_agg",
           "supports_g1_edge_update", "g1_edge_update_plain",
           "g1_edge_update_agg_plain", "g1_f32_plan", "LAUNCHES",
           "LAUNCHES_NO_AGG"]

LAUNCHES = 0          # launches with the edge->node sum
LAUNCHES_NO_AGG = 0   # launches that write h alone
_VMEM_BUDGET = 12 << 20
_DTYPES = (torch.bfloat16, torch.float32)
_F32_ROWS = 64        # rows of an f32 tile (and of a partial row of agg)


def _tiles(num_edges: int, num_nodes: int):
    """The JAX kernel's tile choice (``edge_update_g1.py:64-75``); only the
    gate reads it."""
    te = (_pick(num_edges, (2048, 1024, 512, 256, 128))
          if num_edges > 262144 else _pick(num_edges, (512, 256, 128)))
    if te is None:
        return None, None
    return te, min(_pick_tn(num_nodes, num_edges, te), 128)


def supports_g1_edge_update(num_edges: int, num_nodes: int, de: int,
                            dout: int, itemsize: int = 2,
                            with_agg: bool = False,
                            part_itemsize: Optional[int] = None) -> bool:
    """The JAX package's gate.  ``itemsize`` is that of ef and h,
    ``part_itemsize`` that of the src / tr partials (``itemsize`` when not
    given)."""
    if part_itemsize is None:
        part_itemsize = itemsize
    te, tn = _tiles(num_edges, num_nodes)
    if (te is None or de % 128 != 0 or dout % 128 != 0
            or num_nodes % 32 != 0 or num_nodes < 32):
        return False
    if with_agg and num_nodes % tn != 0:
        return False
    vmem = (te * de * itemsize               # ef tile
            + te * dout * part_itemsize      # src tile
            + 2 * tn * dout * part_itemsize  # double-buffered tr chunks
            + te * dout * 4                  # f32 accumulator
            + te * dout * itemsize           # out tile
            + de * dout * itemsize           # W0
            + 2 * de * 4 + dout * 4)         # scale/bias/gb rows
    if with_agg:
        vmem += 2 * tn * dout * 4            # double-buffered agg chunks
    return vmem <= _VMEM_BUDGET


def g1_f32_plan(num_edges: int, dout: int):
    """``(tile_rows, col_block, tiles)`` of the f32 rows: tiles of 64 rows
    across 256 output columns where 256 divide ``dout``, else 128; one
    partial row of the edge->node sum a tile (``part_first`` /
    ``part_last`` are ``[tiles, dout]``)."""
    cols = 256 if dout % 256 == 0 else 128
    return _F32_ROWS, cols, -(-num_edges // _F32_ROWS)


def g1_edge_update_plain(ef, scale, bias, w0, src, tr, rl, gb,
                         has_ln: bool = True) -> torch.Tensor:
    """The kernel's ``h`` in plain torch, with its rounding points
    (``_reference``, ``edge_update_g1.py:361-375``)."""
    if has_ln:
        part = ln_matmul_reference(ef, scale, bias, w0)
    else:
        part = matmul_f32(ef, w0)
    acc = ((src.float() + gb.float())
           + tr.index_select(0, rl.long()).float()) + part
    return acc.to(ef.dtype)


def g1_edge_update_agg_plain(ef, scale, bias, w0, src, tr, rl, gb,
                             has_ln: bool = True):
    """:func:`g1_edge_update_plain` and the f32 sum of the rounded ``h`` by
    receiver (``_reference2``)."""
    h = g1_edge_update_plain(ef, scale, bias, w0, src, tr, rl, gb, has_ln)
    agg = torch.zeros(tr.shape[0], h.shape[1], dtype=torch.float32,
                      device=ef.device)
    agg.index_add_(0, rl.long(), h.float())
    return h, agg


def _lib() -> ctypes.CDLL:
    lib = _build.load("edge_update_g1")
    fn = lib.gn_g1_edge_update
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, p, i, p, p, p, p, p, p,
                       i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.gn_g1_edge_update_tile_rows.argtypes = [ctypes.c_int]
        lib.gn_g1_edge_update_tile_rows.restype = ctypes.c_int
    return lib


def _launch(ef, scale, bias, w0, src, tr, rl, gb, has_ln: bool,
            with_agg: bool, out=None):
    """The kernel; ``h`` goes to ``out`` when given (``src`` itself)."""
    global LAUNCHES, LAUNCHES_NO_AGG
    E, de = ef.shape
    N, dout = tr.shape
    if ef.dtype not in _DTYPES:
        raise TypeError(f"fused_g1_edge_update: ef must be bf16 or f32, got "
                        f"{ef.dtype}")
    if E < 1 or de % 128 or dout % 128:
        raise ValueError(f"fused_g1_edge_update: unsupported shape E={E} "
                         f"de={de} dout={dout} (E >= 1, widths % 128 == 0)")
    expect = {"w0": (w0, (de, dout)), "src": (src, (E, dout)),
              "rl": (rl, (E,)), "gb": (gb, (dout,)),
              "scale": (scale, (de,)), "bias": (bias, (de,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_g1_edge_update: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    for name, t in (("src", src), ("tr", tr)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"fused_g1_edge_update: {name} must be bf16 or "
                            f"f32, got {t.dtype}")
    if rl.dtype != torch.int32:
        raise TypeError("fused_g1_edge_update: rl must be int32")
    args = [ef, w0.to(ef.dtype), scale.float(), bias.float(), src, tr, rl,
            gb.float()]
    for t in args:
        if not t.is_cuda or t.device != ef.device:
            raise ValueError("fused_g1_edge_update: all inputs must be on "
                             f"{ef.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_g1_edge_update: inputs must be "
                             "contiguous and 16-byte aligned")
    kind = lambda t: 1 if t.dtype == torch.float32 else 2
    is_f32 = int(ef.dtype == torch.float32)
    lib = _lib()
    h = out if out is not None else torch.empty(E, dout, dtype=ef.dtype,
                                                device=ef.device)
    agg = first = last = None
    if with_agg:
        tile_rows = lib.gn_g1_edge_update_tile_rows(is_f32)
        if is_f32 and tile_rows != g1_f32_plan(E, dout)[0]:
            raise RuntimeError(f"fused_g1_edge_update: the library's f32 "
                               f"tile has {tile_rows} rows, the plan "
                               f"{_F32_ROWS}")
        tiles = -(-E // tile_rows)
        f32 = dict(dtype=torch.float32, device=ef.device)
        agg = torch.zeros(N, dout, **f32)
        first, last = torch.empty(tiles, dout, **f32), \
            torch.empty(tiles, dout, **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    ef_, w0_, scale_, bias_, src_, tr_, rl_, gb_ = args
    with torch.cuda.device(ef.device):
        err = lib.gn_g1_edge_update(
            ptr(ef_), ptr(w0_), ptr(scale_), ptr(bias_), ptr(src_),
            kind(src_), ptr(tr_), kind(tr_), ptr(rl_), ptr(gb_), ptr(h),
            ptr(agg), ptr(first), ptr(last), E, N, de, dout, is_f32,
            int(has_ln), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fused_g1_edge_update")
    if with_agg:
        LAUNCHES += 1
        return h, agg
    LAUNCHES_NO_AGG += 1
    return h


def _forward(ef, scale, bias, w0, src, tr, rl, gb, has_ln, with_agg,
             alias):
    """Kernel, plain version (CPU) or composed reference (outside the
    gate), as ``_op`` / ``_op2``; with ``alias`` ``h`` is written over
    ``src`` (contiguous, of ``ef``'s type) on every route."""
    E, de = ef.shape
    N, dout = tr.shape
    plain = g1_edge_update_agg_plain if with_agg else g1_edge_update_plain
    if (ef.device.type == "cpu" or not supports_g1_edge_update(
            E, N, de, dout, ef.element_size(), with_agg=with_agg,
            part_itemsize=tr.element_size())):
        res = plain(ef, scale, bias, w0, src, tr, rl, gb, has_ln)
        if not alias:
            return res
        src.copy_(res[0] if with_agg else res)
        return (src, res[1]) if with_agg else src
    return _launch(ef, scale, bias, w0, src.contiguous(), tr.contiguous(),
                   rl, gb, has_ln, with_agg, out=src if alias else None)


def _backward_core(ctx, saved, g):
    """``_bwd_core`` (``edge_update_g1.py:398-428``).  ``saved`` is
    ``ctx.saved_tensors``, unpacked once by the caller (activation
    checkpointing lets a backward unpack them only once)."""
    ef, scale, bias, w0, rl = saved
    n_nodes, src_dtype, tr_dtype, gb_dtype, has_ln = ctx.meta
    g = g.contiguous()
    d_src = g.to(src_dtype)
    d_tr = sorted_segment_sum(g, rl, n_nodes).to(tr_dtype)
    d_gb = g.float().sum(0).to(gb_dtype)
    if has_ln:
        if supports_ln_matmul(ef.shape[0], ef.shape[1], w0.shape[1],
                              ef.dtype):
            d_ef, ds, db, dw = ln_linear_backward(ef, scale, bias, w0, g)
        else:
            d_ef, ds, db, dw = ln_linear_backward_plain(ef, scale, bias, w0,
                                                        g)
        ds, db, dw = ds.to(scale.dtype), db.to(bias.dtype), dw.to(w0.dtype)
    else:
        gc = g.to(ef.dtype)
        d_ef = matmul_f32(gc, w0.t()).to(ef.dtype)
        dw = matmul_f32(ef.t(), gc).to(w0.dtype)
        ds, db = torch.zeros_like(scale), torch.zeros_like(bias)
    return d_ef, ds, db, dw, d_src, d_tr, None, d_gb, None, None


def _save(ctx, ef, scale, bias, w0, src, tr, rl, gb, has_ln, src_is_dead):
    """Saves what the backward needs (never ``src``) and says whether ``h``
    is written over ``src``: only for a dead ``src`` of ``ef``'s type, as
    the JAX package's donation, and then marks it dirty."""
    ctx.save_for_backward(ef, scale, bias, w0, rl)
    ctx.meta = (tr.shape[0], src.dtype, tr.dtype, gb.dtype, has_ln)
    alias = (src_is_dead and src.dtype == ef.dtype and src.is_contiguous()
             and tuple(src.shape) == (ef.shape[0], tr.shape[1]))
    if alias:
        ctx.mark_dirty(src)
    return alias


class _G1EdgeUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ef, scale, bias, w0, src, tr, rl, gb, has_ln,
                src_is_dead):
        alias = _save(ctx, ef, scale, bias, w0, src, tr, rl, gb, has_ln,
                      src_is_dead)
        return _forward(ef, scale, bias, w0, src, tr, rl, gb, has_ln, False,
                        alias)

    @staticmethod
    def backward(ctx, g):
        return _backward_core(ctx, ctx.saved_tensors, g)


class _G1EdgeUpdateAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ef, scale, bias, w0, src, tr, rl, gb, has_ln,
                src_is_dead):
        alias = _save(ctx, ef, scale, bias, w0, src, tr, rl, gb, has_ln,
                      src_is_dead)
        return _forward(ef, scale, bias, w0, src, tr, rl, gb, has_ln, True,
                        alias)

    @staticmethod
    def backward(ctx, g_h, g_agg):
        saved = ctx.saved_tensors
        rl = saved[4]
        # agg = segment_sum(h): its pullback is the sorted gather, taken in
        # h's type and added to g_h in f32 with one rounding
        # (``edge_update_g1.py:478-480``).
        gh = (g_h.float()
              + sorted_gather(g_agg.to(g_h.dtype).contiguous(), rl).float()
              ).to(g_h.dtype)
        return _backward_core(ctx, saved, gh)


def _unpack_ln(ef, ef_ln):
    if ef_ln is None:
        de = ef.shape[1]
        return (torch.ones(de, device=ef.device),
                torch.zeros(de, device=ef.device), False)
    return ef_ln["scale"], ef_ln["bias"], True


def fused_g1_edge_update_agg(ef, ef_ln: Optional[dict], w0, src, tr, rl, gb,
                             *, src_is_dead: bool = False):
    """:func:`fused_g1_edge_update` that also returns the edge->node sum of
    its result, ``agg [N, dout]`` in f32, from the same pass.  The backward
    rounds the agg cotangent to ``ef.dtype`` before gathering it back to
    the edges (exact for a consumer that casts agg to ``ef.dtype``, as the
    GNBlock does)."""
    scale, bias, has_ln = _unpack_ln(ef, ef_ln)
    return _G1EdgeUpdateAgg.apply(ef, scale, bias, w0, src, tr, rl, gb,
                                  has_ln, src_is_dead)


def fused_g1_edge_update(ef, ef_ln: Optional[dict], w0, src, tr, rl, gb,
                         *, src_is_dead: bool = False):
    """``LN(ef) @ W0 + src + tr[rl] + gb`` in one pass for a single-graph
    batch in canonical order (``rl`` ascending, every id in ``[0, N)``).

    ``ef_ln``: LayerNorm params ``{"scale", "bias"}`` or ``None`` (no LN).
    ``src [E, dout]``: the sender term rows; ``tr [N, dout]``: the
    receiver-side node table (both bf16 or f32); ``gb [dout]``: the f32
    graph term plus bias.  Returns ``h [E, dout]`` in ``ef.dtype``.

    ``src_is_dead`` (internal, passed by ``GNBlock`` alone): the caller
    owns ``src`` and never reads it again, so ``h`` may be written over it
    when their types match (the JAX kernel's donation); ``src`` is then
    returned as ``h``."""
    scale, bias, has_ln = _unpack_ln(ef, ef_ln)
    return _G1EdgeUpdate.apply(ef, scale, bias, w0, src, tr, rl, gb, has_ln,
                               src_is_dead)
