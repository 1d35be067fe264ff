"""GraphCast's split first edge layer and its swish in one pass (no
counterpart in the JAX package, which has no GraphCast).

    pre[e] = bf16( f32(e[e] @ W_e)
                   + ((f32(P_s[senders[e]]) + f32(P_r[receivers[e]]))
                      + f32(b)) )
    h[e]   = bf16( swish(f32(pre[e])) )

``P_s = v_s @ W_s`` and ``P_r = v_r @ W_r`` are the node tables'
projections, plain products on the node rows that the caller takes.  The
composed form (``e @ W_e + P_s[senders] + P_r[receivers] + b``, then
``F.silu``) took seven passes over ``[E, hidden]`` rows, each rounding to
bf16 and writing a full tensor that the next read back.  Kernel:
``csrc/split_edge_layer.cu``, on the wgmma + TMA core of
``csrc/edge_wgmma.cuh``; on the H100 it is bound by bytes (e in, pre and h
out, the two tables: ~1.09 GB, 0.33 ms at the processor's 327,680 rows of
512).  Only ``pre`` and ``h`` are written.

:func:`split_edge_layer` is differentiable and returns ``h``; it saves
``e``, ``W_e``, ``pre`` and the ids.  Its backward takes ``d_pre = bf16(d_h
* swish'(pre))`` and ``d_b`` (f32 column sums of the rounded ``d_pre``) in
one kernel pass and a small column sum, ``d_pre`` written over the saved
``pre``, which nothing reads after it (``pre``'s version is bumped, and a
second backward through the same graph raises).  Then a second autograd
node, after ``d_h`` and ``pre`` are freed, composes: ``d_e`` and
``d_W_e`` by ``torch.matmul``, ``d_P_r`` by the sorted segment sum over the
ascending receivers, ``d_P_s`` by the senders' scatter that
``ops.scatter.gather_nodes`` takes.  It takes the plain versions for CPU
tensors only; a CUDA tensor launches the kernels or raises.  The caller
routes a CUDA shape outside :func:`supports_split_edge_layer` to the
composed form.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.graph import increment_version

from ..ln_linear import matmul_f32
from . import _build

__all__ = ["split_edge_layer", "split_edge_layer_plain",
           "split_edge_backward_plain", "supports_split_edge_layer",
           "LAUNCHES", "LAUNCHES_BWD"]

LAUNCHES = 0       # forward kernel launches
LAUNCHES_BWD = 0   # backward kernel launches
_MAX_LATENT = 768  # whole e rows of a 128-row tile beside two W_e stages
_MAX_HIDDEN = 2048  # a backward block's row of 16-byte chunks
_bwd_plans: dict = {}  # (rows, hidden, device) -> (rows a block, blocks)


def supports_split_edge_layer(num_rows: int, latent: int, hidden: int,
                              dtype: torch.dtype,
                              receivers_sorted: bool) -> bool:
    """The kernel's gate: bf16 rows, widths that are multiples of 128 (a
    tile's whole rows in shared memory: latent at most 768; a backward
    block's row of 16-byte chunks: hidden at most 2048), edge rows a
    multiple of 128, and receivers declared ascending."""
    return (dtype == torch.bfloat16 and receivers_sorted
            and latent % 128 == 0 and 128 <= latent <= _MAX_LATENT
            and hidden % 128 == 0 and 128 <= hidden <= _MAX_HIDDEN
            and num_rows % 128 == 0 and num_rows >= 128)


def split_edge_layer_plain(e, w_e, p_s, p_r, b, senders, receivers):
    """``(pre, h)`` in plain torch, with the kernel's rounding points: the
    product in f32, the node terms and the bias added in f32, ``pre``
    rounded once, swish of the rounded ``pre`` in f32, ``h`` rounded
    once."""
    node = ((p_s.index_select(0, senders.long()).float()
             + p_r.index_select(0, receivers.long()).float()) + b.float())
    pre = (matmul_f32(e, w_e) + node).to(e.dtype)
    return pre, torch.nn.functional.silu(pre.float()).to(e.dtype)


def split_edge_backward_plain(d_h, pre):
    """``(d_pre, d_b)``: torch's swish backward in f32, ``d_pre`` rounded
    once to ``pre``'s type, ``d_b`` the f32 column sums of the rounded
    ``d_pre``."""
    x = pre.float()
    s = torch.sigmoid(x)
    d_pre = (d_h.float() * s * (1 + x * (1 - s))).to(pre.dtype)
    return d_pre, d_pre.float().sum(0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("split_edge_layer")
    if lib.gn_split_edge_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gn_split_edge_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.gn_split_edge_fwd.restype = ctypes.c_int
        lib.gn_split_edge_bwd_plan.argtypes = [
            i, i, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.gn_split_edge_bwd_plan.restype = ctypes.c_int
        lib.gn_split_edge_bwd.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.gn_split_edge_bwd.restype = ctypes.c_int
    return lib


def _check(what, tensors, dtypes):
    for name, t in tensors.items():
        if t.dtype != dtypes.get(name, torch.bfloat16):
            raise TypeError(f"{what}: {name} must be "
                            f"{dtypes.get(name, torch.bfloat16)}, got "
                            f"{t.dtype}")
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                             f"aligned CUDA tensor")


def _forward_kernel(e, w_e, p_s, p_r, b, senders, receivers):
    global LAUNCHES
    E, D = e.shape
    H = w_e.shape[1]
    if not supports_split_edge_layer(E, D, H, e.dtype, True):
        raise ValueError(f"split_edge_layer: unsupported shape E={E} D={D} "
                         f"H={H} {e.dtype}")
    shapes = {"w_e": (w_e, (D, H)), "p_s": (p_s, (p_s.shape[0], H)),
              "p_r": (p_r, (p_r.shape[0], H)), "b": (b, (H,)),
              "senders": (senders, (E,)), "receivers": (receivers, (E,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"split_edge_layer: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    _check("split_edge_layer", dict(e=e, w_e=w_e, p_s=p_s, p_r=p_r, b=b,
                                    senders=senders, receivers=receivers),
           dict(senders=torch.int32, receivers=torch.int32))
    pre = torch.empty(E, H, dtype=e.dtype, device=e.device)
    h = torch.empty_like(pre)
    lib = _lib()
    with torch.cuda.device(e.device):
        err = lib.gn_split_edge_fwd(
            e.data_ptr(), w_e.data_ptr(), p_s.data_ptr(), p_r.data_ptr(),
            b.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
            pre.data_ptr(), h.data_ptr(), E, p_s.shape[0], p_r.shape[0], D,
            H, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "split_edge_layer")
    LAUNCHES += 1
    return pre, h


def _backward_kernel(d_h, pre):
    """``(d_pre, d_b)``; ``d_pre`` is written over ``pre`` (its version
    bumped)."""
    global LAUNCHES_BWD
    E, H = pre.shape
    _check("split_edge_layer backward", dict(d_h=d_h, pre=pre), {})
    if tuple(d_h.shape) != (E, H):
        raise ValueError(f"split_edge_layer backward: d_h has shape "
                         f"{tuple(d_h.shape)}, expected {(E, H)}")
    lib = _lib()
    with torch.cuda.device(pre.device):
        key = (E, H, pre.device.index)
        if key not in _bwd_plans:
            rpb, blocks = ctypes.c_int(), ctypes.c_int()
            _build.check(lib, lib.gn_split_edge_bwd_plan(
                E, H, ctypes.byref(rpb), ctypes.byref(blocks)),
                "split_edge_layer backward plan")
            _bwd_plans[key] = (rpb.value, blocks.value)
        rpb, blocks = _bwd_plans[key]
        f32 = dict(dtype=torch.float32, device=pre.device)
        part = torch.empty(blocks, H, **f32)
        d_b = torch.empty(H, **f32)
        err = lib.gn_split_edge_bwd(
            d_h.data_ptr(), pre.data_ptr(), pre.data_ptr(),
            part.data_ptr(), d_b.data_ptr(), E, H, rpb, blocks,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "split_edge_layer backward")
    increment_version(pre)
    LAUNCHES_BWD += 1
    return pre, d_b


class _SplitEdgeProducts(torch.autograd.Function):
    """The products and gathers of ``pre``, for the backward alone: the
    forward returns a placeholder of ``pre``'s shape that holds one value
    and launches nothing (the kernel computes ``pre`` itself), and the
    backward takes ``d_pre`` to ``e``, ``W_e`` and the node tables.  A node
    of its own, so that ``d_h`` and the saved ``pre`` are freed before
    these large products and sums run, as in the composed form."""

    @staticmethod
    def forward(ctx, e, w_e, p_s, p_r, senders, receivers):
        ctx.save_for_backward(e, w_e, senders, receivers)
        ctx.meta = (p_s.shape[0], p_r.shape[0])
        return e.new_empty((1, 1)).expand(e.shape[0], w_e.shape[1])

    @staticmethod
    def backward(ctx, d_pre):
        from ..scatter import gather_nodes_grad
        e, w_e, senders, receivers = ctx.saved_tensors
        n_s, n_r = ctx.meta
        # The node tables' sums first: the senders' permuted copy of d_pre
        # is freed before d_e is made.
        d_ps = gather_nodes_grad(d_pre, senders, n_s)
        d_pr = gather_nodes_grad(d_pre, receivers, n_r, idx_sorted=True)
        return d_pre @ w_e.t(), e.t() @ d_pre, d_ps, d_pr, None, None


class _SplitEdgeLayer(torch.autograd.Function):
    """``h`` from the kernel (or the plain version); the backward takes
    ``d_pre`` and ``d_b`` and hands ``d_pre`` to the placeholder's node."""

    @staticmethod
    def forward(ctx, link, e, w_e, p_s, p_r, b, senders, receivers):
        if e.device.type == "cpu":
            pre, h = split_edge_layer_plain(e, w_e, p_s, p_r, b, senders,
                                            receivers)
        else:
            pre, h = _forward_kernel(e, w_e, p_s.contiguous(),
                                     p_r.contiguous(), b, senders, receivers)
        ctx.save_for_backward(pre)
        ctx.b_dtype = b.dtype
        return h

    @staticmethod
    def backward(ctx, d_h):
        pre, = ctx.saved_tensors
        d_h = d_h.contiguous()
        if pre.device.type == "cpu":
            d_pre, d_b = split_edge_backward_plain(d_h, pre)
        else:
            d_pre, d_b = _backward_kernel(d_h, pre)
        return (d_pre, None, None, None, None, d_b.to(ctx.b_dtype), None,
                None)


def split_edge_layer(e, w_e, p_s, p_r, b, senders, receivers):
    """``h = swish(e @ w_e + p_s[senders] + p_r[receivers] + b)`` with the
    kernel's rounding points (see the module's note); ``receivers``
    ascend.  ``e [E, D]``, ``w_e [D, H]``, ``p_s [Ns, H]``, ``p_r [Nr,
    H]``, ``b [H]``, int32 ids ``[E]``."""
    link = _SplitEdgeProducts.apply(e, w_e, p_s, p_r, senders, receivers)
    return _SplitEdgeLayer.apply(link, e, w_e, p_s, p_r, b, senders,
                                 receivers)
