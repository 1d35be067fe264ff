"""``LayerNorm(x) @ w [+ addend]`` and its backward in plain torch
(counterparts of ``ln_matmul_reference`` and ``_backward`` in
``graphnets_tpu/ops/pallas/ln_linear.py``).

The ``ln_matmul`` kernel itself is not on the port's path yet; the plain
edge update (``ops/kernels/edge_update.py``) needs the forward reference.
:func:`ln_linear_backward_plain` is the plain version of the backward
kernel in ``ops/kernels/ln_linear.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.core import EPS, layer_norm

__all__ = ["ln_linear_backward_plain", "ln_matmul_reference", "matmul_f32"]


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.astype(x.dtype)`` with a float32 result: the products of the
    rounded operands are exact in float32 and accumulate in float32 (the
    JAX package's ``preferred_element_type=float32``).  On a card this
    assumes ``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's
    default."""
    return x.float() @ w.to(x.dtype).float()


def ln_matmul_reference(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, w: torch.Tensor,
                        addend: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``LayerNorm(x) @ w`` with the module rounding points: the LN output
    is cast to ``x.dtype`` before the product.  Without ``addend`` the f32
    partial product comes back; with it (an f32 sum of other partials) the
    completed row comes back in ``x.dtype``, rounded once."""
    out = matmul_f32(layer_norm(x, scale, bias), w)
    if addend is None:
        return out
    return (out + addend.float()).to(x.dtype)


def ln_linear_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, w: torch.Tensor,
                             g: torch.Tensor):
    """Backward of ``bf16(LayerNorm(x)) @ w`` for the cotangent ``g``, with
    the Pallas kernel's arithmetic (``ln_linear.py:165-200``): f32 LN
    statistics recomputed from ``x`` (std + eps, std = 0 where var == 0),
    ``g`` and ``w`` rounded to ``x.dtype`` and multiplied in f32, and the
    std-convention pullback, whose var == 0 rows take sigma = 1 (their
    ``z`` is 0, so the term divided by sigma vanishes).

    Returns ``(dx [T, d] in x.dtype, dscale [d], dbias [d], dw [d, dout])``,
    the last three in f32.
    """
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
    gc = g.to(x.dtype).float()
    dw = xn.float().t() @ gc
    dxn = gc @ w.to(x.dtype).float().t()
    dscale = (dxn * z).sum(0)
    dbias = dxn.sum(0)
    dz = dxn * gamma
    mean_dz = dz.sum(-1, keepdim=True) / d
    mean_dzz = (dz * z).sum(-1, keepdim=True) / d
    mean_z = z.sum(-1, keepdim=True) / d
    dx = (dz - mean_dz) / s - (z - mean_z) * (mean_dzz / sigma)
    return dx.to(x.dtype), dscale, dbias, dw
