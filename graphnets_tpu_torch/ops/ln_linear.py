"""``LayerNorm(x) @ w [+ addend]`` in plain torch (counterpart of
``ln_matmul_reference`` in ``graphnets_tpu/ops/pallas/ln_linear.py``).

The ``ln_matmul`` kernel itself is not on the port's path yet; the plain
edge update (``ops/kernels/edge_update.py``) needs this reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.core import layer_norm

__all__ = ["ln_matmul_reference", "matmul_f32"]


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
