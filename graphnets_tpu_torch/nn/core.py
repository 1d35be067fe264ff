"""Neural-network modules of the PyTorch port (counterpart of
``graphnets_tpu/nn/core.py``).

The parameter layout follows the JAX package so weights carry across by
copy (``params.from_jax_params``):

* ``Linear``: ``y = x @ w + b`` with ``w [din, dout]`` (not torch's
  ``[dout, din]``), glorot-uniform ``w`` and zero ``b``.
* ``LayerNorm``: the Flux convention ``(x - mean) / (std + eps)``,
  **std + eps, not sqrt(var + eps)**, with f32 statistics, uncorrected std
  and the var == 0 guard; parameters ``scale``/``bias``.  This is not
  ``torch.nn.LayerNorm``.
* ``Dropout``: inverted dropout with an explicit ``torch.Generator``.

Parameters are initialised on the host from an explicit generator (seeded
0 when none is given) and then moved to ``device``, so a seed gives the same
weights on every device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..utils.config import resolve_device

__all__ = ["Linear", "LayerNorm", "Dropout", "Chain", "FeedForward", "relu",
           "layer_norm"]

EPS = 1e-5


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def init_generator(generator: Optional[torch.Generator]
                   ) -> torch.Generator:
    """``generator``, or a new one seeded 0."""
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = EPS
               ) -> torch.Tensor:
    """Flux LayerNorm over the last axis: f32 statistics, ``std + eps``,
    std taken as 0 where var == 0; the result is cast back to ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    # sqrt through a where-guarded operand: the var == 0 rows (all-zero
    # padded slots) keep a finite gradient.
    pos = var > 0
    std = torch.where(pos, torch.where(pos, var, 1.0).sqrt(), 0.0)
    y = (xf - mean) / (std + eps)
    if scale is not None:
        y = y * scale + bias
    return y.to(x.dtype)


class Linear(nn.Module):
    """Affine layer with optional activation (Flux ``Dense``).

    Zero-width dims are legal: ``din == 0`` yields the bias broadcast and
    ``dout == 0`` a ``[T, 0]`` output.
    """

    def __init__(self, din: int, dout: int,
                 activation: Optional[Callable] = None, use_bias: bool = True,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.din, self.dout, self.activation = din, dout, activation
        w = torch.zeros(din, dout, dtype=torch.float32)
        if din > 0 and dout > 0:
            limit = math.sqrt(6.0 / (din + dout))
            w = (torch.rand(din, dout, generator=init_generator(generator))
                 * 2 - 1) * limit
        self.w = nn.Parameter(w.to(device=device, dtype=dtype))
        self.b = (nn.Parameter(torch.zeros(dout, device=device, dtype=dtype))
                  if use_bias else None)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        if self.activation is not None:
            y = self.activation(y)
        return y


class LayerNorm(nn.Module):
    """Flux-parity LayerNorm over the feature (last) axis (see
    :func:`layer_norm`).  Padded slots are normalised too, which is harmless
    because aggregations mask padding."""

    def __init__(self, dim: int, eps: float = EPS, affine: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.dim, self.eps = dim, eps
        self.scale = (nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))
                      if affine else None)
        self.bias = (nn.Parameter(torch.zeros(dim, device=device,
                                              dtype=dtype))
                     if affine else None)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class Dropout(nn.Module):
    """Inverted dropout; ``rate == 0`` or inference is the identity.  In
    training it draws its mask from ``generator``, which must live on the
    tensor's device."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not training or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in training mode needs a generator")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class Chain(nn.Module):
    """Sequential composition (Flux ``Chain``); children are named
    ``"0"``, ``"1"``, ... as in the JAX parameter tree."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (tuple, list)):
            layers = tuple(layers[0])
        for i, layer in enumerate(layers):
            self.add_module(str(i), layer)

    def __getitem__(self, i: int) -> nn.Module:
        return self._modules[str(i)]

    def forward(self, x, training: bool = False, generator=None):
        for layer in self.children():
            x = layer(x, training=training, generator=generator)
        return x


def FeedForward(d: int, dropout: float = 0.0, *, device=None,
                dtype=torch.float32,
                generator: Optional[torch.Generator] = None) -> Chain:
    """``Dense(d -> 4d, relu) -> Dense(4d -> d) -> Dropout``."""
    gen = init_generator(generator)
    return Chain(
        Linear(d, 4 * d, activation=relu, device=device, dtype=dtype,
               generator=gen),
        Linear(4 * d, d, device=device, dtype=dtype, generator=gen),
        Dropout(dropout),
    )
