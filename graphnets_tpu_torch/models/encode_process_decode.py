"""Encode -> process (GNCoreList) -> decode model composition (counterpart
of ``graphnets_tpu/models/encode_process_decode.py``).

An encoder ``GNBlock`` lifts the input dims to the core dims, a stack of
residual ``GNCore`` processes them, and a decoder ``GNBlock`` maps to the
output dims.  Zero-width feature sets are legal at both ends (the sort
task: ``(0, vocab, 0) -> core_dims -> (2, 2, 0)``).  ``remat=True`` runs
each core under activation checkpointing (:class:`GNCoreList`), as the JAX
package's ``remat`` runs each under ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..graph import GraphsTuple
from ..nn.core import init_generator
from .gn_block import GNBlock
from .gn_core import GNCore, GNCoreList

__all__ = ["EncodeProcessDecode", "GNModel"]


class EncodeProcessDecode(nn.Module):
    """``GNBlock(x_dims -> core_dims)`` -> ``n_cores * GNCore(core_dims)`` ->
    ``GNBlock(core_dims -> y_dims)``; submodules ``encoder``, ``core`` and
    ``decoder``, as in the JAX parameter tree."""

    def __init__(self, x_dims: Tuple[int, int, int],
                 core_dims: Tuple[int, int, int],
                 y_dims: Tuple[int, int, int], n_cores: int = 2,
                 dropout: float = 0.0, remat: bool = False, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.x_dims, self.core_dims = tuple(x_dims), tuple(core_dims)
        self.y_dims, self.n_cores, self.dropout = tuple(y_dims), n_cores, \
            dropout
        self.remat = remat
        kw = dict(device=device, dtype=dtype,
                  generator=init_generator(generator))
        self.encoder = GNBlock(x_dims, core_dims, **kw)
        self.core = GNCoreList([GNCore(core_dims, dropout, **kw)
                                for _ in range(n_cores)], remat=remat)
        self.decoder = GNBlock(core_dims, y_dims, **kw)

    def forward(self, g: GraphsTuple, training: bool = False,
                generator: Optional[torch.Generator] = None) -> GraphsTuple:
        kw = dict(training=training, generator=generator)
        return self.decoder(self.core(self.encoder(g, **kw), **kw), **kw)


GNModel = EncodeProcessDecode
