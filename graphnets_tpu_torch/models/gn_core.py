"""GNCore / GNCoreList / GNFeedForward / GNGraphNorm in the PyTorch port
(counterpart of ``graphnets_tpu/models/gn_core.py``).

The core is a parallel-branch residual (both branches read the original
input):

    y = x + GNBlock(LN1(x)) + FFW(LN2(x))

with a per-feature-set LayerNorm and a per-feature-set
``Dense(d -> 4d, relu) -> Dense(4d -> d) -> Dropout``; all three feature
dims must be > 0.

With kernels on, the pre-block edge LN is handed to the fused edge update,
and the second branch plus both residuals run in the fused LN->FFN->residual
kernel (``ops/kernels/fused_ffn``), one call per feature set.  Under
training the JAX package's gates hold (``gn_core.py:168-213``): above
d = 256 the second branch is composed from plain ops, and a feature set
under 65,536 rows takes the composed reference.  The one case left, the
fused FFN's own backward (d <= 256 and >= 65,536 rows), is not ported and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..graph import GraphsTuple
from ..nn.core import FeedForward, LayerNorm, init_generator
from ..ops.kernels.fused_ffn import (ln_ffn_residual,
                                     ln_ffn_residual_reference,
                                     supports_fused_ffn)
from ..utils.config import use_kernels
from .gn_block import GNBlock

__all__ = ["GNFeedForward", "GNGraphNorm", "GNCore", "GNCoreList",
           "graphnet_add"]


def _require_all_positive(dims, who: str):
    """Residual cores normalise and MLP every feature set, so all three
    dims must be > 0."""
    if not all(d > 0 for d in dims):
        raise ValueError(
            f"{who} requires all of (edge, node, graph) dims > 0, got "
            f"{tuple(dims)}. Use GNBlock directly for zero-width feature "
            "sets.")


def graphnet_add(a: GraphsTuple, b: GraphsTuple) -> GraphsTuple:
    """Element-wise residual add of ef/nf/gf."""
    return a.with_features(ef=a.ef + b.ef, nf=a.nf + b.nf, gf=a.gf + b.gf)


class GNGraphNorm(nn.Module):
    """Per-feature-set LayerNorm: ``edgeln``, ``nodeln``, ``graphln``.
    Padded slots are normalised too; aggregations mask them."""

    def __init__(self, dims: Tuple[int, int, int], *, device=None,
                 dtype=torch.float32):
        super().__init__()
        _require_all_positive(dims, "GNGraphNorm")
        de, dn, dg = dims
        self.edgeln = LayerNorm(de, device=device, dtype=dtype)
        self.nodeln = LayerNorm(dn, device=device, dtype=dtype)
        self.graphln = LayerNorm(dg, device=device, dtype=dtype)

    def forward(self, g: GraphsTuple, training: bool = False,
                generator=None) -> GraphsTuple:
        return g.with_features(ef=self.edgeln(g.ef), nf=self.nodeln(g.nf),
                               gf=self.graphln(g.gf))


class GNFeedForward(nn.Module):
    """Per-feature-set MLP: ``eff``, ``nff``, ``gff``."""

    def __init__(self, dims: Tuple[int, int, int], dropout: float = 0.0, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _require_all_positive(dims, "GNFeedForward")
        kw = dict(device=device, dtype=dtype,
                  generator=init_generator(generator))
        de, dn, dg = dims
        self.eff = FeedForward(de, dropout, **kw)
        self.nff = FeedForward(dn, dropout, **kw)
        self.gff = FeedForward(dg, dropout, **kw)

    def forward(self, g: GraphsTuple, training: bool = False,
                generator: Optional[torch.Generator] = None) -> GraphsTuple:
        kw = dict(training=training, generator=generator)
        return g.with_features(ef=self.eff(g.ef, **kw),
                               nf=self.nff(g.nf, **kw),
                               gf=self.gff(g.gf, **kw))


class GNCore(nn.Module):
    """Residual GN core at constant dims: ``block``, ``ffwd``, ``gn1``,
    ``gn2``."""

    def __init__(self, dims: Tuple[int, int, int], dropout: float = 0.0, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _require_all_positive(dims, "GNCore")
        self.dims, self.dropout = tuple(dims), dropout
        gen = init_generator(generator)
        self.block = GNBlock(dims, dims, dropout=dropout, device=device,
                             dtype=dtype, generator=gen)
        self.ffwd = GNFeedForward(dims, dropout, device=device, dtype=dtype,
                                  generator=gen)
        self.gn1 = GNGraphNorm(dims, device=device, dtype=dtype)
        self.gn2 = GNGraphNorm(dims, device=device, dtype=dtype)

    def forward(self, g: GraphsTuple, training: bool = False,
                generator: Optional[torch.Generator] = None) -> GraphsTuple:
        if use_kernels():
            # The pre-block LN of ef goes to the fused edge update, which
            # normalises each row on chip.
            eln = self.gn1.edgeln
            gn1_nf_gf = g.with_features(nf=self.gn1.nodeln(g.nf),
                                        gf=self.gn1.graphln(g.gf))
            branch1 = self.block(gn1_nf_gf, training=training,
                                 generator=generator,
                                 ef_ln={"scale": eln.scale,
                                        "bias": eln.bias})
        else:
            branch1 = self.block(self.gn1(g), training=training,
                                 generator=generator)
        if self._use_fused(g, training):
            # The whole second branch and both residuals in one kernel
            # pass per feature set: y = x + branch1 + FF(LN2(x)).
            return self._fused_branch2(g, branch1, training)
        branch2 = self.ffwd(self.gn2(g), training=training,
                            generator=generator)
        return graphnet_add(graphnet_add(g, branch1), branch2)

    # The JAX package's training gates, measured there: above this edge
    # feature dim the fused FFN's recomputing backward loses to the
    # composed ops under training...
    _FUSED_FFN_TRAIN_MAX_DIM = 256
    # ...and a feature set with fewer rows takes the composed reference.
    _FUSED_FFN_TRAIN_MIN_ROWS = 1 << 16

    def _use_fused(self, g: GraphsTuple, training: bool) -> bool:
        if not use_kernels() or (training and self.dropout > 0):
            return False
        if training and self.dims[0] > self._FUSED_FFN_TRAIN_MAX_DIM:
            return False
        return (supports_fused_ffn(g.num_edge_slots, self.dims[0],
                                   g.ef.dtype)
                and supports_fused_ffn(g.num_node_slots, self.dims[1],
                                       g.nf.dtype))

    def _fused_branch2(self, g: GraphsTuple, branch1: GraphsTuple,
                       training: bool) -> GraphsTuple:
        def one(x, extra, ln: LayerNorm, ff: nn.Module):
            args = (x, ln.scale, ln.bias, ff[0].w, ff[0].b, ff[1].w,
                    ff[1].b)
            if ((training and x.shape[0] < self._FUSED_FFN_TRAIN_MIN_ROWS)
                    or not supports_fused_ffn(x.shape[0], x.shape[1],
                                              x.dtype)):
                # The composed reference: the measured winner for small
                # row counts under training, and the JAX kernel's own
                # fallback for a feature set it does not take.
                return ln_ffn_residual_reference(*args, extra=extra)
            if training:
                raise NotImplementedError(
                    "training through the fused LN->FFN->residual kernel "
                    "needs its backward (PERF.md kernel table row 3, "
                    "fused_ffn.py:240 _fused_backward), which is not "
                    "ported; train with enable_kernels(False)")
            return ln_ffn_residual(*args, extra=extra)

        return g.with_features(
            ef=one(g.ef, branch1.ef, self.gn2.edgeln, self.ffwd.eff),
            nf=one(g.nf, branch1.nf, self.gn2.nodeln, self.ffwd.nff),
            gf=one(g.gf, branch1.gf, self.gn2.graphln, self.ffwd.gff),
        )


class GNCoreList(nn.Module):
    """Sequential composition of cores, named ``"0"``, ``"1"``, ...

    A module passed more than once (``[GNCore(dims)] * 3``, as with the JAX
    package's stateless descriptors) is copied, so every position owns its
    parameters; the copies start from the same weights.
    """

    def __init__(self, cores: Sequence[nn.Module]):
        super().__init__()
        seen = set()
        for i, core in enumerate(cores):
            if id(core) in seen:
                core = copy.deepcopy(core)
            seen.add(id(core))
            self.add_module(str(i), core)

    def forward(self, g: GraphsTuple, training: bool = False,
                generator: Optional[torch.Generator] = None) -> GraphsTuple:
        for core in self.children():
            g = core(g, training=training, generator=generator)
        return g
