"""Mixed-precision policy (counterpart of ``graphnets_tpu/nn/precision.py``).

The policy of the port, as of the JAX package: parameters are kept in f32
(the master weights), compute runs in the activations' type (``Linear``
casts its weight to its input's type at use), and LayerNorm statistics and
every segment sum stay f32.  These helpers cast a batch's features and a
model's parameters for a policy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..graph import GraphsTuple

__all__ = ["Policy", "DEFAULT", "BF16_COMPUTE", "cast_features",
           "cast_params"]


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def cast_graph(self, g: GraphsTuple) -> GraphsTuple:
        return cast_features(g, self.compute_dtype)

    def cast_params(self, params):
        return cast_params(params, self.param_dtype)


DEFAULT = Policy()
BF16_COMPUTE = Policy(param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16)


def cast_features(g: GraphsTuple, dtype: torch.dtype) -> GraphsTuple:
    """``g`` with ``ef``/``nf``/``gf`` cast to ``dtype`` (the structure
    tensors untouched)."""
    def c(x):
        return None if x is None else x.to(dtype)
    return g.with_features(ef=c(g.ef), nf=c(g.nf), gf=c(g.gf))


def cast_params(params: Any, dtype: torch.dtype) -> Any:
    """The floating parameters cast to ``dtype``, integer ones untouched.
    A module is cast in place and returned (``nn.Module.to``); a state dict
    or a nested dict / list of tensors comes back as a new one."""
    if isinstance(params, nn.Module):
        return params.to(dtype)
    if isinstance(params, torch.Tensor):
        return params.to(dtype) if params.is_floating_point() else params
    if isinstance(params, dict):
        return type(params)((k, cast_params(v, dtype))
                            for k, v in params.items())
    if isinstance(params, (list, tuple)):
        return type(params)(cast_params(v, dtype) for v in params)
    return params
