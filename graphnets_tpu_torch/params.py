"""Move parameters between ``graphnets_tpu`` trees and port modules.

The JAX package keeps parameters as nested dicts (``{"0": {"block":
{"edgefn": {"w", "b"}, ...}}}``); the port's modules use the same names and
layouts (``Linear.w`` is ``[din, dout]``, LayerNorm has ``scale``/``bias``),
so the tree flattens to exactly the module's ``named_parameters()``.  The
caller converts the JAX arrays to numpy first (``jax.device_get``); this
module never imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["from_jax_params", "to_numpy_tree"]


def _flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` -> ``{"a.b": x}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def from_jax_params(tree, module: nn.Module) -> nn.Module:
    """Copy a numpy parameter tree into ``module`` in place and return it.

    Names and shapes must match exactly: a missing, extra or misshapen
    parameter raises ``ValueError``.  Values are cast to each parameter's
    own dtype and device (bfloat16 arrays widen exactly through float32).
    """
    flat = _flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"unexpected {extra}")
    for name, p in params.items():
        arr = np.asarray(flat[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(p.shape)}")
        src = torch.tensor(np.asarray(arr, np.float32))
        with torch.no_grad():
            p.copy_(src.to(device=p.device, dtype=p.dtype))
    return module


def to_numpy_tree(module: nn.Module) -> dict:
    """The module's parameters as a nested dict of f32 numpy arrays, in the
    JAX package's tree layout (the reverse of :func:`from_jax_params`)."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().float().cpu().numpy()
    return tree
