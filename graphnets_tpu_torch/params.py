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

__all__ = ["from_jax_params", "to_numpy_tree", "from_jax_stage_params",
           "shard_of"]


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


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def from_jax_stage_params(tree, pipe_module: nn.Module,
                          stage: int) -> nn.Module:
    """Copy stage ``stage`` of a ``PipelinedCoreList`` tree of the JAX
    package (every leaf has a leading stage axis,
    ``parallel/pipeline.py:167-174`` there) into that stage of the port's
    ``PipelinedCoreList`` (``pipe_module.stages[stage]``, whose cores are
    named ``"0"``, ``"1"``, ... as in the JAX stage's tree).  Returns
    ``pipe_module``."""
    from_jax_params(_map_tree(lambda x: np.asarray(x)[stage], tree),
                    pipe_module.stages[stage])
    return pipe_module


def shard_of(array, placement, rank_coord: int, tp: int):
    """Rank ``rank_coord``'s shard of a full weight (a numpy array or a
    tensor) under ``placement``: the array itself when it replicates, else
    the ``rank_coord``-th of ``tp`` equal slices along the placement's
    ``dim`` (``Shard(dim)``)."""
    dim = getattr(placement, "dim", None)
    if dim is None:
        return array
    n = array.shape[dim]
    if n % tp:
        raise ValueError(f"shard_of: dim {dim} of {tuple(array.shape)} "
                         f"does not split {tp} ways")
    index = [slice(None)] * len(array.shape)
    index[dim] = slice(rank_coord * (n // tp), (rank_coord + 1) * (n // tp))
    return array[tuple(index)]


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
