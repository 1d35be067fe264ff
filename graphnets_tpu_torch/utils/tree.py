"""Walks over the tensors inside nested values (``GraphsTuple``,
``TypedGraph`` / ``EdgeSet`` and ``SampledBatch`` dataclasses, tuples,
lists, dicts): the port's small
counterpart of ``jax.tree_util`` for what ``data/prefetch`` and the captured
training step need."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Hashable, List

import torch

__all__ = ["map_tensors", "tensors", "structure"]


def map_tensors(fn: Callable[[torch.Tensor], Any], item: Any) -> Any:
    """``item`` with ``fn`` applied to every tensor inside it; every other
    leaf is kept as it is."""
    if isinstance(item, torch.Tensor):
        return fn(item)
    if dataclasses.is_dataclass(item) and not isinstance(item, type):
        return dataclasses.replace(item, **{
            f.name: map_tensors(fn, getattr(item, f.name))
            for f in dataclasses.fields(item) if f.init})
    if isinstance(item, (tuple, list)):
        return type(item)(map_tensors(fn, v) for v in item)
    if isinstance(item, dict):
        return {k: map_tensors(fn, v) for k, v in item.items()}
    return item


def tensors(item: Any) -> List[torch.Tensor]:
    """The tensors inside ``item``, in :func:`map_tensors`' order."""
    out: List[torch.Tensor] = []
    map_tensors(out.append, item)
    return out


def structure(item: Any) -> Hashable:
    """A hashable description of ``item``: its containers, each tensor's
    shape, dtype and device, and every other leaf's value (the host
    metadata of a ``GraphsTuple``: ``homogeneous``, ``slot_shape``,
    ``pad_aliases_real``, ...; of a ``TypedGraph``: its sets' names and
    real row counts).  Two values with one structure differ only
    in the contents of their tensors."""
    if isinstance(item, torch.Tensor):
        return ("tensor", tuple(item.shape), item.dtype, item.device)
    if dataclasses.is_dataclass(item) and not isinstance(item, type):
        return (type(item).__name__,) + tuple(
            (f.name, structure(getattr(item, f.name)))
            for f in dataclasses.fields(item) if f.init)
    if isinstance(item, (tuple, list)):
        return (type(item).__name__,) + tuple(structure(v) for v in item)
    if isinstance(item, dict):
        return ("dict",) + tuple((k, structure(v))
                                 for k, v in sorted(item.items()))
    try:
        hash(item)
    except TypeError:
        return ("value", repr(item))
    return ("value", item)

