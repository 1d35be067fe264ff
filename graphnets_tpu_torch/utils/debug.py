"""Debug-mode guards of the PyTorch port (counterpart of
``graphnets_tpu/utils/debug.py`` and the debug checks of
``graphnets_tpu/ops/scatter.py`` and ``ops/pallas/gather.py``).

The failure modes of a batch of graphs are NaN / Inf values, out-of-range
indices and layouts that break the contracts the kernels rely on without
checking them (ascending ids; padded rows targeting padding only).  These
helpers make them loud.  All of them read tensors on the host, so they
sync with the device and cannot run inside a CUDA-graph capture.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from . import config

__all__ = ["checked", "assert_finite", "validate_graph",
           "check_sorted_pad_safe", "check_sorted_in_range"]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def check_sorted_pad_safe(seg: torch.Tensor,
                          mask: Optional[torch.Tensor]) -> None:
    """Raise unless ``segment_sum(sorted_pad_safe=True)``'s contract holds:
    segment ids ascending, and padded rows (``mask`` False) target only
    segments no real row targets, so that skipping the mask cannot leak
    padding into real outputs."""
    seg = _host(seg)
    if len(seg) > 1 and (np.diff(seg) < 0).any():
        k = int(np.argmax(np.diff(seg) < 0))
        raise ValueError(
            "segment_sum(sorted_pad_safe=True): segment ids are not sorted "
            f"ascending (ids[{k}]={seg[k]} > ids[{k + 1}]={seg[k + 1]}). "
            "Sorted order is the canonical edge order produced by batch(); "
            "pass sorted_pad_safe=False for arbitrary-order ids.")
    if mask is None:
        return
    mask = _host(mask).astype(bool)
    real, padded = seg[mask], seg[~mask]
    if len(real) and len(padded):
        overlap = np.intersect1d(np.unique(real), np.unique(padded))
        if overlap.size:
            raise ValueError(
                "segment_sum(sorted_pad_safe=True): padded rows target "
                f"segment(s) {overlap[:8].tolist()} that real rows also "
                "target; padding would leak into real outputs. batch() "
                "guarantees padded edges point at a padding node (in the "
                "uniform slot layout, each slot's own last node slot); "
                "check custom GraphsTuple construction.")


def check_sorted_in_range(idx: torch.Tensor, num_rows: int,
                          what: str = "sorted_gather") -> None:
    """Raise unless the sorted gather's contract holds: ids ascending and
    within ``[0, num_rows)``.  The kernel reads an out-of-range id as a
    zero row and may count a row twice for unsorted ids."""
    a = _host(idx)
    if len(a) > 1 and (np.diff(a) < 0).any():
        k = int(np.argmax(np.diff(a) < 0))
        raise ValueError(
            f"{what}: idx is not ascending (idx[{k}]={a[k]} > "
            f"idx[{k + 1}]={a[k + 1]}); the kernel requires the canonical "
            "sorted order.")
    if len(a) and (int(a.min()) < 0 or int(a.max()) >= num_rows):
        raise ValueError(
            f"{what}: idx out of range [0, {num_rows}): min={int(a.min())} "
            f"max={int(a.max())}. Out-of-range ids would read as zeros.")


def _leaves(item: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested value, paths spelled as
    ``jax.tree_util.keystr`` spells them."""
    if dataclasses.is_dataclass(item) and not isinstance(item, type):
        for f in dataclasses.fields(item):
            yield from _leaves(getattr(item, f.name), f"{path}.{f.name}")
    elif isinstance(item, dict):
        for k, v in item.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(item, (tuple, list)):
        for i, v in enumerate(item):
            yield from _leaves(v, f"{path}[{i}]")
    elif item is not None:
        yield path, item


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` if a floating tensor or array inside
    ``tree`` holds a NaN or an Inf (a host check: it syncs with the
    device)."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(
                torch.isfinite(leaf.detach()).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")


def checked(fn: Callable) -> Callable:
    """``fn`` with the port's debug checks on for the call and its output
    held finite: the index guards of the sorted segment sum and the sorted
    gather raise on unsorted ids, padding that aliases a real segment and
    out-of-range gather ids, ``batch`` validates what it builds, and a NaN
    or Inf anywhere in the output raises ``FloatingPointError``.

    This is not ``jax.experimental.checkify``: torch has no functional
    error channel.  It does not catch a NaN or Inf that never reaches the
    output (a masked-out padded slot, a value a ``where`` drops), an
    integer division by zero, or an out-of-range index outside the guarded
    calls (plain torch indexing raises on the CPU and asserts on the
    device by itself).  Its checks sync with the device, so a CUDA-graph
    capture refuses to run inside it."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        was = config.debug_checks()
        config.enable_debug_checks(True)
        try:
            out = fn(*args, **kwargs)
        finally:
            config.enable_debug_checks(was)
        assert_finite(out, "output")
        return out

    return wrapper


def validate_graph(g) -> None:
    """Host-side structural validation of a ``GraphsTuple``: index ranges,
    mask consistency, counts, the canonical order and the padding layout.
    Raises ``ValueError`` on the first violation."""

    def need(ok, msg: str) -> None:
        if not ok:
            raise ValueError(f"validate_graph: {msg}")

    s, r = _host(g.senders), _host(g.receivers)
    ng, eg = _host(g.node_graph), _host(g.edge_graph)
    nm = _host(g.node_mask).astype(bool)
    em = _host(g.edge_mask).astype(bool)
    gm = _host(g.graph_mask).astype(bool)
    N, E, G = len(nm), len(em), len(gm)
    need(len(s) == E and len(r) == E and len(eg) == E and len(ng) == N,
         "index arrays disagree with the masks' lengths")
    need(s.min(initial=0) >= 0 and s.max(initial=-1) < max(N, 1),
         "senders out of range")
    need(r.min(initial=0) >= 0 and r.max(initial=-1) < max(N, 1),
         "receivers out of range")
    need(eg.max(initial=-1) < G and ng.max(initial=-1) < G,
         "graph ids out of range")
    n_node, n_edge = _host(g.n_node), _host(g.n_edge)
    need(n_node.sum() == nm.sum(), "n_node inconsistent with node_mask")
    need(n_edge.sum() == em.sum(), "n_edge inconsistent with edge_mask")
    if em.any():
        # The canonical order: receivers non-decreasing over real edges
        # (what the sorted segment sum relies on); real edges reference
        # real nodes.
        need((np.diff(r[em]) >= 0).all(),
             "receivers not sorted (canonical order)")
        need(nm[s[em]].all() and nm[r[em]].all(),
             "real edge references a padded node")
    if g.slot_shape is not None and g.pad_aliases_real:
        # Uniform slot layout: real slots are a prefix of each graph slot's
        # range, and padded edges target their slot's last node slot.
        ns, es = g.slot_shape
        need(N % ns == 0 and E % es == 0 and N // ns == E // es == G,
             f"slot shape {g.slot_shape} does not tile ({N}, {E}, {G})")
        for b in range(G):
            nmb = nm[b * ns:(b + 1) * ns]
            emb = em[b * es:(b + 1) * es]
            need(nmb[:int(nmb.sum())].all(),
                 f"slot {b}: real nodes not a prefix")
            need(emb[:int(emb.sum())].all(),
                 f"slot {b}: real edges not a prefix")
            if (~emb).any():
                tgt = s[b * es:(b + 1) * es][~emb]
                need((tgt == (b + 1) * ns - 1).all()
                     and not nm[(b + 1) * ns - 1],
                     f"slot {b}: padded edges must target the slot's last "
                     "(padding) node slot")
    else:
        # Real slots are contiguous at the front.
        need(nm[:int(nm.sum())].all(), "real nodes not contiguous at the "
             "front")
        need(em[:int(em.sum())].all(), "real edges not contiguous at the "
             "front")
    for f, count, what in ((g.ef, E, "ef"), (g.nf, N, "nf"),
                           (g.gf, G, "gf")):
        if f is not None:
            need(f.shape[0] == count, f"{what} rows != {what} slots")
