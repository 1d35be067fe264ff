"""On-disk loader for OGB node-property datasets (ogbn-arxiv /
ogbn-products style), the counterpart of ``graphnets_tpu/data/ogb.py``.

It reads the standard OGB raw directory layout from disk, where a dataset
has been placed, and raises a clear error otherwise (nothing is
downloaded).  The layout (as the official ``ogb`` package's download step
writes it)::

    <root>/<ogbn_arxiv>/
        raw/edge.csv.gz            one "src,dst" pair per line
        raw/node-feat.csv.gz       one comma-separated feature row per node
        raw/node-label.csv.gz      one integer label per node  (optional)
        split/<scheme>/train.csv.gz, valid.csv.gz, test.csv.gz

Uncompressed ``.csv`` files are accepted too.  The result plugs into the
port's :class:`~graphnets_tpu_torch.data.large_graph.LargeGraph` /
:class:`~graphnets_tpu_torch.data.large_graph.NeighborSampler`, which the
node-classification training path consumes.  Both packages read and write
the same files.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
from typing import Dict, Optional

import numpy as np

from .large_graph import LargeGraph

__all__ = ["OGBNodeDataset", "load_ogb_node_dataset", "save_ogb_node_dataset"]


@dataclasses.dataclass
class OGBNodeDataset:
    """A loaded OGB-style node-property dataset."""

    graph: LargeGraph
    splits: Dict[str, np.ndarray]     # "train"/"valid"/"test" -> node ids
    num_classes: int
    name: str

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges


def _open_maybe_gz(path: str) -> io.BufferedReader:
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    if os.path.exists(path):
        return open(path, "rb")
    raise FileNotFoundError(f"{path}[.gz] not found")


def _read_csv(path: str, dtype, cache: bool = False) -> np.ndarray:
    """Parse a (possibly gzipped) headerless CSV.

    Uses pandas' C parser when available (np.loadtxt is ~100x slower and
    impractical at ogbn-products scale: ~123M edge rows).  With ``cache``,
    the parsed array is stored as ``<path>.npy`` next to the raw file on
    first load and memory-loaded afterwards.
    """
    npy = path + ".npy"
    if cache and os.path.exists(npy):
        return np.load(npy)
    with _open_maybe_gz(path) as f:
        try:
            import pandas as pd
            arr = pd.read_csv(f, header=None, dtype=dtype).to_numpy()
        except ImportError:
            arr = np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if cache:
        try:
            np.save(npy, arr)
        except OSError:
            pass  # read-only dataset directory: skip caching
    return arr


def _dataset_dir(root: str, name: str) -> str:
    # official package maps "ogbn-arxiv" -> directory "ogbn_arxiv"
    for cand in (name, name.replace("-", "_")):
        d = os.path.join(root, cand)
        if os.path.isdir(d):
            return d
    raise FileNotFoundError(
        f"OGB dataset '{name}' not found under {root!r} (nothing is "
        f"downloaded: place the extracted dataset there; expected "
        f"<root>/{name.replace('-', '_')}/raw/edge.csv[.gz] etc.)")


def load_ogb_node_dataset(root: str, name: str,
                          make_undirected: bool = True,
                          split_scheme: Optional[str] = None
                          ) -> OGBNodeDataset:
    """Load an OGB node-property dataset from its on-disk raw layout.

    ``make_undirected`` adds reverse edges (standard preprocessing for
    ogbn-arxiv, whose raw edges are directed citations).  ``split_scheme``
    picks the subdirectory of ``split/``; by default the single existing
    scheme is used (``time`` for arxiv, ``sales_ranking`` for products).
    """
    d = _dataset_dir(root, name)
    raw = os.path.join(d, "raw")

    edges = _read_csv(os.path.join(raw, "edge.csv"), np.int64, cache=True)
    senders, receivers = edges[:, 0].copy(), edges[:, 1].copy()
    if make_undirected:
        # Coalesce like official OGB preprocessing (to_undirected): reverse
        # edges are added, then duplicate (src, dst) pairs removed — raw
        # reciprocal pairs / repeated rows must not double edge multiplicity.
        senders, receivers = (np.concatenate([senders, receivers]),
                              np.concatenate([receivers, senders]))
        pairs = np.unique(np.stack([senders, receivers], axis=1), axis=0)
        senders, receivers = pairs[:, 0].copy(), pairs[:, 1].copy()

    node_feat = _read_csv(os.path.join(raw, "node-feat.csv"),
                          np.float32, cache=True)

    # Edge ids feed the native CSC construction (runtime/batcher.cpp),
    # which trusts its inputs: an out-of-range id from a corrupt or mismatched
    # dataset would write out of bounds, so validate here.
    n_nodes = node_feat.shape[0]
    for arr, what in ((senders, "source"), (receivers, "destination")):
        if len(arr) and (arr.min() < 0 or arr.max() >= n_nodes):
            bad = arr[(arr < 0) | (arr >= n_nodes)][0]
            raise ValueError(
                f"{os.path.join(raw, 'edge.csv')}: {what} node id {bad} out "
                f"of range [0, {n_nodes}) given node-feat.csv with "
                f"{n_nodes} rows — edge file does not match feature file")

    labels: Optional[np.ndarray] = None
    num_classes = 0
    try:
        raw_labels = _read_csv(os.path.join(raw, "node-label.csv"),
                               np.float64, cache=True).reshape(-1)
        # OGB marks unlabeled nodes with -1 or NaN; exclude them from the
        # class count and keep them as -1 sentinels in int labels.
        valid = np.isfinite(raw_labels) & (raw_labels >= 0)
        labels = np.where(valid, raw_labels, -1).astype(np.int64)
        if len(labels) != n_nodes:
            raise ValueError(
                f"{os.path.join(raw, 'node-label.csv')}: {len(labels)} "
                f"labels != {n_nodes} nodes in node-feat.csv")
        num_classes = int(labels[valid].max()) + 1 if valid.any() else 0
    except FileNotFoundError:
        pass

    splits: Dict[str, np.ndarray] = {}
    split_root = os.path.join(d, "split")
    if os.path.isdir(split_root):
        if split_scheme is None:
            schemes = sorted(os.listdir(split_root))
            if len(schemes) != 1:
                raise ValueError(
                    f"multiple split schemes {schemes}; pass split_scheme=")
            split_scheme = schemes[0]
        sdir = os.path.join(split_root, split_scheme)
        for part in ("train", "valid", "test"):
            try:
                splits[part] = _read_csv(os.path.join(sdir, f"{part}.csv"),
                                         np.int64).reshape(-1)
            except FileNotFoundError:
                pass

    graph = LargeGraph.from_coo(senders, receivers, node_feat, labels)
    return OGBNodeDataset(graph=graph, splits=splits,
                          num_classes=num_classes, name=name)


def save_ogb_node_dataset(root: str, name: str, senders: np.ndarray,
                          receivers: np.ndarray, node_feat: np.ndarray,
                          labels: Optional[np.ndarray] = None,
                          splits: Optional[Dict[str, np.ndarray]] = None,
                          split_scheme: str = "random",
                          compress: bool = True) -> str:
    """Write a dataset in the OGB raw layout (fixture/testing utility —
    also lets users convert their own graphs into the loadable format)."""
    d = os.path.join(root, name.replace("-", "_"))
    raw = os.path.join(d, "raw")
    os.makedirs(raw, exist_ok=True)

    def _write(path: str, arr: np.ndarray, fmt: str):
        opener = (lambda p: gzip.open(p + ".gz", "wb")) if compress \
            else (lambda p: open(p, "wb"))
        with opener(path) as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)

    _write(os.path.join(raw, "edge.csv"),
           np.stack([senders, receivers], axis=1), "%d")
    _write(os.path.join(raw, "node-feat.csv"), node_feat, "%.8g")
    if labels is not None:
        _write(os.path.join(raw, "node-label.csv"),
               np.asarray(labels).reshape(-1, 1), "%d")
    if splits:
        sdir = os.path.join(d, "split", split_scheme)
        os.makedirs(sdir, exist_ok=True)
        for part, ids in splits.items():
            _write(os.path.join(sdir, f"{part}.csv"),
                   np.asarray(ids).reshape(-1, 1), "%d")
    return d
