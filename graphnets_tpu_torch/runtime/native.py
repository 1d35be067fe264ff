"""ctypes bindings of the port's native C++ graph runtime (``batcher.cpp``),
the counterpart of ``graphnets_tpu/runtime/native.py``.

``batcher.cpp`` is the port's own copy of the JAX package's runtime, with
the same functions and the same random streams, so both packages build the
same COO arrays and draw the same sampled batches from one seed.  It is
compiled on first use with

    g++ -O3 -shared -fPIC -std=c++17 -pthread batcher.cpp
        -o build/libgraphnets-<hash>.so

into ``build/`` at the root of the checkout (listed in ``.gitignore``; the
hash covers the source and the flags, so an edited source is rebuilt) and
loaded with ``ctypes``.  A failed build raises with the compiler's output.
``GRAPHNETS_TPU_TORCH_NATIVE=0`` (the counterpart of
``GRAPHNETS_TPU_NATIVE``) is the one way to the numpy paths, which are the
JAX module's fallbacks; :func:`available` then says False.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "batch_coo", "csc_from_coo", "sample_layer",
           "gather_rows", "partition_edges", "refine_partition",
           "library_path"]

SRC = Path(__file__).resolve().with_name("batcher.cpp")
BUILD_DIR = SRC.parents[2] / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """False only under ``GRAPHNETS_TPU_TORCH_NATIVE=0``."""
    return os.environ.get("GRAPHNETS_TPU_TORCH_NATIVE", "1") != "0"


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libgraphnets-{h.hexdigest()[:12]}.so"


def _build() -> Path:
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed to build {SRC} (set GRAPHNETS_TPU_TORCH_NATIVE=0 "
            f"for the numpy paths):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None when switched off."""
    global _lib
    if not enabled():
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        i64, i32, i8, f32, u64 = (ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_int8, ctypes.c_float,
                                  ctypes.c_uint64)
        P = ctypes.POINTER
        lib.gt_batch_coo.restype = i64
        lib.gt_batch_coo.argtypes = [P(i8), P(i64), i64, P(i32), P(i32),
                                     P(i32), i64]
        lib.gt_csc_from_coo.restype = None
        lib.gt_csc_from_coo.argtypes = [P(i64), P(i64), i64, i64, P(i64),
                                        P(i64)]
        lib.gt_sample_layer_par.restype = i64
        lib.gt_sample_layer_par.argtypes = [P(i64), P(i64), P(i64), P(i64),
                                            i64, i64, u64, P(i64), P(i64),
                                            i64, i64]
        lib.gt_gather_rows_f32_par.restype = None
        lib.gt_gather_rows_f32_par.argtypes = [P(f32), P(i64), i64, i64,
                                               P(f32), i64]
        lib.gt_partition_edges.restype = None
        lib.gt_partition_edges.argtypes = [P(i64), i64, i64, i64, P(i64),
                                           P(i64)]
        lib.gt_refine_partition.restype = i64
        lib.gt_refine_partition.argtypes = [P(i64), P(i64), i64, i64, i64,
                                            i64, P(i64)]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native paths run: True unless switched off; a failed
    build raises."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _adj_to_coo(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Edges of one adjacency matrix in canonical (column-major) order; an
    entry counts as an edge iff it equals 1."""
    rr, ss = np.nonzero((np.asarray(adj) == 1).T)
    return ss.astype(np.int32), rr.astype(np.int32)


def batch_coo(adjs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical COO of a list of adjacency matrices: ``(senders,
    receivers, n_edge)`` with global node ids, int32."""
    lib = _load()
    ns = np.array([a.shape[0] for a in adjs], np.int64)
    if lib is None:
        offs = np.concatenate([[0], np.cumsum(ns)])
        ss, rs, ne = [], [], []
        for i, a in enumerate(adjs):
            s, r = _adj_to_coo(a)
            ss.append(s + np.int32(offs[i]))
            rs.append(r + np.int32(offs[i]))
            ne.append(len(s))
        cat = (lambda x: np.concatenate(x) if x else np.zeros(0, np.int32))
        return cat(ss), cat(rs), np.array(ne, np.int32)
    flat = np.concatenate([np.ascontiguousarray(a, np.int8).ravel()
                           for a in adjs]) if adjs else np.zeros(0, np.int8)
    max_edges = int((ns ** 2).sum())
    senders = np.empty(max_edges, np.int32)
    receivers = np.empty(max_edges, np.int32)
    n_edge = np.empty(len(adjs), np.int32)
    total = lib.gt_batch_coo(_ptr(flat, ctypes.c_int8),
                             _ptr(ns, ctypes.c_int64), len(adjs),
                             _ptr(senders, ctypes.c_int32),
                             _ptr(receivers, ctypes.c_int32),
                             _ptr(n_edge, ctypes.c_int32), max_edges)
    if total < 0:
        raise RuntimeError("gt_batch_coo: more edges than n^2")
    return senders[:total].copy(), receivers[:total].copy(), n_edge


def csc_from_coo(senders: np.ndarray, receivers: np.ndarray, n: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``(indptr [n + 1], src [E])``: the edges grouped by receiver in a
    stable order, and each receiver's edge range.  The ids must lie in
    ``[0, n)``: the native path trusts them."""
    lib = _load()
    senders = np.ascontiguousarray(senders, np.int64)
    receivers = np.ascontiguousarray(receivers, np.int64)
    if lib is None:
        order = np.argsort(receivers, kind="stable")
        src = senders[order]
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, receivers + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, src
    indptr = np.empty(n + 1, np.int64)
    src = np.empty(len(senders), np.int64)
    lib.gt_csc_from_coo(_ptr(senders, ctypes.c_int64),
                        _ptr(receivers, ctypes.c_int64), len(senders), n,
                        _ptr(indptr, ctypes.c_int64),
                        _ptr(src, ctypes.c_int64))
    return indptr, src


def _default_threads() -> int:
    return max(1, os.cpu_count() or 1)


def sample_layer(indptr: np.ndarray, src: np.ndarray, frontier: np.ndarray,
                 pos: np.ndarray, fanout: int, seed: int,
                 threads: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Up to ``fanout`` incoming edges of each frontier node, without
    replacement: ``(sources, receiver positions)``.  Native only (the
    sampler keeps its own numpy loop for the switched-off path).  Each node
    draws from its own (seed, position)-keyed stream, so the result does
    not depend on ``threads``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("sample_layer needs the native runtime "
                           "(GRAPHNETS_TPU_TORCH_NATIVE=0 is set)")
    frontier = np.ascontiguousarray(frontier, np.int64)
    pos = np.ascontiguousarray(pos, np.int64)
    indptr = np.ascontiguousarray(indptr, np.int64)
    src = np.ascontiguousarray(src, np.int64)
    max_out = len(frontier) * fanout
    out_src = np.empty(max_out, np.int64)
    out_pos = np.empty(max_out, np.int64)
    k = lib.gt_sample_layer_par(_ptr(indptr, ctypes.c_int64),
                                _ptr(src, ctypes.c_int64),
                                _ptr(frontier, ctypes.c_int64),
                                _ptr(pos, ctypes.c_int64), len(frontier),
                                fanout, np.uint64(seed),
                                _ptr(out_src, ctypes.c_int64),
                                _ptr(out_pos, ctypes.c_int64), max_out,
                                threads or _default_threads())
    if k < 0:
        raise RuntimeError("gt_sample_layer_par: output overflow")
    return out_src[:k].copy(), out_pos[:k].copy()


def gather_rows(feat: np.ndarray, idx: np.ndarray,
                out: Optional[np.ndarray] = None,
                threads: Optional[int] = None) -> np.ndarray:
    """Threaded f32 row gather ``out[i] = feat[idx[i]]`` (the features of a
    sampled subgraph; numpy's fancy indexing is single-threaded).  ``out``
    must be a C-contiguous f32 array of at least ``len(idx)`` rows."""
    idx = np.ascontiguousarray(idx, np.int64)
    feat = np.ascontiguousarray(feat, np.float32)
    lib = _load()
    if out is None:
        out = np.empty((len(idx), feat.shape[1]), np.float32)
    if lib is None:
        out[:len(idx)] = feat[idx]
        return out
    if (out.dtype != np.float32 or not out.flags.c_contiguous
            or out.shape[0] < len(idx) or out.shape[1:] != feat.shape[1:]):
        raise ValueError("gather_rows: out must be a C-contiguous f32 "
                         f"array of [>= {len(idx)}, {feat.shape[1]}]")
    lib.gt_gather_rows_f32_par(_ptr(feat, ctypes.c_float),
                               _ptr(idx, ctypes.c_int64), len(idx),
                               feat.shape[1], _ptr(out, ctypes.c_float),
                               threads or _default_threads())
    return out


def partition_edges(receivers: np.ndarray, nodes_per_shard: int,
                    num_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-shard edge counts and the stable shard-grouped permutation of
    edge ids (owner = ``min(receiver // nodes_per_shard, S - 1)``)."""
    lib = _load()
    receivers = np.ascontiguousarray(receivers, np.int64)
    if lib is None:
        owner = np.minimum(receivers // nodes_per_shard, num_shards - 1)
        counts = np.bincount(owner, minlength=num_shards).astype(np.int64)
        perm = np.argsort(owner, kind="stable").astype(np.int64)
        return counts, perm
    counts = np.empty(num_shards, np.int64)
    perm = np.empty(len(receivers), np.int64)
    lib.gt_partition_edges(_ptr(receivers, ctypes.c_int64), len(receivers),
                           nodes_per_shard, num_shards,
                           _ptr(counts, ctypes.c_int64),
                           _ptr(perm, ctypes.c_int64))
    return counts, perm


def refine_partition(indptr: np.ndarray, adj: np.ndarray,
                     assign: np.ndarray, num_shards: int, cap: int,
                     passes: int = 8) -> Tuple[np.ndarray, int]:
    """Greedy min-edge-cut refinement of a node -> shard assignment.

    ``indptr`` / ``adj``: undirected CSR (both edge directions).  Moves a
    node to the plurality shard of its neighbours when that strictly
    reduces the cut and the target shard holds fewer than ``cap`` nodes.
    Returns the refined assignment (a copy) and the number of moves.  The
    numpy path is the JAX module's fallback, which breaks ties otherwise.
    """
    assign = np.ascontiguousarray(assign, np.int64).copy()
    indptr = np.ascontiguousarray(indptr, np.int64)
    adj = np.ascontiguousarray(adj, np.int64)
    N = len(assign)
    lib = _load()
    if lib is not None:
        moves = lib.gt_refine_partition(
            _ptr(indptr, ctypes.c_int64), _ptr(adj, ctypes.c_int64), N,
            num_shards, cap, passes, _ptr(assign, ctypes.c_int64))
        return assign, int(moves)
    counts = np.bincount(assign, minlength=num_shards)
    moves = 0
    for _ in range(passes):
        moved = 0
        for v in range(N):
            nbrs = adj[indptr[v]:indptr[v + 1]]
            if len(nbrs) == 0:
                continue
            hist = np.bincount(assign[nbrs], minlength=num_shards)
            cur = assign[v]
            ok = (hist > hist[cur]) & (counts < cap)
            ok[cur] = False
            if ok.any():
                best = int(np.argmax(np.where(ok, hist, -1)))
                counts[cur] -= 1
                counts[best] += 1
                assign[v] = best
                moved += 1
                moves += 1
        if moved == 0:
            break
    return assign, moves
