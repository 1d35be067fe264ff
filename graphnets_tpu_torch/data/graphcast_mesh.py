"""GraphCast's graph, built from its configuration alone (Lam et al.,
arXiv:2212.12794 §3.1 and Supplementary §3; the released
``graphcast/icosahedral_mesh.py``, ``grid_mesh_connectivity.py`` and
``model_utils.py``), with numpy only.

* **Mesh**: a regular icosahedron (GraphCast's orientation) refined
  ``mesh_size`` times, each triangle into four through its edges' midpoints
  pushed onto the unit sphere.  A refinement keeps the coarser nodes first,
  so every level's nodes are a prefix of the finest level's; the
  multi-mesh is the finest nodes with the edges of every level 0 ...
  ``mesh_size`` merged, both directions.
* **Grid**: the equiangular latitude-longitude grid at ``resolution``
  degrees, latitudes -90 ... 90 inclusive, node ``lat_row * n_lon +
  lon_col``.
* **Grid->mesh** (g2m): an edge from each grid node to every mesh node
  within ``radius_fraction`` of the finest level's longest edge (chord
  length on the unit sphere).
* **Mesh->grid** (m2g): the three nodes of the finest triangle that holds
  each grid node, found by descending the refinement from the 20 faces to
  the children; a point on an edge or a vertex goes to the first child (in
  the refinement's order) that holds it best, so the choice is fixed.
* **Features**: each node ``[cos lat, sin lon, cos lon]``; each edge the
  sender-minus-receiver vector in the receiver's local frame (rotated so the
  receiver sits at latitude 0, longitude 0) with its length in front, over
  the edge set's longest length (4 features).
* **Latitude weights**: GraphCast's ``normalized_latitude_weights`` for a
  grid with poles, one per grid node (``training/losses``).

Every edge set is ordered by receiver, then sender.  :func:`batch_samples`
lays ``samples`` copies of the graph out block-diagonally on the device as a
``typed_graph.TypedGraph``, padded to friendly row counts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..training.losses import graphcast_latitude_weights
from ..typed_graph import EdgeSet, TypedGraph
from ..utils.config import resolve_device
from ..utils.profiling import span

__all__ = ["GraphCastGraph", "build_graphcast_graph", "batch_samples",
           "icosahedral_meshes"]

# Each edge set: its name, sender node set, receiver node set.
EDGE_SETS = (("g2m", "grid", "mesh"), ("mesh", "mesh", "mesh"),
             ("m2g", "mesh", "grid"))
# A batch's rows are padded to these multiples: the sorted gather's table
# and the sorted segment sum's rows (ops/kernels gather, segment_sum).
NODE_MULTIPLE, EDGE_MULTIPLE = 32, 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _icosahedron() -> Tuple[np.ndarray, np.ndarray]:
    """The 12 vertices (unit vectors, GraphCast's order and rotation) and
    20 faces (vertex ids counter-clockwise seen from outside, sorted)."""
    phi = (1 + math.sqrt(5)) / 2
    v = []
    for c1 in (1.0, -1.0):
        for c2 in (phi, -phi):
            v += [(c1, c2, 0.0), (0.0, c1, c2), (c2, 0.0, c1)]
    v = np.array(v) / math.hypot(1.0, phi)
    # GraphCast's rotation about y, so the mesh is symmetric about the
    # equator (``icosahedral_mesh.get_icosahedron``).
    angle = (math.pi - 2 * math.asin(phi / math.sqrt(3))) / 2
    c, s = math.cos(angle), math.sin(angle)
    v = v @ np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    d = np.linalg.norm(v[:, None] - v[None], axis=-1)
    edge = d[d > 1e-9].min()
    adj = np.abs(d - edge) < 1e-6
    faces = []
    for a in range(12):
        for b in range(a + 1, 12):
            for c_ in range(b + 1, 12):
                if adj[a, b] and adj[b, c_] and adj[a, c_]:
                    f = [a, b, c_]
                    if np.dot(np.cross(v[b] - v[a], v[c_] - v[a]), v[a]) < 0:
                        f = [a, c_, b]
                    faces.append(f)
    return v, np.array(faces, np.int64)


def _refine(v: np.ndarray, faces: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """One refinement: the old vertices first, then each edge's midpoint on
    the sphere (in the order of the sorted edges); face ``f`` becomes faces
    ``4f .. 4f + 3`` (the corners ``a``, ``b``, ``c``, then the middle),
    every one counter-clockwise."""
    pairs = faces[:, [[0, 1], [1, 2], [2, 0]]]             # [F, 3, 2]
    keys = np.sort(pairs, axis=-1).reshape(-1, 2)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    mid = v[uniq[:, 0]] + v[uniq[:, 1]]
    mid /= np.linalg.norm(mid, axis=-1, keepdims=True)
    m = (len(v) + inv.reshape(-1)).reshape(-1, 3)          # ab, bc, ca
    a, b, c = faces.T
    ab, bc, ca = m.T
    children = np.stack([np.stack([a, ab, ca], -1), np.stack([ab, b, bc], -1),
                         np.stack([ca, bc, c], -1), np.stack([ab, bc, ca], -1)],
                        axis=1)
    return np.concatenate([v, mid]), children.reshape(-1, 3)


def icosahedral_meshes(mesh_size: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The finest level's vertices and every level's faces (level ``l``'s
    vertex ids are the first ``10 * 4**l + 2`` of the finest)."""
    v, faces = _icosahedron()
    levels = [faces]
    for _ in range(mesh_size):
        v, faces = _refine(v, faces)
        levels.append(faces)
    return v, levels


def _latlon(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Latitude and longitude (radians) of unit vectors."""
    return (np.arcsin(np.clip(p[:, 2], -1.0, 1.0)),
            np.arctan2(p[:, 1], p[:, 0]))


def _node_features(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    return np.stack([np.cos(lat), np.sin(lon), np.cos(lon)],
                    -1).astype(np.float32)


def _edge_features(sender_pos: np.ndarray, receiver_pos: np.ndarray
                   ) -> np.ndarray:
    """``[|d|, d]`` over the set's largest ``|d|``, ``d`` the sender minus
    the receiver with both rotated so the receiver is at (1, 0, 0)
    (``model_utils.get_bipartite_relative_position_in_receiver_local_coordinates``)."""
    lat, lon = _latlon(receiver_pos)

    def rotate(p):
        # About z by -lon, then about y by lat: the receiver to (1, 0, 0).
        cl, sl = np.cos(lon), np.sin(lon)
        x = cl * p[:, 0] + sl * p[:, 1]
        y = -sl * p[:, 0] + cl * p[:, 1]
        ca, sa = np.cos(lat), np.sin(lat)
        return np.stack([ca * x + sa * p[:, 2], y, -sa * x + ca * p[:, 2]],
                        -1)

    d = rotate(sender_pos) - rotate(receiver_pos)
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    return (np.concatenate([norm, d], -1) / norm.max()).astype(np.float32)


def _by_receiver(senders: np.ndarray, receivers: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    order = np.lexsort((senders, receivers))
    return senders[order], receivers[order]


def _multi_mesh_edges(levels: List[np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    pairs = np.concatenate([f[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)
                            for f in levels])
    pairs = np.unique(np.concatenate([pairs, pairs[:, ::-1]]), axis=0)
    return _by_receiver(pairs[:, 0], pairs[:, 1])


def _grid_to_mesh(grid_pos: np.ndarray, grid_lat: np.ndarray,
                  mesh_pos: np.ndarray, radius: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Every (grid node, mesh node) pair within chord ``radius``: for each
    latitude row of the grid, only the mesh nodes within the radius's
    angle in latitude are measured."""
    mesh_lat, _ = _latlon(mesh_pos)
    order = np.argsort(mesh_lat, kind="stable")
    sorted_lat = mesh_lat[order]
    angle = 2 * math.asin(radius / 2) + 1e-9
    senders, receivers = [], []
    rows = np.unique(grid_lat)
    for lat in rows:
        g = np.flatnonzero(grid_lat == lat)
        lo, hi = np.searchsorted(sorted_lat, [lat - angle, lat + angle])
        cand = order[lo:hi]
        d2 = ((grid_pos[g, None, :] - mesh_pos[None, cand, :]) ** 2).sum(-1)
        gi, mi = np.nonzero(d2 <= radius * radius)
        senders.append(g[gi])
        receivers.append(cand[mi])
    return _by_receiver(np.concatenate(senders), np.concatenate(receivers))


def _containing_faces(points: np.ndarray, v: np.ndarray,
                      levels: List[np.ndarray]) -> np.ndarray:
    """For each point, the finest face that holds it: at each level the
    child of the previous level's face with the largest least distance
    from its three edge planes (the first such child on ties)."""

    def planes(faces):                                   # [F, 3, 3]
        a, b, c = (v[faces[:, i]] for i in range(3))
        n = np.stack([np.cross(a, b), np.cross(b, c), np.cross(c, a)], 1)
        return n / np.linalg.norm(n, axis=-1, keepdims=True)

    def score(n):                                        # [P, k, 3, 3]
        return np.einsum("pkej,pj->pke", n, points).min(-1)

    n0 = planes(levels[0])
    best = np.argmax(score(np.broadcast_to(n0, (len(points),) + n0.shape)),
                     1)
    for faces in levels[1:]:
        kids = 4 * best[:, None] + np.arange(4)
        best = kids[np.arange(len(points)),
                    np.argmax(score(planes(faces)[kids]), 1)]
    return levels[-1][best]


@dataclasses.dataclass
class GraphCastGraph:
    """One sample's graph on the host: node features by set (``grid``,
    ``mesh``: ``[N, 3]`` float32), edge sets by name (``g2m``, ``mesh``,
    ``m2g``: int64 senders and receivers, receivers ascending, and float32
    ``[E, 4]`` features), the grid's latitudes and longitudes (degrees, a
    node each) and its latitude weights (a node each, mean 1)."""
    nodes: Dict[str, np.ndarray]
    edges: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]
    grid_lat: np.ndarray
    grid_lon: np.ndarray
    latitude_weights: np.ndarray


def build_graphcast_graph(resolution: float = 1.0, mesh_size: int = 5,
                          radius_fraction: float = 0.6) -> GraphCastGraph:
    """GraphCast's graph for a ``resolution``-degree grid and a multi-mesh
    of levels 0 ... ``mesh_size`` (GraphCast_small: 1.0, 5, 0.6)."""
    with span("gn.graphcast.build"):
        n_lat = int(round(180 / resolution)) + 1
        n_lon = int(round(360 / resolution))
        lat_deg = -90.0 + resolution * np.arange(n_lat)
        lon_deg = resolution * np.arange(n_lon)
        glat = np.repeat(np.deg2rad(lat_deg), n_lon)
        glon = np.tile(np.deg2rad(lon_deg), n_lat)
        gpos = np.stack([np.cos(glat) * np.cos(glon),
                         np.cos(glat) * np.sin(glon), np.sin(glat)], -1)
        mpos, levels = icosahedral_meshes(mesh_size)
        mlat, mlon = _latlon(mpos)
        finest = levels[-1][:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)
        longest = np.linalg.norm(mpos[finest[:, 0]] - mpos[finest[:, 1]],
                                 axis=-1).max()
        pos = {"grid": gpos, "mesh": mpos}
        ends = {}
        ends["g2m"] = _grid_to_mesh(gpos, glat, mpos,
                                    radius_fraction * longest)
        ends["mesh"] = _multi_mesh_edges(levels)
        tri = np.sort(_containing_faces(gpos, mpos, levels), axis=1)
        ends["m2g"] = (tri.reshape(-1),
                       np.repeat(np.arange(len(gpos)), 3))
        edges = {}
        for name, src, dst in EDGE_SETS:
            s, r = ends[name]
            edges[name] = (s, r, _edge_features(pos[src][s], pos[dst][r]))
        return GraphCastGraph(
            nodes={"grid": _node_features(glat, glon),
                   "mesh": _node_features(mlat, mlon)},
            edges=edges, grid_lat=np.repeat(lat_deg, n_lon),
            grid_lon=np.tile(lon_deg, n_lat),
            latitude_weights=np.repeat(graphcast_latitude_weights(lat_deg),
                                       n_lon).astype(np.float32))


def batch_samples(graph: GraphCastGraph, samples: int, *, device=None
                  ) -> TypedGraph:
    """``samples`` copies of ``graph`` as one block-diagonal
    ``TypedGraph`` on ``device``: sample ``b``'s rows of each set follow
    sample ``b - 1``'s, so every edge set stays ordered by (sample,
    receiver).  Each node set is padded to a multiple of ``NODE_MULTIPLE``
    rows with at least one padding row, each edge set to a multiple of
    ``EDGE_MULTIPLE`` with padding edges from the first padding row of the
    sender set to that of the receiver set, all with zero features.  Node
    features are the structural ones; a model's grid inputs replace them
    (``TypedGraph.with_nodes``)."""
    device = resolve_device(device)
    nodes, real = {}, {}
    for name, f in graph.nodes.items():
        n = f.shape[0] * samples
        out = np.zeros((_round_up(n + 1, NODE_MULTIPLE), f.shape[1]),
                       np.float32)
        out[:n] = np.tile(f, (samples, 1))
        nodes[name], real[name] = torch.from_numpy(out).to(device), n
    edges = {}
    for name, src, dst in EDGE_SETS:
        s, r, f = graph.edges[name]
        ns, nr = graph.nodes[src].shape[0], graph.nodes[dst].shape[0]
        b = np.arange(samples)[:, None]
        e = s.shape[0] * samples
        rows = _round_up(e, EDGE_MULTIPLE)
        snd = np.full(rows, real[src], np.int32)
        rcv = np.full(rows, real[dst], np.int32)
        feat = np.zeros((rows, f.shape[1]), np.float32)
        snd[:e] = (s[None] + b * ns).reshape(-1)
        rcv[:e] = (r[None] + b * nr).reshape(-1)
        feat[:e] = np.tile(f, (samples, 1))
        edges[name] = EdgeSet(
            senders=torch.from_numpy(snd).to(device),
            receivers=torch.from_numpy(rcv).to(device),
            features=torch.from_numpy(feat).to(device), num_real=e)
    return TypedGraph(nodes=nodes, edges=edges, num_real_nodes=real)
