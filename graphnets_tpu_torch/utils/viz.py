"""SVG graph rendering (counterpart of ``graphnets_tpu/utils/viz.py``, of
which it is a copy, so both give the same string for the same inputs):
nodes on a regular n-gon, directed edges as lines, per-node value labels
and fills, per-edge colours.  It works on host numpy data and needs no
library beyond numpy.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["render_graph_svg", "sort_input_svg", "sort_target_svg"]


def _ngon(n: int, radius: float, cx: float, cy: float):
    """Vertices of a regular n-gon, first vertex at the top, clockwise."""
    pts = []
    for i in range(n):
        ang = -math.pi / 2 + 2 * math.pi * i / max(n, 1)
        pts.append((cx + radius * math.cos(ang), cy + radius * math.sin(ang)))
    return pts


def render_graph_svg(
    n_nodes: int,
    edges: Sequence[Tuple[int, int]],
    node_value: Optional[Callable[[int], Optional[str]]] = None,
    node_fill: Optional[Callable[[int], str]] = None,
    node_stroke: str = "#333",
    edge_stroke: Optional[Callable[[int], str]] = None,
    size: int = 400,
    node_radius: int = 16,
) -> str:
    """Render a directed graph as an SVG string.

    ``edges`` is a list of ``(src, dst)`` pairs; self-loops are drawn as small
    circles.  ``node_value(i)`` returns the label inside node ``i`` (or
    None), ``node_fill(i)`` its fill color, ``edge_stroke(k)`` the color of
    edge ``k``.
    """
    cx = cy = size / 2
    pts = _ngon(n_nodes, size / 2 - 2 * node_radius, cx, cy)
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
           f'height="{size}" viewBox="0 0 {size} {size}">']
    out.append(
        '<defs><marker id="arr" viewBox="0 0 10 10" refX="9" refY="5" '
        'markerWidth="6" markerHeight="6" orient="auto-start-reverse">'
        '<path d="M 0 0 L 10 5 L 0 10 z" fill="context-stroke"/>'
        "</marker></defs>")
    for k, (s, r) in enumerate(edges):
        color = edge_stroke(k) if edge_stroke else "#999"
        if s == r:
            x, y = pts[s]
            out.append(
                f'<circle cx="{x + node_radius:.1f}" cy="{y - node_radius:.1f}" '
                f'r="{node_radius * 0.7:.1f}" fill="none" '
                f'stroke="{color}" stroke-width="1.5"/>')
            continue
        (x1, y1), (x2, y2) = pts[s], pts[r]
        # Trim the segment so the arrowhead lands on the node boundary.
        dx, dy = x2 - x1, y2 - y1
        d = math.hypot(dx, dy) or 1.0
        ux, uy = dx / d, dy / d
        x1t, y1t = x1 + ux * node_radius, y1 + uy * node_radius
        x2t, y2t = x2 - ux * (node_radius + 2), y2 - uy * (node_radius + 2)
        out.append(
            f'<line x1="{x1t:.1f}" y1="{y1t:.1f}" x2="{x2t:.1f}" '
            f'y2="{y2t:.1f}" stroke="{color}" stroke-width="1.5" '
            'marker-end="url(#arr)"/>')
    for i, (x, y) in enumerate(pts):
        fill = node_fill(i) if node_fill else "#fff"
        out.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{node_radius}" '
            f'fill="{fill}" stroke="{node_stroke}" stroke-width="1.5"/>')
        label = node_value(i) if node_value else None
        if label is not None:
            out.append(
                f'<text x="{x:.1f}" y="{y + 4:.1f}" text-anchor="middle" '
                f'font-family="sans-serif" font-size="12">{label}</text>')
    out.append("</svg>")
    return "\n".join(out)


def sort_input_svg(nf: np.ndarray, size: int = 400) -> str:
    """Input graph of the sort task: fully-connected n-gon with the integer
    value (argmax of the one-hot node feature, 1-based like the reference's
    ``onecold``) inside each node."""
    nf = np.asarray(nf)
    values = np.argmax(nf, axis=-1) + 1
    n = nf.shape[0]
    edges = [(i, j) for i in range(n) for j in range(n) if i != j]
    return render_graph_svg(
        n, edges,
        node_value=lambda i: str(int(values[i])),
        size=size)


def sort_target_svg(nodes01: np.ndarray, edges01: np.ndarray,
                    size: int = 400) -> str:
    """Target/prediction graph of the sort task: the full edge-slot grid
    (column-major (src, dst) enumeration like the reference's dense edge
    space) with "consecutive-in-sorted-order" edges drawn green and the
    "is minimum" node filled green."""
    nodes01 = np.asarray(nodes01).astype(int)
    edges01 = np.asarray(edges01).astype(int).reshape(-1)
    n = len(nodes01)
    if edges01.size != n * n:
        raise ValueError("edges01 must cover the full n*n slot grid")
    pairs = []
    for j in range(n):        # column-major slots: slot = j * n + i
        for i in range(n):
            if edges01[j * n + i]:
                pairs.append((i, j))
    return render_graph_svg(
        n, pairs,
        node_value=lambda i: None,
        node_fill=lambda i: "green" if nodes01[i] == 1 else "#fff",
        node_stroke="#ccc",
        edge_stroke=lambda k: "green",
        size=size)
