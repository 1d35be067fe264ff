"""Idle device milliseconds inside a step: from each whole step's first
phase marker to its ``end`` marker (``harness/spans.py``), the time no
operation ran, which in a replayed CUDA graph is the gaps between its
nodes.  The rest of the window's idle time falls between steps."""

from harness import spans


def read(ctx):
    p, tl = spans.of(ctx), ctx.timeline
    if p is None or tl is None or not p.steps():
        return None
    return spans.graph_gap_seconds(tl, p) * 1e3 / len(p.steps())
