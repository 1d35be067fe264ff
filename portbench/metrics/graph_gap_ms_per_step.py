"""Idle device milliseconds inside a step: from each whole step's first
phase marker to its ``end`` marker (``harness/spans.py``), the time no
operation ran, which in a replayed CUDA graph is the gaps between its
nodes.  The rest of the window's idle time falls between steps."""

from harness import spans


def read(ctx):
    p = spans.of(ctx)
    if p is None or p.timeline is None or not p.steps():
        return None
    return spans.graph_gap_seconds(p.timeline, p) * 1e3 / len(p.steps())
