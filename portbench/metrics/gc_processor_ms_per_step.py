"""Busy device milliseconds a step in GraphCast's processor, forward and
backward: the program's sub-phases ``processor`` and ``processor_bwd``
(its stage markers, ``harness/spans.py``), over the traced window's whole
steps.  ``None`` where the program has no such markers."""

from harness import spans


def read(ctx):
    parts = [spans.phase_ms(ctx, s) for s in ("processor", "processor_bwd")]
    return None if None in parts else sum(parts)
