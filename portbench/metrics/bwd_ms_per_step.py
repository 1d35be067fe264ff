"""Busy device milliseconds a step in the backward (autograd): the union
of the device's operations between the program's ``backward`` and
``optimizer`` phase markers (``harness/spans.py``), over the traced
window's whole steps."""

from harness import spans


def read(ctx):
    return spans.phase_ms(ctx, "backward")
