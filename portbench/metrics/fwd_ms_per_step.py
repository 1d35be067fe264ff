"""Busy device milliseconds a step in the forward (the parameter cast,
the model and the loss): the union of the device's operations between
the program's ``forward`` and ``backward`` phase markers
(``harness/spans.py``), over the traced window's whole steps."""

from harness import spans


def read(ctx):
    return spans.phase_ms(ctx, "forward")
