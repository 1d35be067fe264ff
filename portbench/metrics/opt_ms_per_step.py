"""Busy device milliseconds a step in the optimizer (AdamW, and the zero
gradients of the parameters the loss does not reach): the union of the
device's operations between the program's ``optimizer`` and ``metrics``
phase markers (``harness/spans.py``), over the traced window's whole
steps."""

from harness import spans


def read(ctx):
    return spans.phase_ms(ctx, "optimizer")
