"""Host milliseconds a step inside the program's ``gn.batch.to_device``
span: the copies of ``graph.batch``'s arrays to the card, mean over the
traced steps."""

from harness import spans


def read(ctx):
    return spans.span_ms(ctx, "gn.batch.to_device")
