"""Host milliseconds a step inside the program's ``gn.step`` span: the
captured step's call (key lookup, copy-in, graph launch, output clones),
mean over the traced steps."""

from harness import spans


def read(ctx):
    return spans.span_ms(ctx, "gn.step")
