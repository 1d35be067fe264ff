"""Megabytes a step that the captured step copies into its captured
inputs: the change of the program's ``CapturedStep.copy_in_bytes`` over
the traced window (``ctx.copy_in_bytes``, where the run read the counter
and the program has it), over the traced steps."""


def read(ctx):
    n = getattr(ctx, "copy_in_bytes", None)
    if n is None or not ctx.steps:
        return None
    return n / ctx.steps / 1e6
