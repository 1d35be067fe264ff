"""Megabytes a step that the captured step copies into its captured
inputs: the change of the program's counter ``copy_in_bytes``
(``CapturedStep.copy_in_bytes``, or the feed's own) over the traced
stretch (``ctx.counters``), over the traced steps."""


def read(ctx):
    n = (getattr(ctx, "counters", None) or {}).get("copy_in_bytes")
    if n is None or not ctx.steps:
        return None
    return n / ctx.steps / 1e6
