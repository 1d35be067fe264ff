"""Device kernels a step in the profile of the traced steps (copies and
memsets are not kernels), the program's phase markers
(``gn_phase_<name>``, enqueued only while its tracing switch is on) left
out."""

from harness import spans


def read(ctx):
    tl = ctx.timeline
    if tl is None or not ctx.steps:
        return None
    n = sum(not k.name.startswith(spans.MARKER) for k in tl.kernels())
    return n / ctx.steps if n else None
