"""Host milliseconds a step in the port's ``batch()`` of the step's input
and target (host clock around the two calls), mean over the traced
steps."""


def read(ctx):
    s = ctx.host_batch_s
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
