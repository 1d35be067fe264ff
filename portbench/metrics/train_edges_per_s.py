"""Real (unpadded) edges of every training step completed in the window,
over the window's wall time (host clock, ended by a device sync)."""


def read(ctx):
    if not ctx.steps or ctx.window_s <= 0:
        return None
    return sum(r[0] for r in ctx.rows) / ctx.window_s
