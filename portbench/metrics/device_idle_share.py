"""The share of the traced window in which no kernel, copy or memset ran
on the device: one minus the union of their intervals on the profiler's
timeline over the window's length, in percent."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl.ops or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
