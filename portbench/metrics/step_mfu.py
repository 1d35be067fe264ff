"""Model FLOPs of a step over the traced steps' mean time, as a share of
the card's peak in the configuration's compute type (bf16 on the tensor
cores; f32 on the CUDA cores, TF32 being off), in percent.  The FLOPs are
the configuration's model's (``models/<kind>.step_flops``): the forward's
products on real rows, the backward twice the forward, no recompute."""


def read(ctx):
    tl, p = ctx.timeline, ctx.peaks
    if tl is None or p is None or not ctx.steps or not tl.ops:
        return None
    peak = p[ctx.config["compute_dtype"]]
    step_s = tl.window_s / ctx.steps
    return 100.0 * (sum(ctx.step_flops) / ctx.steps) / step_s / peak
