"""The fused FFN branch's share of its roofline, in percent: the least
time of the branch's work (LN -> d x 4d relu -> 4d x d -> residual on
every real row of each feature set of each core, forward and backward,
each byte read once and written once) over the device time in a step of
the kernels that compute it, by the names the profiler prints
(``ln_ffn_residual*``, ``ffn_bwd_*`` and the ``reduce_partials_kernel``
of their weight sums; the LN->matmul backward's kernel of that name is
counted too, which can only lower the share).
"""

FFN_KERNELS = ("ln_ffn_residual", "ffn_bwd_", "reduce_partials_kernel")
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def work(rows: int, d: int, itemsize: int):
    """``(flops, bytes)`` of the branch on ``rows`` rows of width ``d``,
    forward and backward.  Forward: read x and the other branch's sum,
    write y, read both weights.  Backward: read x and dy, write dx, read
    both weights, write their f32 gradients."""
    w = 8 * d * d
    fwd = (16.0 * rows * d * d, 3 * rows * d * itemsize + w * itemsize)
    bwd = (32.0 * rows * d * d,
           3 * rows * d * itemsize + w * itemsize + w * 4)
    return fwd, bwd


def bound_s(rows_per_set, dims, n_cores, itemsize, peaks, dtype):
    t = 0.0
    for rows, d in zip(rows_per_set, dims):
        for flops, nbytes in work(rows, d, itemsize):
            t += max(flops / peaks[dtype], nbytes / peaks["bytes_per_s"])
    return n_cores * t


def read(ctx):
    tl, p = ctx.timeline, ctx.peaks
    if tl is None or p is None or not ctx.steps:
        return None
    spent = tl.device_seconds(lambda o: o.cat == "kernel" and any(
        k in o.name for k in FFN_KERNELS)) / ctx.steps
    if spent <= 0:
        return None
    m, dtype = ctx.config["model"], ctx.config["compute_dtype"]
    rows = [sum(r[i] for r in ctx.rows) / len(ctx.rows) for i in range(3)]
    bound = bound_s(rows, m["core_dims"], m["n_cores"], ITEMSIZE[dtype], p,
                    dtype)
    return 100.0 * bound / spent
