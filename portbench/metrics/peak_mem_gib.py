"""``torch.cuda.max_memory_allocated()`` from the process's start to the
end of the window, before the reference runs, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
