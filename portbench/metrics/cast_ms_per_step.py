"""Device milliseconds a step in dtype conversions and copies: the
kernels whose name holds ``copy_kernel`` (PyTorch's cast and copy
kernels) and the device's memcpy operations."""


def _is_cast_or_copy(op) -> bool:
    return op.cat == "gpu_memcpy" or (op.cat == "kernel"
                                      and "copy_kernel" in op.name)


def read(ctx):
    tl = ctx.timeline
    if tl is None or not ctx.steps or not tl.ops:
        return None
    return tl.device_seconds(_is_cast_or_copy) * 1e3 / ctx.steps
