"""Seconds from the process's start to the first timed step: imports,
CUDA start-up, kernel libraries, weights and inputs made on the device,
the captured step's warm-up and capture, and the three checked steps."""


def read(ctx):
    return ctx.setup_s
