"""The 95th percentile over every step of the window of the interval
between CUDA events recorded after consecutive steps on the training
stream (it holds any wait for the host)."""

import statistics


def read(ctx):
    if len(ctx.step_ms) < 2:
        return None
    return statistics.quantiles(ctx.step_ms, n=100, method="inclusive")[94]
