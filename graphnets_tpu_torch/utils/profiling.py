"""Tracing and profiling hooks (counterpart of
``graphnets_tpu/utils/profiling.py``): a ``torch.profiler`` trace written
as a Chrome trace (viewable in Perfetto), named ranges for traces and
Nsight, and a wall-clock step timer."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block (host ops, and device kernels when a card is
    present) and write ``log_dir/trace_<pid>.json`` (Chrome trace format)
    when it ends.  Yields the profiler, whose ``key_averages()`` sums the
    time by op or kernel."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range around a block: a ``record_function`` range in
    ``torch.profiler`` traces and, on a card, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock step timing with the first ``warmup`` steps left out
    (kernel builds, captures).  It reads the host clock only: the caller
    waits on the device inside the timed block (``torch.cuda.synchronize``
    or reading a result), or the time is that of enqueueing the work."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    @property
    def count(self) -> int:
        return len(self._times)
