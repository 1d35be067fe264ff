"""Tracing and profiling hooks (counterpart of
``graphnets_tpu/utils/profiling.py``): a ``torch.profiler`` trace written
as a Chrome trace (viewable in Perfetto), named ranges for traces and
Nsight, and a wall-clock step timer.

With the tracing switch on (``GRAPHNETS_TPU_TORCH_TRACE=1`` or
``utils/config.enable_tracing()``) the port's own paths record what they
do in the same trace: :func:`span` opens the host ranges ``gn.step`` (and
its ``.lookup``, ``.copy_in``, ``.replay``, ``.outputs``, ``.capture``,
``.warm_up``), ``gn.batch`` (``.pack``, ``.to_device``) and ``gn.train.*``
(``batch``, ``forward``, ``backward``, ``optimizer``, ``metrics``), and
:class:`PhaseMarkers` puts one marker on the device at each phase
boundary of a step body."""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .config import tracing

__all__ = ["trace", "annotate", "StepTimer"]

# A step body's phases in the order their markers are enqueued: ``batch``
# only where the step draws its own batch, ``end`` last.  The marker of a
# phase is the kernel ``gn_phase_<phase>`` (``csrc/phase_marker.cu``).
PHASES = ("batch", "forward", "backward", "optimizer", "metrics", "end")
# A model's stages (GraphCast's, ``models/graphcast.py``): sub-phases,
# each from its marker to the next marker of any name, inside the phase it
# falls in.  The marker of a stage is the kernel ``gn_phase_<stage>``
# (``csrc/stage_marker.cu``).
STAGES = ("encoder", "processor", "decoder", "decoder_bwd", "processor_bwd",
          "encoder_bwd")


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
    ``torch.profiler`` traces and, on a card, an NVTX range.  Always on;
    the port's own paths open theirs through :func:`span`, which is this
    range while the tracing switch is on and a profiler collects."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _nvtx(name: str) -> Iterator[None]:
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def span(name: str):
    """The span sites of the step, capture and batch paths: with the
    tracing switch off a no-op that costs one flag read; with it on
    :func:`annotate` (``name``) while a ``torch.profiler`` is collecting,
    and otherwise the NVTX range alone (on a card), since a
    ``record_function`` range costs ~15 us a use with no profiler to
    read it."""
    if not tracing():
        return _OFF
    if torch.autograd._profiler_enabled():
        return annotate(name)
    return _nvtx(name) if torch.cuda.is_available() else _OFF


class PhaseMarkers:
    """The device phase markers of a step body on ``device``.

    While the tracing switch is on, ``markers(phase)`` launches on the
    current stream the empty one-thread kernel ``gn_phase_<phase>``
    (``csrc/phase_marker.cu``).  A CUDA-graph capture takes it into the
    graph, so every replay of a graph captured with the switch on carries
    the markers, and one captured with it off none.  In a
    ``torch.profiler`` trace a marker is a kernel event on the device's
    clock whose name says the phase; a phase runs from its marker to the
    next one.  A marker is a kernel, so a profile's kernel count holds the
    five or six of each step (the file says why no memset or copy can be
    a marker).  With the switch off, or off the card, nothing is
    enqueued."""

    # Step bodies open on this thread (see ``step``).
    _open = threading.local()

    def __init__(self, device):
        self.device = torch.device(device)

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        """A step body: the outermost one open on this thread puts the
        ``end`` marker when it closes, so a step body that calls another
        (the sort device step calls ``make_train_step``'s) ends once."""
        depth = getattr(self._open, "depth", 0)
        self._open.depth = depth + 1
        try:
            yield
        finally:
            self._open.depth = depth
        if depth == 0:
            self("end")

    def __call__(self, phase: str) -> None:
        if not tracing() or self.device.type != "cuda":
            return
        from ..ops.kernels import _build     # built on the first marker
        stage = phase in STAGES
        lib = _build.load("stage_marker" if stage else "phase_marker")
        fn = lib.gn_stage_marker if stage else lib.gn_phase_marker
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _build.check(lib, fn(
            (STAGES if stage else PHASES).index(phase),
            torch.cuda.current_stream(self.device).cuda_stream),
            f"phase marker {phase!r}")

    def boundary(self, stage: str, *xs: torch.Tensor) -> tuple:
        """``xs`` as they are, through an identity whose backward puts the
        marker of ``stage``: the backward's stage starts once the gradient
        of every one of ``xs`` is complete, so ``xs`` should be every
        tensor that crosses the boundary.  With the switch off no autograd
        node is added."""
        if not tracing():
            return xs
        return _Boundary.apply(self, stage, *xs)


class _Boundary(torch.autograd.Function):
    """The identity on its tensors; its backward enqueues a stage marker
    before it hands the gradients on (on the stream of the forward, where
    autograd runs a node's backward)."""

    @staticmethod
    def forward(ctx, markers, stage, *xs):
        ctx.markers, ctx.stage = markers, stage
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.markers(ctx.stage)
        return (None, None) + grads


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
