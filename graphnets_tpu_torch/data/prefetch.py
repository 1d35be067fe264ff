"""Asynchronous host-side batch prefetching (counterpart of
``graphnets_tpu/data/prefetch.py``).

The device should never wait on the host: batch construction (sampling,
padding, the native runtime's work) runs in background threads while the
device runs the previous step, with a bounded queue for backpressure.

The counterpart of ``jax.device_put`` in the worker: each worker copies the
batch's tensors to ``device`` with ``non_blocking=True`` on a CUDA stream
of its own and records an event after the copy; ``__next__`` makes the
consumer's current stream wait on that event and marks each tensor as used
on that stream (``record_stream``), so the copy overlaps the step that
runs on the consumer's stream and the caching allocator does not hand the
memory out again while the step may still read it.  A copy on the worker's
default stream would serialise with the step.  Pinned CPU tensors
(``NeighborSampler(device="cpu", pin_memory=True)``) make the copies truly
asynchronous.  With ``device="cpu"`` (or ``device_put=False``) items pass
through unchanged.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import torch

from ..utils.config import resolve_device
from ..utils.tree import map_tensors, tensors

__all__ = ["prefetch", "PrefetchIterator", "PrefetchPool"]


class _Mover:
    """Moves items to one device from a worker thread: on a CUDA device
    through a stream of the worker's own, an event marking the copy."""

    def __init__(self, device: Optional[torch.device]):
        self.device = device
        self.stream = None

    def __call__(self, item):
        if self.device is None or self.device.type != "cuda":
            return item, None
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self.stream):
            item = map_tensors(
                lambda t: t.to(self.device, non_blocking=True), item)
            event = torch.cuda.Event()
            event.record(self.stream)
        return item, event


def _hand_over(item, event, device):
    """The consumer's side of a move: its current stream waits for the
    copy, and each tensor is marked as used on that stream."""
    if event is None:
        return item
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for t in tensors(item):
        if t.is_cuda:
            t.record_stream(stream)
    return item


class PrefetchIterator:
    """Wraps an iterator: a background thread produces its items into a
    bounded queue and, with ``device_put``, moves them to ``device``
    (``cuda`` unless the caller passes another) ahead of use.  A worker's
    exception is raised in the consumer when the items before it are
    consumed."""

    _DONE = object()

    def __init__(self, it: Iterator[Any], buffer_size: int = 2,
                 device_put: bool = True, device=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._device = resolve_device(device) if device_put else None
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(it,), daemon=True)
        self._thread.start()

    def _worker(self, it):
        move = _Mover(self._device)
        try:
            for item in it:
                self._q.put(move(item))
        except BaseException as e:  # noqa: B036 -- raised in the consumer
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        got = self._q.get()
        if got is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return _hand_over(*got, self._device)


def prefetch(it: Iterator[Any], buffer_size: int = 2,
             device_put: bool = True, device=None) -> PrefetchIterator:
    """``for batch in prefetch(batches): ...``: overlap host batch
    construction with device compute."""
    return PrefetchIterator(it, buffer_size, device_put, device)


class PrefetchPool:
    """Multi-worker prefetcher: ``factory(worker_id)`` builds each worker's
    batch iterator (for example a ``NeighborSampler`` with a
    worker-specific seed: samplers are stateful, so each worker owns its
    own).  Workers run concurrently and push into one bounded queue;
    iteration ends when every worker's iterator is exhausted, and then
    raises the exception of a worker that failed.

    Use it where one producer thread cannot keep the device fed: with
    ``num_workers`` samplers the host side scales to the core count.
    """

    _DONE = object()

    def __init__(self, factory: Callable[[int], Iterator[Any]],
                 num_workers: int = 2, buffer_size: int = 4,
                 device_put: bool = True, device=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._device = resolve_device(device) if device_put else None
        self._err: Optional[BaseException] = None
        self._n_done = 0
        self._threads = [
            threading.Thread(target=self._worker, args=(factory, i),
                             daemon=True)
            for i in range(num_workers)]
        for t in self._threads:
            t.start()

    def _worker(self, factory, wid):
        move = _Mover(self._device)
        try:
            for item in factory(wid):
                self._q.put(move(item))
        except BaseException as e:  # noqa: B036 -- raised in the consumer
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            got = self._q.get()
            if got is self._DONE:
                self._n_done += 1
                if self._n_done == len(self._threads):
                    if self._err is not None:
                        raise self._err
                    raise StopIteration
                continue
            return _hand_over(*got, self._device)
