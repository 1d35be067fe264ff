"""The port's prefetching (``graphnets_tpu_torch/data/prefetch.py``) on CPU
tensors, with the JAX module's semantics: a bounded queue, the order of
the wrapped iterator, a worker's exception raised in the consumer, and a
pool that ends when every worker is done.  The copy to the card on the
workers' own streams runs in ``tests/test_torch_cuda.py``."""

import itertools
import time

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu_torch.data.prefetch import PrefetchIterator, PrefetchPool

TIMEOUT = 30.0


def _items(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"worker failed at {i}")
        yield {"i": torch.tensor([i]), "x": torch.full((3,), float(i))}


def test_prefetch_keeps_order_on_cpu():
    got = list(pt.prefetch(_items(20), buffer_size=3, device="cpu"))
    assert [int(b["i"]) for b in got] == list(range(20))
    assert all(b["x"].device.type == "cpu" for b in got)


def test_prefetch_without_device_put_passes_items_through():
    items = [object() for _ in range(5)]
    assert list(pt.prefetch(iter(items), device_put=False)) == items


def test_prefetch_raises_the_workers_error_after_its_items():
    it = pt.prefetch(_items(10, fail_at=6), device="cpu")
    got = [int(next(it)["i"]) for _ in range(6)]
    assert got == list(range(6))
    with pytest.raises(KeyError, match="failed at 6"):
        next(it)


def test_prefetch_queue_is_bounded():
    """The worker runs at most ``buffer_size`` items (plus the one it is
    putting) ahead of the consumer."""
    made = []

    def src():
        for i in itertools.count():
            made.append(i)
            yield i

    it = PrefetchIterator(src(), buffer_size=2, device_put=False)
    deadline = time.time() + TIMEOUT
    while len(made) < 3 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert len(made) <= 4
    assert next(it) == 0 and next(it) == 1


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_pool_ends_when_every_worker_is_done(workers):
    """Each worker's items arrive in its own order; the pool ends after all
    of them, with more workers than cores too."""
    def factory(wid):
        for i in range(wid + 2):
            yield wid, i

    got = list(PrefetchPool(factory, num_workers=workers, buffer_size=2,
                            device="cpu"))
    assert sorted(got) == sorted((w, i) for w in range(workers)
                                 for i in range(w + 2))
    for w in range(workers):
        assert [i for ww, i in got if ww == w] == list(range(w + 2))


def test_pool_raises_a_workers_error_when_the_pool_ends():
    def factory(wid):
        if wid == 1:
            raise KeyError("worker 1 failed")
        yield from range(4)

    pool = PrefetchPool(factory, num_workers=3, device="cpu")
    got = []
    with pytest.raises(KeyError, match="worker 1 failed"):
        for v in pool:
            got.append(v)
    assert sorted(got) == sorted(list(range(4)) * 2)


def test_pool_of_samplers_gives_the_in_line_batches():
    """Each worker owns a sampler with its own seed; its batches are those
    of the same sampler run in line."""
    rng = np.random.default_rng(0)
    n = 300
    g = pt.LargeGraph.from_coo(rng.integers(0, n, 2000),
                               rng.integers(0, n, 2000),
                               rng.normal(size=(n, 8)).astype(np.float32),
                               rng.integers(0, 4, n))

    def sampler(seed):
        return pt.NeighborSampler(g, fanouts=(4, 3), batch_size=16,
                                  seed=seed, emit_node_ids=True,
                                  device="cpu")

    def factory(wid):
        for i, b in enumerate(itertools.islice(
                sampler(10 + wid).epoch(np.arange(n)), 5)):
            yield wid, i, b

    got = list(PrefetchPool(factory, num_workers=2, device="cpu"))
    assert len(got) == 10
    for wid, i, b in got:
        ref = list(itertools.islice(sampler(10 + wid).epoch(np.arange(n)),
                                    5))[i]
        assert torch.equal(b.node_ids, ref.node_ids)
        assert torch.equal(b.graph.senders, ref.graph.senders)
        assert torch.equal(b.labels, ref.labels)


def test_pool_threads_finish():
    pool = PrefetchPool(lambda w: iter(range(3)), num_workers=4,
                        device="cpu")
    assert sorted(pool) == sorted(list(range(3)) * 4)
    for t in pool._threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
