"""The traffic generators are deterministic by seed and differ across
seeds; the run's seeds derive from ``--seed`` the same way every time."""

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as port
from generators import single_graph, sort_device, sort_host, uniform_batches
from harness import runner, spec

SORT = spec.cell("sort384.host_loop").config
LG = spec.cell("lg256.one_graph").config
SMALL = {"num_nodes": 256, "num_edges": 2048}


def _graph(seed):
    f = single_graph.Feed(port, LG, SMALL, seed, torch.device("cpu"))
    return [f.x.senders, f.x.receivers, f.x.ef, f.x.nf, f.x.gf, f.y.ef,
            f.y.nf]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_single_graph_by_seed():
    a, b, c = _graph(5), _graph(5), _graph(6)
    assert _same(a, b)
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    senders, receivers = a[0], a[1]
    assert senders.numel() == receivers.numel() == SMALL["num_edges"]
    assert bool((receivers[1:] >= receivers[:-1]).all())
    assert int(senders.max()) < SMALL["num_nodes"]


def _samples(seed, k=20):
    rng = np.random.default_rng(seed)
    return [sort_host.sample(rng, SORT["task"]) for _ in range(k)]


def test_sort_samples_by_seed():
    a, b, c = _samples(3), _samples(3), _samples(4)
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    assert any(not np.array_equal(x[1], y[1]) for x, y in zip(a, c))
    for n, values, adj, x_nf, y_nf, y_ef in a:
        t = SORT["task"]
        assert t["min_nodes"] <= n <= t["max_nodes"]
        assert adj.shape == (n, n) and x_nf.shape == (n, t["vocab_size"])
        assert y_ef.shape == (n * n, 2) and y_ef[:, 1].sum() == n - 1
        assert y_nf[:, 1].sum() == (values == values.min()).sum()


def test_sort_samples_match_the_ports_generator():
    """Given the same numpy stream, the benchmark's sample is the port's
    ``gen_sample`` (its targets worked out independently)."""
    cfg = port.SortTaskConfig()
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(30):
        n, values, adj, x_nf, y_nf, y_ef = sort_host.sample(r1, SORT["task"])
        a2, x2, yn2, ye2, v2 = port.gen_sample(r2, cfg)
        assert np.array_equal(values, v2) and np.array_equal(x_nf, x2)
        assert np.array_equal(y_nf, yn2) and np.array_equal(y_ef, ye2)


def _draws(seed, k=5):
    f = sort_device.Feed(port, SORT, {"chunk": 4}, seed, torch.device("cpu"))
    return f._draws(f.gen.get_state(), k)


def test_sort_device_draws_by_seed():
    a, b, c = _draws(7), _draws(7), _draws(8)
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
               for x, y in zip(a, b))
    assert any(not torch.equal(x[1], y[1]) for x, y in zip(a, c))


MINI = {"graphs": 3, "nodes": 32, "in_degree": 4, "batches": 5}


def _mini(seed):
    return uniform_batches.Feed(port, LG, MINI, seed, torch.device("cpu"))


def test_uniform_batches_by_seed():
    def tensors(f):
        return [t for x, y in f.batches
                for t in (x.senders, x.ef, x.nf, x.gf, y.ef, y.nf)]
    a, b, c = _mini(5), _mini(5), _mini(6)
    assert _same(tensors(a), tensors(b))
    assert not _same(tensors(a), tensors(c))
    G, n, deg = MINI["graphs"], MINI["nodes"], MINI["in_degree"]
    for k, (x, y) in enumerate(a.batches):
        # The port's layout holds the benchmark's own edge lists.
        assert torch.equal(x.senders.long(), a.senders[k])
        assert torch.equal(x.receivers.long(), a.receivers)
        assert x.slot_shape == (n, n * deg) and bool(x.edge_mask.all())
        s, r = a.senders[k].view(G * n, deg), a.receivers.view(G * n, deg)
        assert bool((s[:, 1:] > s[:, :-1]).all())       # distinct, ascending
        assert bool((s // n == r // n).all())            # in its own graph
        assert x.ef.dtype == getattr(torch, LG["feature_dtype"])
        assert y.gf is None and x.gf.shape == (G, LG["model"]["core_dims"][2])
    assert len({a.senders[k].sum().item() for k in range(MINI["batches"])}) > 1


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5, 2 ** 40, -3])
def test_derived_seeds(seed):
    a, b = runner.derive_seeds(seed), runner.derive_seeds(seed)
    assert a == b and a[0] != a[1]
    assert all(0 <= s < 2 ** 63 for s in a)
    assert runner.derive_seeds(seed + 1) != a
