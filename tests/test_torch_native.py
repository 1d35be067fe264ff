"""The port's native runtime (``graphnets_tpu_torch/runtime``) against the
JAX package's (``graphnets_tpu/runtime/native.py``).

The port keeps its own copy of ``batcher.cpp``; every native function must
give bit-equal results to the JAX module's on the same inputs, and the
default samplers of the two packages (both native) must draw bit-equal
batches from one seed.  The library is built into ``build/`` at the root
of the checkout, never into the JAX package's ``runtime/_build``, and
``GRAPHNETS_TPU_TORCH_NATIVE=0`` takes the numpy paths.
"""

import os

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu.data import large_graph as j_lg
from graphnets_tpu.graph import batch as j_batch
from graphnets_tpu.runtime import native as j_native
from graphnets_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def both_native():
    """Both packages on their native paths (the defaults)."""
    if not j_native.available():
        pytest.skip("the JAX package's native runtime did not build")
    assert native.available()


def _adjs(rng, count=7, nmax=9):
    out = []
    for _ in range(count):
        n = int(rng.integers(1, nmax))
        a = rng.integers(0, 3, size=(n, n))   # entries of 2 are no edge
        out.append(a.astype(np.int64))
    return out


def _coo(rng, n=500, e=4000):
    return rng.integers(0, n, e), rng.integers(0, n, e), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_coo_bit_equal_jax(both_native, seed):
    adjs = _adjs(np.random.default_rng(seed))
    for mine, theirs in zip(native.batch_coo(adjs), j_native.batch_coo(adjs)):
        assert mine.dtype == theirs.dtype == np.int32
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("seed", [0, 1])
def test_csc_from_coo_bit_equal_jax(both_native, seed):
    s, r, n = _coo(np.random.default_rng(seed))
    for mine, theirs in zip(native.csc_from_coo(s, r, n),
                            j_native.csc_from_coo(s, r, n)):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("seed", [1, 12345, 2 ** 61 + 7])
def test_sample_layer_bit_equal_jax(both_native, seed, threads):
    """Several seeds and thread counts; a frontier over 1024 nodes so the
    threaded path runs.  The result does not depend on the threads."""
    rng = np.random.default_rng(3)
    s, r, n = _coo(rng, n=3000, e=40000)
    indptr, src = native.csc_from_coo(s, r, n)
    frontier = rng.integers(0, n, 2000)
    pos = np.arange(2000) + 17
    mine = native.sample_layer(indptr, src, frontier, pos, 5, seed, threads)
    theirs = j_native.sample_layer(indptr, src, frontier, pos, 5, seed,
                                   threads)
    one = native.sample_layer(indptr, src, frontier, pos, 5, seed, 1)
    for a, b, c in zip(mine, theirs, one):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_gather_rows_bit_equal_jax(both_native):
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(6000, 24)).astype(np.float32)
    idx = rng.integers(0, 6000, 5000)
    out = np.zeros((5100, 24), np.float32)
    native.gather_rows(feat, idx, out=out[:5000])
    np.testing.assert_array_equal(out[:5000], j_native.gather_rows(feat, idx))
    np.testing.assert_array_equal(out[:5000], feat[idx])
    assert not out[5000:].any()


def test_partition_edges_bit_equal_jax(both_native):
    rng = np.random.default_rng(5)
    receivers = rng.integers(0, 1000, 7000)
    for mine, theirs in zip(native.partition_edges(receivers, 130, 8),
                            j_native.partition_edges(receivers, 130, 8)):
        np.testing.assert_array_equal(mine, theirs)


def test_refine_partition_bit_equal_jax(both_native):
    rng = np.random.default_rng(6)
    n = 400
    s, r = rng.integers(0, n, 2000), rng.integers(0, n, 2000)
    ss, rr = np.concatenate([s, r]), np.concatenate([r, s])
    indptr, adj = native.csc_from_coo(rr, ss, n)
    assign = rng.integers(0, 4, n)
    mine = native.refine_partition(indptr, adj, assign, 4, 120)
    theirs = j_native.refine_partition(indptr, adj, assign, 4, 120)
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert mine[1] == theirs[1]


def test_library_lands_in_build_only():
    """The port's library is ``build/libgraphnets-<hash>.so`` at the root
    of the checkout; the port writes nothing into the JAX package's
    ``runtime/_build``."""
    jax_build = os.path.join(REPO, "graphnets_tpu", "runtime", "_build")
    before = sorted(os.listdir(jax_build)) if os.path.isdir(jax_build) \
        else []
    assert native.available()
    so = native.library_path()
    assert so.exists()
    assert so.parent == native.BUILD_DIR
    assert str(so.parent) == os.path.join(REPO, "build")
    assert so.name.startswith("libgraphnets-") and so.suffix == ".so"
    after = sorted(os.listdir(jax_build)) if os.path.isdir(jax_build) \
        else []
    assert after == before


def test_native_switch_takes_the_numpy_paths(monkeypatch):
    """``GRAPHNETS_TPU_TORCH_NATIVE=0`` is the one way to the numpy paths:
    ``available`` says False, ``sample_layer`` refuses, and the other calls
    give the JAX module's numpy results."""
    monkeypatch.setenv("GRAPHNETS_TPU_TORCH_NATIVE", "0")
    assert not native.available()
    rng = np.random.default_rng(7)
    s, r, n = _coo(rng)
    monkeypatch.setattr(j_native, "_load", lambda: None)
    for mine, theirs in zip(native.csc_from_coo(s, r, n),
                            j_native.csc_from_coo(s, r, n)):
        np.testing.assert_array_equal(mine, theirs)
    adjs = _adjs(rng)
    for mine, theirs in zip(native.batch_coo(adjs), j_native.batch_coo(adjs)):
        np.testing.assert_array_equal(mine, theirs)
    with pytest.raises(RuntimeError, match="native"):
        native.sample_layer(*native.csc_from_coo(s, r, n), np.arange(3),
                            np.arange(3), 2, 1)
    # The sampler falls back to its numpy loop, which draws JAX's numpy
    # path's batches.
    monkeypatch.setattr(j_native, "available", lambda: False)
    feat = rng.normal(size=(n, 8)).astype(np.float32)
    gj = j_lg.LargeGraph.from_coo(s, r, feat)
    gp = pt.LargeGraph.from_coo(s, r, feat)
    kw = dict(fanouts=(3, 2), batch_size=16, seed=9, emit_node_ids=True)
    bj = j_lg.NeighborSampler(gj, **kw).sample(np.arange(16))
    bp = pt.NeighborSampler(gp, device="cpu", **kw).sample(np.arange(16))
    np.testing.assert_array_equal(bp.node_ids.numpy(),
                                  np.asarray(bj.node_ids))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No silent fallback: a source that does not compile raises with the
    compiler's output."""
    bad = tmp_path / "batcher.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.available()
    monkeypatch.setenv("GRAPHNETS_TPU_TORCH_NATIVE", "0")
    assert not native.available()


def _sampler_batches(lg_mod, g, emit_node_ids, seed, device_kw):
    s = lg_mod.NeighborSampler(g, fanouts=(5, 3), batch_size=32, seed=seed,
                               emit_node_ids=emit_node_ids, **device_kw)
    return list(s.epoch(np.arange(g.num_nodes)))[:3]


def _fields(b):
    g = b.graph
    out = {k: getattr(g, k) for k in ("senders", "receivers", "node_graph",
                                      "edge_graph", "n_node", "n_edge",
                                      "node_mask", "edge_mask", "graph_mask",
                                      "nf")}
    out.update(seed_local_idx=b.seed_local_idx, labels=b.labels,
               label_mask=b.label_mask, node_ids=b.node_ids)
    return {k: (None if v is None else
                (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)))
            for k, v in out.items()}


@pytest.mark.parametrize("emit_node_ids", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_default_sampler_bit_equal_jax(both_native, seed, emit_node_ids):
    """At default settings the two packages draw the same batches from one
    seed: both sample through their native runtimes."""
    rng = np.random.default_rng(10 + seed)
    s, r, n = _coo(rng, n=900, e=9000)
    feat = rng.normal(size=(n, 12)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    gj = j_lg.LargeGraph.from_coo(s, r, feat, labels)
    gp = pt.LargeGraph.from_coo(s, r, feat, labels)
    mine = _sampler_batches(pt, gp, emit_node_ids, seed, {"device": "cpu"})
    theirs = _sampler_batches(j_lg, gj, emit_node_ids, seed, {})
    for bm, bt in zip(mine, theirs):
        fm, ft = _fields(bm), _fields(bt)
        for k in fm:
            if fm[k] is None:
                assert ft[k] is None, k
            else:
                np.testing.assert_array_equal(fm[k], ft[k], err_msg=k)


def test_sampler_emits_pinned_cpu_batches_where_asked():
    rng = np.random.default_rng(11)
    s, r, n = _coo(rng)
    g = pt.LargeGraph.from_coo(s, r, rng.normal(size=(n, 4)).astype(
        np.float32), rng.integers(0, 3, n))
    b = pt.NeighborSampler(g, (3,), 8, device="cpu").sample(np.arange(8))
    assert all(t.device.type == "cpu" for t in
               (b.graph.senders, b.graph.nf, b.labels, b.label_mask))
    with pytest.raises(ValueError, match="pin_memory"):
        pt.NeighborSampler(g, (3,), 8, device="meta", pin_memory=True)


@pytest.mark.parametrize("pad", ["exact", "bucketed", "uniform"])
def test_batch_coo_equal_jax_through_batch(both_native, pad):
    """``batch`` builds its COO through the native runtime, as JAX's does:
    the senders and receivers of the padded batch are JAX's."""
    rng = np.random.default_rng(12)
    adjs = [(rng.random((n, n)) < 0.4).astype(np.int64)
            for n in (4, 6, 5, 7)]
    nf = [rng.normal(size=(a.shape[0], 3)).astype(np.float32) for a in adjs]
    data = {"graphs": adjs, "ef": None, "nf": nf, "gf": None}
    E = sum(int(a.sum()) for a in adjs)
    if pad == "exact":
        spec_p = spec_j = None
    elif pad == "bucketed":
        spec_p = pt.PadSpec.bucketed(22, E, 4)
        from graphnets_tpu.graph import PadSpec as JPadSpec
        spec_j = JPadSpec.bucketed(22, E, 4)
    else:
        spec_p = pt.PadSpec.uniform(8, 64)
        from graphnets_tpu.graph import PadSpec as JPadSpec
        spec_j = JPadSpec.uniform(8, 64)
    gp = pt.batch(data, pad=spec_p, device="cpu")
    gj = j_batch(data, pad=spec_j)
    for k in ("senders", "receivers", "n_edge", "edge_graph"):
        np.testing.assert_array_equal(getattr(gp, k).numpy(),
                                      np.asarray(getattr(gj, k)), err_msg=k)
