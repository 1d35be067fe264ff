"""The port's large-graph store, neighbour sampler and node-classification
step against graphnets_tpu's.

Here both packages sample with the same numpy ``default_rng`` stream
(their native samplers switched off), so one seed gives bit-equal batches;
``test_torch_native.py`` holds the default, native, samplers to each other.  The sampled batch is a single graph whose layout the single-graph
edge-update kernel and the sorted segment sum rest on: receivers ascending,
pads on a pad node behind every real receiver, capacities multiples of 128.
The step (device gather of the features, model under training, the seed
nodes' masked cross-entropy, Adam) is held to the JAX package's in f32:
loss 1e-5 relative, gradients rtol 5e-4 / atol 5e-5 of the tensor's largest
magnitude (f32 sums in another order), as the JAX package's own test holds
its kernel route to its pure route.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu.data import large_graph as j_lg
from graphnets_tpu.models.encode_process_decode import \
    EncodeProcessDecode as JEncodeProcessDecode
from graphnets_tpu.ops.pallas import edge_update_g1 as j_g1
from graphnets_tpu.runtime import native as j_native
from graphnets_tpu.training.losses import \
    masked_logit_crossentropy as j_masked_ce
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.data import large_graph as pt_lg
from graphnets_tpu_torch.ops.kernels import edge_update_g1 as pt_g1
from graphnets_tpu_torch.utils import config as pt_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def numpy_sampler(monkeypatch):
    """Both packages on their numpy sampling paths."""
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setenv("GRAPHNETS_TPU_TORCH_NATIVE", "0")


@pytest.fixture
def kernels_on():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(True, interpret=True)
    pt.enable_kernels(True)
    yield
    enable_pallas(old[0], interpret=old[1])
    pt_config.get_config().use_kernels = old_pt


def _coo(n=200, avg_deg=6, d=16, n_classes=4, seed=0):
    rng = np.random.default_rng(seed)
    e = n * avg_deg
    senders = rng.integers(0, n, e)
    receivers = rng.integers(0, n, e)
    labels = rng.integers(0, n_classes, n)
    feat = rng.normal(size=(n, d)).astype(np.float32)
    feat[:, :n_classes] += 3.0 * np.eye(n_classes, dtype=np.float32)[labels]
    return senders, receivers, feat, labels


def _graphs(**kw):
    coo = _coo(**kw)
    return j_lg.LargeGraph.from_coo(*coo), pt_lg.LargeGraph.from_coo(*coo)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_csc_from_coo_matches_jax_and_groups_by_receiver():
    senders, receivers, feat, _ = _coo(seed=1)
    n = feat.shape[0]
    indptr, src = pt.csc_from_coo(senders, receivers, n)
    indptr_j, src_j = j_native.csc_from_coo(senders, receivers, n)
    np.testing.assert_array_equal(indptr, indptr_j)
    np.testing.assert_array_equal(src, src_j)
    deg = indptr[1:] - indptr[:-1]
    assert deg.sum() == len(senders) and (deg >= 0).all()
    np.testing.assert_array_equal(deg, np.bincount(receivers, minlength=n))
    for v in (0, 7, n - 1):
        np.testing.assert_array_equal(
            np.sort(src[indptr[v]:indptr[v + 1]]),
            np.sort(senders[receivers == v]))


def test_large_graph_properties():
    _, g = _graphs(n=50, avg_deg=3)
    assert (g.num_nodes, g.num_edges) == (50, 150)
    nodes = np.array([0, 3, 49])
    np.testing.assert_array_equal(
        g.in_degree(nodes), g.indptr[nodes + 1] - g.indptr[nodes])


def test_sampler_static_shapes():
    _, g = _graphs()
    s = pt.NeighborSampler(g, fanouts=(5, 3), batch_size=8, seed=1,
                           device="cpu")
    shapes = set()
    for seeds in (np.arange(8), np.arange(50, 58), np.arange(3)):
        b = s.sample(seeds)
        shapes.add((tuple(b.graph.nf.shape), tuple(b.graph.senders.shape),
                    tuple(b.labels.shape), tuple(b.label_mask.shape)))
    assert len(shapes) == 1
    with pytest.raises(ValueError, match="seeds"):
        s.sample(np.arange(9))


def test_sampler_edges_point_to_requesting_node():
    _, g = _graphs()
    s = pt.NeighborSampler(g, fanouts=(4,), batch_size=4, seed=2,
                           device="cpu")
    b = s.sample(np.array([0, 1, 2, 3]))
    E = int(b.graph.n_edge[0])
    assert (b.graph.receivers[:E] < 4).all()


@pytest.mark.parametrize("seeds", [np.arange(16), np.arange(100, 109)],
                         ids=["full", "short"])
def test_sampler_kernel_contracts(seeds):
    """Receivers ascending with the pads included; pad edges on the pad
    node, the first slot past the real nodes; capacities multiples of 128;
    a single graph."""
    _, g = _graphs(n=500, avg_deg=5, seed=3)
    s = pt.NeighborSampler(g, fanouts=(6, 4), batch_size=16, seed=2,
                           emit_node_ids=True, device="cpu")
    assert s.max_nodes % 128 == 0 and s.max_edges % 128 == 0
    b = s.sample(seeds)
    rcv, snd = _np(b.graph.receivers), _np(b.graph.senders)
    n_e, n_n = int(b.graph.n_edge[0]), int(b.graph.n_node[0])
    assert rcv.dtype == np.int32 and (np.diff(rcv) >= 0).all()
    assert rcv.shape[0] == s.max_edges == b.graph.num_edge_slots
    assert b.graph.num_node_slots == s.max_nodes
    assert b.graph.num_graph_slots == 1 and b.graph.slot_shape is None
    assert (rcv[n_e:] == n_n).all() and (snd[n_e:] == n_n).all()
    assert n_n < s.max_nodes and (rcv[:n_e] < n_n).all()
    assert _np(b.graph.edge_mask).sum() == n_e
    assert _np(b.graph.node_mask).sum() == n_n
    assert _np(b.label_mask).sum() == len(seeds)
    # Pad slots of node_ids point at the table's zero row.
    assert (_np(b.node_ids)[n_n:] == g.num_nodes).all()


def test_bench_capacities():
    """The arxiv-shaped benchmark's subgraph: batch 512, fanouts (10, 10)
    give 56,960 node slots and 56,320 edge slots, which the single-graph
    gate admits at width 256 with f32 partials (56,320 gathered rows are
    below the bf16 gate)."""
    _, g = _graphs(n=20)
    s = pt.NeighborSampler(g, fanouts=(10, 10), batch_size=512,
                           device="cpu")
    assert (s.max_nodes, s.max_edges) == (56960, 56320)
    assert not pt_config.bf16_gather_partials(s.max_edges)
    for fn in (pt_g1.supports_g1_edge_update, j_g1.supports_g1_edge_update):
        assert fn(s.max_edges, s.max_nodes, 256, 256, 2, with_agg=True,
                  part_itemsize=4)


@pytest.mark.parametrize("emit_node_ids", [False, True])
def test_sampler_batches_bit_equal_jax(numpy_sampler, emit_node_ids):
    """Three consecutive batches (a short one among them) from one seed."""
    gj, gp = _graphs(n=400, avg_deg=5, seed=4)
    kw = dict(fanouts=(5, 3), batch_size=8, seed=7,
              emit_node_ids=emit_node_ids)
    sj = j_lg.NeighborSampler(gj, **kw)
    sp = pt.NeighborSampler(gp, device="cpu", **kw)
    assert (sp.max_nodes, sp.max_edges) == (sj.max_nodes, sj.max_edges)
    for seeds in (np.arange(8), np.arange(30, 35), np.arange(90, 98)):
        bj, bp = sj.sample(seeds), sp.sample(seeds)
        for key in ("senders", "receivers", "node_graph", "edge_graph",
                    "n_node", "n_edge", "node_mask", "edge_mask",
                    "graph_mask"):
            a, b = _np(getattr(bp.graph, key)), np.asarray(
                getattr(bj.graph, key))
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        for key in ("seed_local_idx", "labels", "label_mask"):
            np.testing.assert_array_equal(_np(getattr(bp, key)),
                                          np.asarray(getattr(bj, key)),
                                          err_msg=key)
        if emit_node_ids:
            assert bp.graph.nf is None and bj.graph.nf is None
            np.testing.assert_array_equal(_np(bp.node_ids),
                                          np.asarray(bj.node_ids))
        else:
            assert bp.node_ids is None
            np.testing.assert_array_equal(_np(bp.graph.nf),
                                          np.asarray(bj.graph.nf))


def test_epoch_order_bit_equal_jax(numpy_sampler):
    gj, gp = _graphs(n=60, avg_deg=4, seed=5)
    kw = dict(fanouts=(3,), batch_size=16, seed=9, emit_node_ids=True)
    sj = j_lg.NeighborSampler(gj, **kw)
    sp = pt.NeighborSampler(gp, device="cpu", **kw)
    nodes = np.arange(40)
    got = [(_np(b.node_ids), _np(b.label_mask)) for b in sp.epoch(nodes)]
    want = [(np.asarray(b.node_ids), np.asarray(b.label_mask))
            for b in sj.epoch(nodes)]
    assert len(got) == len(want) == 3
    for (a, m), (b, n) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(m, n)


def test_node_ids_mode_equals_feature_mode():
    """The same seed gives the same subgraph in both modes, and the device
    gather from the feature table rebuilds the host-gathered features (pad
    slots read the zero row)."""
    _, g = _graphs(n=300, avg_deg=6, seed=6)
    kw = dict(fanouts=(4, 2), batch_size=8, seed=11, device="cpu")
    b_feat = pt.NeighborSampler(g, **kw).sample(np.arange(8))
    b_idx = pt.NeighborSampler(g, emit_node_ids=True, **kw).sample(
        np.arange(8))
    assert torch.equal(b_feat.graph.senders, b_idx.graph.senders)
    assert torch.equal(b_feat.graph.receivers, b_idx.graph.receivers)
    feat = pt.device_feature_table(g, device="cpu")
    assert feat.shape == (g.num_nodes + 1, 16) and not feat[-1].any()
    assert torch.equal(feat.index_select(0, b_idx.node_ids),
                       b_feat.graph.nf)
    assert pt.device_feature_table(g, torch.bfloat16,
                                   device="cpu").dtype == torch.bfloat16


def _classification_setup(d_hidden, n_cores, seed):
    gj, gp = _graphs(n=300, avg_deg=6, d=16, seed=5)
    n_classes = 4
    kw = dict(fanouts=(4, 4), batch_size=8, seed=3, emit_node_ids=True)
    bj = j_lg.NeighborSampler(gj, **kw).sample(np.arange(8))
    bp = pt.NeighborSampler(gp, device="cpu", **kw).sample(np.arange(8))
    model_j = JEncodeProcessDecode((0, 16, 0), (d_hidden,) * 3,
                                   (1, n_classes, 0), n_cores=n_cores)
    params = model_j.init(jax.random.PRNGKey(seed))
    model_p = pt.EncodeProcessDecode((0, 16, 0), (d_hidden,) * 3,
                                     (1, n_classes, 0), n_cores=n_cores,
                                     device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), model_p)
    feat_j = j_lg.device_feature_table(gj, jnp.float32)
    feat_p = pt.device_feature_table(gp, device="cpu")

    def loss_j(p):
        graph = bj.graph.with_features(
            nf=jnp.take(feat_j, bj.node_ids, axis=0))
        pred = model_j.apply(p, graph, training=True)
        onehot = jax.nn.one_hot(bj.labels, n_classes)
        return j_masked_ce(pred.nf[bj.seed_local_idx], onehot,
                           bj.label_mask)

    return params, loss_j, model_p, bp, feat_p, n_classes


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("route", ["kernels", "pure"])
def test_node_classification_step_matches_jax(numpy_sampler, monkeypatch,
                                              route):
    """One step on a sampled batch in f32, on both routes: on the kernel
    route the core takes the single-graph kernel in both packages."""
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(route == "kernels", interpret=route == "kernels")
    pt.enable_kernels(route == "kernels")
    try:
        params, loss_j, model_p, bp, feat_p, n_classes = \
            _classification_setup(128, 1, 0)
        assert pt_g1.supports_g1_edge_update(
            bp.graph.num_edge_slots, bp.graph.num_node_slots, 128, 128, 4,
            with_agg=True)
        l_j, g_j = jax.value_and_grad(loss_j)(params)
        calls = []
        real = pt_g1.g1_edge_update_agg_plain
        monkeypatch.setattr(pt_g1, "g1_edge_update_agg_plain",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        old_params = {n: p.detach().clone()
                      for n, p in model_p.named_parameters()}
        lr = 1e-3
        step = pt.make_node_classification_step(
            model_p, torch.optim.Adam(model_p.parameters(), lr=lr, eps=1e-8),
            n_classes)
        loss = step(bp.graph, bp.node_ids, bp.labels, bp.label_mask,
                    bp.seed_local_idx, feat_p)
    finally:
        enable_pallas(old[0], interpret=old[1])
        pt_config.get_config().use_kernels = old_pt
    assert len(calls) == (1 if route == "kernels" else 0)
    np.testing.assert_allclose(float(loss), float(l_j), rtol=1e-5, atol=1e-6)
    g_j = _flat(g_j)
    updates, _ = optax.adam(lr).update(
        jax.tree_util.tree_map(jnp.asarray, g_j),
        optax.adam(lr).init(jax.tree_util.tree_map(jnp.asarray, g_j)))
    for n, p in model_p.named_parameters():
        ref = g_j[n]
        assert tuple(p.grad.shape) == ref.shape, n
        if p.numel() == 0:          # the decoder's zero-width graph net
            continue
        np.testing.assert_allclose(
            _np(p.grad), ref, rtol=5e-4,
            atol=5e-5 * max(1.0, np.abs(ref).max()), err_msg=n)
        # Adam's first step: about lr against the gradient's sign, and no
        # step where the gradient is exactly 0.
        moved = _np(p) - _np(old_params[n])
        firm = np.abs(ref) > 1e-3 * max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(moved[firm], np.asarray(updates[n])[firm],
                                   rtol=1e-3, atol=1e-6, err_msg=n)
        assert np.abs(moved).max() <= 1.01 * lr


def test_node_classification_step_bf16_compute(numpy_sampler, kernels_on):
    """bf16 compute with f32 masters: f32 gradients on every parameter,
    finite loss close to the f32 step's."""
    params, loss_j, model_p, bp, feat_p, n_classes = \
        _classification_setup(128, 2, 1)
    step = pt.make_node_classification_step(
        model_p, torch.optim.Adam(model_p.parameters(), lr=1e-3), n_classes,
        compute_dtype=torch.bfloat16)
    loss = float(step(bp.graph, bp.node_ids, bp.labels, bp.label_mask,
                      bp.seed_local_idx, feat_p.to(torch.bfloat16)))
    assert np.isfinite(loss)
    assert abs(loss - float(loss_j(params))) <= 5e-2 * abs(float(
        loss_j(params))) + 5e-2
    for n, p in model_p.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        assert np.isfinite(_np(p.grad)).all(), n


def test_node_classification_learns():
    """A short run on the CPU clears chance by a wide margin on held-out
    seeds' own batches (4 classes, features correlated with the labels)."""
    _, g = _graphs(n=300, d=16, seed=3)
    sampler = pt.NeighborSampler(g, fanouts=(8,), batch_size=32, seed=4,
                                 emit_node_ids=True, device="cpu")
    feat = pt.device_feature_table(g, device="cpu")
    model = pt.EncodeProcessDecode((0, 16, 0), (32, 32, 32), (1, 4, 0),
                                   n_cores=1, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    step = pt.make_node_classification_step(
        model, torch.optim.Adam(model.parameters(), lr=5e-3), 4)
    train = np.arange(240)
    for _ in range(6):
        for b in sampler.epoch(train):
            step(b.graph, b.node_ids, b.labels, b.label_mask,
                 b.seed_local_idx, feat)
    correct = total = 0
    with torch.no_grad():
        for b in sampler.epoch(np.arange(240, 300), shuffle=False):
            graph = b.graph.with_features(nf=feat.index_select(0, b.node_ids))
            yhat = model(graph).nf.index_select(0, b.seed_local_idx).argmax(-1)
            correct += int(((yhat == b.labels) & b.label_mask).sum())
            total += int(b.label_mask.sum())
    assert total == 60 and correct / total > 0.5, correct / total


def test_node_classification_example_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "examples/node_classification_torch.py", "--steps",
         "200", "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:] + out.stdout[-500:]
    assert "node_classification ok" in out.stdout
    assert "validation accuracy:" in out.stdout


def test_sampler_and_table_default_to_the_card():
    """Without a device argument the entry points ask for the card and
    raise where there is none, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, g = _graphs(n=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.NeighborSampler(g, fanouts=(2,), batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.device_feature_table(g)
