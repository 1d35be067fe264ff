"""Routes of the port held to the JAX package's: the graph pools, the
receivers gather, the ``split_linear`` switch, and a ten-step trajectory
of the node-classification step.

* The graph pools (``aggregate_*_for_globals``) declare the batch layout
  sorted and pad-safe and take ``mask_aliases_real``, as JAX's do
  (``scatter.py:297-325``): with kernels on and more than 64 graph slots
  both take the sorted segment sum (on the CPU the port's wrapper runs its
  plain version, which a spy counts), and on the uniform layout (whose
  padded rows carry their slot's graph id) the padded rows are zeroed
  first.  f32 values at 1e-5 of the largest magnitude (the
  same f32 sums in another order).
* The receivers gather of the concatenated edge input is declared sorted
  (``gn_block.py:73``): it takes the sorted gather, and its backward the
  sorted sum without a sort.
* ``GRAPHNETS_TPU_TORCH_SPLIT_LINEAR`` sets ``Config.split_linear``; both
  settings of the switch give JAX's block on the same inputs (f32, 1e-4).
* Ten Adam(1e-3) steps of ``make_node_classification_step`` in f32 on
  freshly sampled batches, held step by step to JAX + ``optax.adam``:
  each loss at 1e-4 relative, and every parameter after the ten steps
  within 1e-4 of the tensor's largest magnitude plus 1e-4 absolute.  Adam
  divides by the root of the second moment, so an element whose gradient
  is a rounding error in both packages can move by up to one learning rate
  a step either way; the absolute term is a tenth of one such step.
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

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.data import large_graph as j_lg
from graphnets_tpu.models import gn_block as j_gnb
from graphnets_tpu.models.encode_process_decode import \
    EncodeProcessDecode as JEncodeProcessDecode
from graphnets_tpu.runtime import native as j_native
from graphnets_tpu.training.losses import \
    masked_logit_crossentropy as j_masked_ce
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.data import large_graph as pt_lg
from graphnets_tpu_torch.models import gn_block as pt_gnb
from graphnets_tpu_torch.ops import scatter as pt_scatter
from graphnets_tpu_torch.ops.kernels import gather as pt_ga
from graphnets_tpu_torch.ops.kernels import segment_sum as pt_ss
from graphnets_tpu_torch.utils import config as pt_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G_MANY = 128         # graph slots: past the 64 below which pools stay small


def _route(use):
    """JAX Pallas in interpret mode and the port's kernel routes (plain
    versions on the CPU) on or off; returns the restorer."""
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(use, interpret=use)
    pt.enable_kernels(use)

    def restore():
        enable_pallas(old[0], interpret=old[1])
        pt_config.get_config().use_kernels = old_pt
    return restore


@pytest.fixture
def kernels_on():
    restore = _route(True)
    yield
    restore()


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(out, ref, tol, what=""):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(out).all(), what
    err = np.abs(out - ref).max() if out.size else 0.0
    assert err <= tol * max(np.abs(ref).max() if ref.size else 0.0, 1e-30), \
        (what, err)


def _spy(monkeypatch, mod, name, calls):
    real = getattr(mod, name)

    def spy(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **k)
    monkeypatch.setattr(mod, name, spy)


def _many_graphs(seed, d, padded, n=4, deg=2):
    """G_MANY small graphs; with ``padded`` they are smaller than their
    uniform slots."""
    rng = np.random.default_rng(seed)
    adjs, efs, nfs = [], [], []
    for b in range(G_MANY):
        nb = n - 1 - b % 2 if padded else n
        adj = np.zeros((nb, nb), np.int64)
        for r in range(nb):
            adj[rng.choice(nb, size=min(deg, nb), replace=False), r] = 1
        adjs.append(adj)
        efs.append(rng.normal(size=(int(adj.sum()), d)).astype(np.float32))
        nfs.append(rng.normal(size=(nb, d)).astype(np.float32))
    gf = rng.normal(size=(G_MANY, d)).astype(np.float32)
    return {"graphs": adjs, "ef": efs, "nf": nfs, "gf": gf}


def _bucketed():
    # Row counts in whole 128-row tiles, as the sorted sum's gate wants.
    return gn.PadSpec.bucketed(639, 1152, G_MANY)


_LAYOUTS = {
    "uniform_exact": (False, lambda: gn.PadSpec.uniform(4, 8)),
    "uniform_padded": (True, lambda: gn.PadSpec.uniform(4, 8)),
    "bucketed": (True, lambda: _bucketed()),
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_graph_pools_over_64_slots_take_the_sorted_sum(kernels_on,
                                                       monkeypatch, layout):
    padded, pad = _LAYOUTS[layout]
    d = 128
    data = _many_graphs(3, d, padded)
    gj, gp = gn.batch(data, pad=pad()), pt.batch(data, pad=pad(),
                                                 device="cpu")
    assert gp.num_graph_slots > 64
    assert gp.pad_aliases_real == gj.pad_aliases_real
    # Uniform slots hold more edge slots than their graphs' edges.
    assert gp.pad_aliases_real == (layout != "bucketed")
    # Large values in every padded row: only the masks keep them out.
    rng = np.random.default_rng(4)
    ef = rng.normal(size=(gp.num_edge_slots, d)).astype(np.float32)
    nf = rng.normal(size=(gp.num_node_slots, d)).astype(np.float32)
    ef[~np.asarray(gp.edge_mask)] = 1e3
    nf[~np.asarray(gp.node_mask)] = 1e3
    calls = {}
    _spy(monkeypatch, pt_ss, "sorted_segment_sum_plain", calls)
    out_p = pt_gnb.get_graph_fn_input(gp, ef=torch.from_numpy(ef),
                                      nf=torch.from_numpy(nf), gf=None)
    assert calls == {"sorted_segment_sum_plain": 2}
    out_j = j_gnb.get_graph_fn_input(gj, ef=jnp.asarray(ef),
                                     nf=jnp.asarray(nf), gf=None)
    _close(out_p, out_j, 1e-5, layout)
    # The real graphs' sums, from numpy: padded rows count in none of them
    # (the bucketed layout sends them to its padding graph).
    em, nm = np.asarray(gp.edge_mask), np.asarray(gp.node_mask)
    ref = np.zeros((gp.num_graph_slots, 2 * d), np.float32)
    np.add.at(ref[:, :d], np.asarray(gp.edge_graph)[em], ef[em])
    np.add.at(ref[:, d:], np.asarray(gp.node_graph)[nm], nf[nm])
    _close(out_p[:G_MANY], ref[:G_MANY], 1e-5, layout)


@pytest.mark.parametrize("aliases", [False, True])
def test_pools_zero_aliased_padded_rows_before_the_sum(kernels_on, aliases):
    """``mask_aliases_real``: padded rows that share a real row's segment
    are zeroed before the sorted sum; without it the mask is left to the
    layout's contract (padded rows in segments of their own)."""
    rows, segs, d = 300, 70, 128
    seg = np.sort(np.random.default_rng(5).integers(0, segs, rows))
    mask = np.ones(rows, bool)
    mask[::7] = False
    x = np.random.default_rng(6).normal(size=(rows, d)).astype(np.float32)
    args_p = (torch.from_numpy(x), torch.from_numpy(seg.astype(np.int32)),
              segs, torch.from_numpy(mask))
    args_j = (jnp.asarray(x), jnp.asarray(seg.astype(np.int32)), segs,
              jnp.asarray(mask))
    from graphnets_tpu.ops import scatter as j_scatter
    for fp, fj in ((pt_scatter.aggregate_edges_for_globals,
                    j_scatter.aggregate_edges_for_globals),
                   (pt_scatter.aggregate_nodes_for_globals,
                    j_scatter.aggregate_nodes_for_globals)):
        out_p = fp(*args_p, mask_aliases_real=aliases)
        out_j = fj(*args_j, mask_aliases_real=aliases)
        _close(out_p, out_j, 1e-5)
        if aliases:
            ref = np.zeros((segs, d), np.float32)
            np.add.at(ref, seg[mask], x[mask])
            _close(out_p, ref, 1e-5)


def test_edge_input_gathers_the_receivers_sorted(kernels_on, monkeypatch):
    """The concatenated edge input (``split_linear`` off): the receivers
    gather takes the sorted gather, and its backward the sorted sum with no
    sort; values and the node features' gradient match JAX's."""
    d = 128
    data = _many_graphs(7, d, True)
    pad = _bucketed()
    gj, gp = gn.batch(data, pad=pad), pt.batch(data, pad=pad, device="cpu")
    rng = np.random.default_rng(8)
    ef = rng.normal(size=(gp.num_edge_slots, d)).astype(np.float32)
    nf = rng.normal(size=(gp.num_node_slots, d)).astype(np.float32)
    ct = rng.normal(size=(gp.num_edge_slots, 3 * d)).astype(np.float32)
    calls = {}
    _spy(monkeypatch, pt_ga, "sorted_gather_plain", calls)
    sorts = []
    real_sort = torch.sort
    monkeypatch.setattr(torch, "sort", lambda *a, **k: sorts.append(1)
                        or real_sort(*a, **k))
    tnf = torch.from_numpy(nf).requires_grad_()
    out_p = pt_gnb.get_edge_fn_input(gp, ef=torch.from_numpy(ef), nf=tnf,
                                     gf=None)
    # Forward: the receivers, and no other sorted gather.
    assert calls == {"sorted_gather_plain": 1}
    out_p.backward(torch.from_numpy(ct))
    # Backward: the senders sort once; the receivers do not.
    assert len(sorts) == 1
    out_j, vjp = jax.vjp(lambda t: j_gnb.get_edge_fn_input(
        gj, ef=jnp.asarray(ef), nf=t, gf=None), jnp.asarray(nf))
    _close(out_p, out_j, 0.0)
    _close(tnf.grad, vjp(jnp.asarray(ct))[0], 1e-5)


@pytest.mark.parametrize("split", [True, False])
def test_split_linear_switch_matches_jax(kernels_on, split):
    """GNBlock on both settings of the switch, on a batch of 128 bucketed
    graphs, against JAX's block with its switch set alike: outputs and the
    input gradients in f32."""
    dims, out_dims = (16, 16, 16), (16, 16, 16)
    data = _many_graphs(9, 16, True)
    pad = _bucketed()
    gj, gp = gn.batch(data, pad=pad), pt.batch(data, pad=pad, device="cpu")
    block_j = gn.GNBlock(dims, out_dims)
    params = jax.tree_util.tree_map(np.asarray,
                                    block_j.init(jax.random.PRNGKey(2)))
    block_p = pt.from_jax_params(params, pt.GNBlock(dims, out_dims,
                                                    device="cpu"))
    cfg, cfg_pt = get_config(), pt_config.get_config()
    old = (cfg.split_linear, cfg_pt.split_linear)
    cfg.split_linear = cfg_pt.split_linear = split
    try:
        def run_j(ef, nf, gf):
            y = block_j.apply(jax.tree_util.tree_map(jnp.asarray, params),
                              gj.with_features(ef=ef, nf=nf, gf=gf))
            return (jnp.sum(y.ef * y.ef) + jnp.sum(y.nf * y.nf)
                    + jnp.sum(y.gf * y.gf))
        feats = (gj.ef, gj.nf, gj.gf)
        loss_j, grads_j = jax.value_and_grad(run_j, argnums=(0, 1, 2))(
            *feats)
        xs = [torch.from_numpy(np.asarray(f)).requires_grad_()
              for f in feats]
        y = block_p(gp.with_features(ef=xs[0], nf=xs[1], gf=xs[2]))
        loss_p = (y.ef.square().sum() + y.nf.square().sum()
                  + y.gf.square().sum())
        loss_p.backward()
    finally:
        cfg.split_linear, cfg_pt.split_linear = old
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-4)
    for x, gr in zip(xs, grads_j):
        _close(x.grad, gr, 1e-4)


@pytest.mark.parametrize("value,expect", [("0", False), ("1", True),
                                          (None, True)])
def test_split_linear_reads_its_environment_variable(value, expect):
    env = {k: v for k, v in os.environ.items()
           if k != "GRAPHNETS_TPU_TORCH_SPLIT_LINEAR"}
    if value is not None:
        env["GRAPHNETS_TPU_TORCH_SPLIT_LINEAR"] = value
    out = subprocess.run(
        [sys.executable, "-c",
         "from graphnets_tpu_torch.utils.config import use_split_linear;"
         "print(use_split_linear())"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(expect)


TRAJ_STEPS, TRAJ_LR = 10, 1e-3


def _flat_params(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("route", ["pure", "kernels"])
def test_node_classification_trajectory_matches_jax(monkeypatch, route):
    """Ten f32 Adam(1e-3) steps on ten sampled batches (the reduced shape of
    the one-step test in ``test_torch_large_graph.py``): the port's
    trajectory is JAX's, so a divergence of the loss on the card over such
    steps belongs to the model and its data, not to the port."""
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setenv("GRAPHNETS_TPU_TORCH_NATIVE", "0")
    restore = _route(route == "kernels")
    try:
        rng = np.random.default_rng(0)
        n, d, n_classes, e = 300, 16, 4, 1800
        senders, receivers = rng.integers(0, n, e), rng.integers(0, n, e)
        labels = rng.integers(0, n_classes, n)
        feat = rng.normal(size=(n, d)).astype(np.float32)
        feat[:, :n_classes] += 3.0 * np.eye(n_classes,
                                            dtype=np.float32)[labels]
        coo = (senders, receivers, feat, labels)
        gj = j_lg.LargeGraph.from_coo(*coo)
        gp = pt_lg.LargeGraph.from_coo(*coo)
        kw = dict(fanouts=(4, 4), batch_size=8, seed=3, emit_node_ids=True)
        sj = j_lg.NeighborSampler(gj, **kw)
        sp = pt.NeighborSampler(gp, device="cpu", **kw)
        model_j = JEncodeProcessDecode((0, d, 0), (128,) * 3,
                                       (1, n_classes, 0), n_cores=1)
        params = model_j.init(jax.random.PRNGKey(0))
        model_p = pt.EncodeProcessDecode((0, d, 0), (128,) * 3,
                                         (1, n_classes, 0), n_cores=1,
                                         device="cpu")
        pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           model_p)
        feat_j = j_lg.device_feature_table(gj, jnp.float32)
        feat_p = pt.device_feature_table(gp, device="cpu")
        opt = optax.adam(TRAJ_LR)
        state = opt.init(params)
        step_p = pt.make_node_classification_step(
            model_p, torch.optim.Adam(model_p.parameters(), lr=TRAJ_LR,
                                      eps=1e-8), n_classes)
        for k in range(TRAJ_STEPS):
            seeds = np.arange(8 * k, 8 * k + 8)
            bj, bp = sj.sample(seeds), sp.sample(seeds)

            def loss_j(p, bj=bj):
                graph = bj.graph.with_features(
                    nf=jnp.take(feat_j, bj.node_ids, axis=0))
                pred = model_j.apply(p, graph, training=True)
                return j_masked_ce(pred.nf[bj.seed_local_idx],
                                   jax.nn.one_hot(bj.labels, n_classes),
                                   bj.label_mask)

            l_j, g_j = jax.value_and_grad(loss_j)(params)
            updates, state = opt.update(g_j, state, params)
            params = optax.apply_updates(params, updates)
            l_p = step_p(bp.graph, bp.node_ids, bp.labels, bp.label_mask,
                         bp.seed_local_idx, feat_p)
            np.testing.assert_allclose(float(l_p), float(l_j), rtol=1e-4,
                                       err_msg=f"step {k}")
    finally:
        restore()
    flat = _flat_params(params)
    for name, p in model_p.named_parameters():
        ref = np.asarray(flat[name], np.float32)
        assert tuple(p.shape) == ref.shape, name
        if p.numel() == 0:
            continue
        np.testing.assert_allclose(
            _np(p), ref, rtol=0,
            atol=1e-4 * max(np.abs(ref).max(), 1.0) + 0.1 * TRAJ_LR,
            err_msg=name)
