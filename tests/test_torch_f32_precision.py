"""The JAX package's default precision (f32) on the port's kernel routes,
against graphnets_tpu.

``Policy()`` computes in f32 by default, so a model taken to the card with
the package's defaults runs the fused FFN pair on f32 rows.  Two routes of
``chip_smoke.py`` phase F, at a small size:

* F(a), the headline forward on a uniform f32 batch: the fused edge
  update's gate is bf16 only, so both packages take the split-linear
  route (``ln_matmul``, the sorted gather-add of the receivers term, the
  sorted sum) and the fused FFN on every feature set;
* F(b), a single large graph in f32 under training: the single-graph
  edge update with its sum and, from ``_FUSED_FFN_TRAIN_MIN_ROWS`` rows up
  (patched small on both classes), the fused FFN with its recomputing
  backward.

The same numpy inputs go through both packages (the JAX kernels in Pallas
interpret mode, the port's wrappers in their plain versions on the CPU).
Tolerances: outputs and the loss of one step 1e-4 of the largest
magnitude (f32 sums in another order); each gradient 1e-4 of its largest
magnitude or, where that fails, 1e-3 of its norm in the 2-norm, the rule
``chip_smoke.py`` holds C's and F(b)'s million-row gradients to.  The
second clause is for the FFN's relu mask, which an f32 pre-activation
within summation-order rounding of 0 flips: in F(b)'s case one of core
1's 8.4M edge pre-activations lies 2e-8 from 0 in f64, torch's f32
product puts it on the other side from XLA's, and that one row moves a
column of core 1's edge-FFN W1 gradient by 7.2e-3 of the tensor's largest
element, 7.1e-4 in the 2-norm (JAX's own two routes agree with f64 within
5e-7 there: both take XLA's product).  The f32 backward's weight-pass
split, which only the card runs, is checked here for the C entry's
preconditions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.ops.pallas import edge_update_g1 as j_g1
from graphnets_tpu.ops.pallas import fused_ffn as j_ffn
from graphnets_tpu.ops.pallas import gather as j_ga
from graphnets_tpu.ops.pallas import ln_linear as j_ll
from graphnets_tpu.ops.pallas import segment_sum as j_ss
from graphnets_tpu.training import losses as jl
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops.kernels import edge_update_g1 as pt_g1
from graphnets_tpu_torch.ops.kernels import fused_ffn as pt_ffn
from graphnets_tpu_torch.ops.kernels import gather as pt_ga
from graphnets_tpu_torch.ops.kernels import ln_linear as pt_ll
from graphnets_tpu_torch.ops.kernels import segment_sum as pt_ss
from graphnets_tpu_torch.utils import config as pt_config


@pytest.fixture
def kernels_on():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(True, interpret=True)
    pt.enable_kernels(True)
    yield
    enable_pallas(old[0], interpret=old[1])
    pt_config.get_config().use_kernels = old_pt


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _close(out, ref, tol, what=""):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(out).all(), what
    err = np.abs(out - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), \
        (what, err, np.abs(ref).max())


def _close_or_norm(out, ref, what=""):
    """Within 1e-4 of the largest magnitude, or within 1e-3 in the 2-norm
    (a flipped relu mask; see the module docstring)."""
    out, ref = _np(out).astype(np.float64), _np(ref).astype(np.float64)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    top = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    norm = np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30)
    assert top <= 1e-4 or norm <= 1e-3, (what, top, norm)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _spies(monkeypatch, targets):
    """Counts the calls of ``(module, name)`` under ``key``."""
    calls = {key: 0 for key in targets}
    for key, (mod, name) in targets.items():
        def spy(*a, _real=getattr(mod, name), _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return calls


# -- F(a): the headline forward in f32 ------------------------------------


def _uniform_batch(seed, G, n_nodes, deg, d):
    """``bench.py``'s graphs at width d: G graphs of ``n_nodes`` nodes, each
    with ``deg`` distinct in-neighbours, in ``PadSpec.uniform``."""
    rng = np.random.default_rng(seed)
    adjs, efs, nfs = [], [], []
    for _ in range(G):
        adj = np.zeros((n_nodes, n_nodes), np.int64)
        for r in range(n_nodes):
            adj[rng.choice(n_nodes, size=deg, replace=False), r] = 1
        adjs.append(adj)
        efs.append(rng.normal(size=(n_nodes * deg, d)).astype(np.float32))
        nfs.append(rng.normal(size=(n_nodes, d)).astype(np.float32))
    data = {"graphs": adjs, "ef": efs, "nf": nfs,
            "gf": rng.normal(size=(G, d)).astype(np.float32)}
    pad = gn.PadSpec.uniform(n_nodes, n_nodes * deg)
    return gn.batch(data, pad=pad), pt.batch(data, pad=pad, device="cpu")


def test_f32_headline_forward_route_matches_jax(kernels_on, monkeypatch):
    """Phase F(a)'s route at width 128 on the headline's layout (8 graphs of
    128 nodes and in-degree 16): per core one ``ln_matmul``, one sorted
    gather-add and one sorted sum on the edge route and the fused FFN on
    the three feature sets, in both packages; outputs within 1e-4."""
    d, n_cores = 128, 2
    gj, gp = _uniform_batch(11, 8, 128, 16, d)
    assert gp.ef.dtype == torch.float32 and gp.slot_shape == (128, 2048)
    stack_j = gn.GNCoreList([gn.GNCore((d, d, d)) for _ in range(n_cores)])
    params = stack_j.init(jax.random.PRNGKey(6))
    jcalls = _spies(monkeypatch, {
        "ln_matmul": (j_ll, "ln_matmul"),
        "gather_add": (j_ga, "sorted_gather_add"),
        "segment_sum": (j_ss, "sorted_segment_sum"),
        "ffn": (j_ffn, "_fused_forward")})
    y_j = stack_j.apply(params, gj)
    stack_p = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu")
                             for _ in range(n_cores)])
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), stack_p)
    calls = _spies(monkeypatch, {
        "ln_matmul": (pt_ll, "ln_matmul_reference"),
        "gather_add": (pt_ga, "sorted_gather_add_plain"),
        "segment_sum": (pt_ss, "sorted_segment_sum_plain"),
        "ffn": (pt_ffn, "ln_ffn_residual_plain")})
    with torch.no_grad():
        y_p = stack_p(gp)
    want = {"ln_matmul": n_cores, "gather_add": n_cores,
            "segment_sum": n_cores, "ffn": 3 * n_cores}
    assert jcalls == want
    assert calls == want
    for key in ("ef", "nf", "gf"):
        _close(getattr(y_p, key), getattr(y_j, key), 1e-4, key)


# -- F(b): a single large graph trained in f32 -----------------------------


def _single_graph(seed, N, deg, d):
    """One graph of N nodes and E = N * deg edges (random senders, sorted
    random receivers, as ``chip_smoke.large_graph``), f32 features of width
    d and random-normal node and edge targets."""
    rng = np.random.default_rng(seed)
    E = N * deg
    senders = rng.integers(0, N, size=E).astype(np.int32)
    receivers = np.sort(rng.integers(0, N, size=E)).astype(np.int32)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    ef, nf, gf, yef, ynf = f(E, d), f(N, d), f(1, d), f(E, d), f(N, d)
    common = dict(n_node=[N], n_edge=[E])
    gj = gn.GraphsTuple(
        senders=jnp.asarray(senders), receivers=jnp.asarray(receivers),
        node_graph=jnp.zeros((N,), jnp.int32),
        edge_graph=jnp.zeros((E,), jnp.int32),
        n_node=jnp.asarray(common["n_node"], jnp.int32),
        n_edge=jnp.asarray(common["n_edge"], jnp.int32),
        node_mask=jnp.ones((N,), bool), edge_mask=jnp.ones((E,), bool),
        graph_mask=jnp.ones((1,), bool), ef=jnp.asarray(ef),
        nf=jnp.asarray(nf), gf=jnp.asarray(gf))
    t = torch.from_numpy
    gp = pt.GraphsTuple(
        senders=t(senders), receivers=t(receivers),
        node_graph=torch.zeros(N, dtype=torch.int32),
        edge_graph=torch.zeros(E, dtype=torch.int32),
        n_node=torch.tensor(common["n_node"], dtype=torch.int32),
        n_edge=torch.tensor(common["n_edge"], dtype=torch.int32),
        node_mask=torch.ones(N, dtype=torch.bool),
        edge_mask=torch.ones(E, dtype=torch.bool),
        graph_mask=torch.ones(1, dtype=torch.bool), ef=t(ef), nf=t(nf),
        gf=t(gf))
    yj = gj.with_features(ef=jnp.asarray(yef), nf=jnp.asarray(ynf), gf=None)
    yp = gp.with_features(ef=t(yef), nf=t(ynf), gf=None)
    return gj, yj, gp, yp


def test_f32_large_graph_step_matches_jax(kernels_on, monkeypatch):
    """Phase F(b)'s route at a small size: one graph of N = 1024 nodes of
    in-degree 16, 2 cores at width 128, f32 parameters and features,
    ``_FUSED_FFN_TRAIN_MIN_ROWS`` patched to N on both classes so that the
    edge and node sets train through the fused FFN and its backward (the
    1-row graph set composes).  Per core both packages launch the
    single-graph update with its sum and two fused FFN backwards; one
    ``make_train_step`` step with no compute-dtype cast (the port) against
    ``jax.value_and_grad`` (JAX): the loss within 1e-4 relative, every
    gradient by :func:`_close_or_norm`."""
    N, deg, d, n_cores = 1024, 16, 128, 2
    gj, yj, gp, yp = _single_graph(12, N, deg, d)
    monkeypatch.setattr(gn.GNCore, "_FUSED_FFN_TRAIN_MIN_ROWS", N)
    monkeypatch.setattr(pt.GNCore, "_FUSED_FFN_TRAIN_MIN_ROWS", N)
    stack_j = gn.GNCoreList([gn.GNCore((d, d, d)) for _ in range(n_cores)])
    params = stack_j.init(jax.random.PRNGKey(7))
    jcalls = _spies(monkeypatch, {"g1": (j_g1, "_forward"),
                                  "ffn_backward": (j_ffn, "_fused_backward")})
    loss_j, grads_j = jax.value_and_grad(lambda p: jl.graph_loss_nf_ef(
        stack_j.apply(p, gj, training=True), yj))(params)
    grads_j = _flat(grads_j)
    assert jcalls == {"g1": n_cores, "ffn_backward": 2 * n_cores}

    stack_p = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu")
                             for _ in range(n_cores)])
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), stack_p)
    step = pt.make_train_step(stack_p, pt.adamw(stack_p.parameters(), 3e-4))
    calls = _spies(monkeypatch, {
        "g1_agg": (pt_g1, "g1_edge_update_agg_plain"),
        "ffn": (pt_ffn, "ln_ffn_residual_plain"),
        "ffn_backward": (pt_ffn, "ln_ffn_backward_plain")})
    m = step(gp, yp)
    assert calls == {"g1_agg": n_cores, "ffn": 2 * n_cores,
                     "ffn_backward": 2 * n_cores}
    _close(float(m["loss"]), float(loss_j), 1e-4, "loss")
    assert set(grads_j) == {n for n, _ in stack_p.named_parameters()}
    for n, p in stack_p.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close_or_norm(grad, grads_j[n], n)


# -- the f32 backward's weight-pass split ----------------------------------


@pytest.mark.parametrize("T", [8, 408, 65536, 1048576])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_f32_weight_pass_ranges(d, T):
    """The row ranges ``_launch_backward`` hands the f32 weight pass keep
    the C entry's preconditions (``splits = ceil(T / rows)``, rows a
    multiple of 64, at least 256 unless there is one range) and give at
    least two blocks an SM of an H100 where T allows."""
    sms = 132
    tiles = 2 * (4 * d // 128) * (d // 128)
    splits, rows = pt_ffn._weight_splits_f32(T, tiles, sms)
    assert rows % 64 == 0 and splits == -(-T // rows)
    assert splits == 1 or rows >= 256
    if T >= 256 * -(-2 * sms // tiles):
        assert tiles * splits >= 2 * sms
