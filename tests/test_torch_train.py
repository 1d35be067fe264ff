"""The port's training step against graphnets_tpu's.

The same numpy graphs, targets and f32 parameters go through the JAX
package's ``make_train_step`` with ``optax.adamw(3e-4)`` and the port's
``make_train_step`` with ``adamw(3e-4)``, on the CPU: 2 GNCores at
d = 128 on 4 graphs x 32 nodes x in-degree 8 (``PadSpec.uniform(32, 256)``:
E = 1024, N = 128 > 64, so the node sums take the sorted kernel route),
in an exact and a padded layout.  Tolerances, each with its reason:

* kernel route (bf16 compute, f32 parameters; JAX in Pallas interpret
  mode, the port on its kernels' plain versions): the loss within 1e-2
  relative and each gradient within 5e-2 x max |ref grad| of its tensor
  (bf16 activations rounded at other points), or within the distance
  between the JAX package's own two bf16 routes (Pallas and pure) where
  that is larger: a bf16 ulp in a pre-relu value flips the relu, and on
  the FFN weights of the last core the JAX routes differ by more than
  5e-2 of the largest gradient between themselves; the updated parameters
  within 2 lr + 1e-6, since Adam's first step is about lr * sign(g) and a
  gradient near 0 may flip sign;
* pure route (kernels off, f32 throughout): gradients at rtol 1e-3 and
  an absolute 1e-5 x max |ref grad| of the tensor: the edge-net gradients
  are f32 sums over ~1000 edges taken in another order, whose rounding
  exceeds 1e-6 on entries near 0;
* AdamW alone on the same gradients: rtol 1e-6 / atol 1e-9 (the same
  update, rounded in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.training import losses as jl
from graphnets_tpu.training.train import TrainState, make_train_step
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops.kernels import edge_update as pt_eu
from graphnets_tpu_torch.ops.kernels import fused_ffn as pt_ffn
from graphnets_tpu_torch.ops.kernels import gather as pt_ga
from graphnets_tpu_torch.ops.kernels import ln_linear as pt_ll
from graphnets_tpu_torch.ops.kernels import segment_sum as pt_ss
from graphnets_tpu_torch.utils import config as pt_config

LR = 3e-4
G, N_SLOTS, DEG = 4, 32, 8


@pytest.fixture
def kernels_on():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(True, interpret=True)
    pt.enable_kernels(True)
    yield
    enable_pallas(old[0], interpret=old[1])
    pt_config.get_config().use_kernels = old_pt


@pytest.fixture
def kernels_off():
    old = get_config().use_pallas
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(False)
    pt.enable_kernels(False)
    yield
    enable_pallas(old)
    pt_config.get_config().use_kernels = old_pt


def _data(seed, d, padded):
    """G random graphs, each node with DEG distinct in-neighbours; with
    ``padded`` graph b has 31 - b nodes in its 32 slots."""
    rng = np.random.default_rng(seed)
    adjs, efs, nfs = [], [], []
    for b in range(G):
        n = N_SLOTS - 1 - b if padded else N_SLOTS
        adj = np.zeros((n, n), np.int64)
        for r in range(n):
            adj[rng.choice(n, size=DEG, replace=False), r] = 1
        adjs.append(adj)
        efs.append(rng.normal(size=(n * DEG, d)).astype(np.float32))
        nfs.append(rng.normal(size=(n, d)).astype(np.float32))
    gf = rng.normal(size=(G, d)).astype(np.float32)
    return {"graphs": adjs, "ef": efs, "nf": nfs, "gf": gf}


def _batches(seed, d, padded, bf16):
    """The batch and the targets (random normal node and edge labels, as
    ``benchmarks/bench_train_step.py``) in both packages."""
    pad = gn.PadSpec.uniform(N_SLOTS, N_SLOTS * DEG)
    data = _data(seed, d, padded)
    gj = gn.batch(data, pad=pad)
    gp = pt.batch(data, pad=pad, device="cpu")
    rng = np.random.default_rng(seed + 100)
    yef = rng.normal(size=(gj.num_edge_slots, d)).astype(np.float32)
    ynf = rng.normal(size=(gj.num_node_slots, d)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    gj = gj.with_features(ef=gj.ef.astype(jdt), nf=gj.nf.astype(jdt),
                          gf=gj.gf.astype(jdt))
    gp = gp.with_features(ef=gp.ef.to(tdt), nf=gp.nf.to(tdt),
                          gf=gp.gf.to(tdt))
    yj = gj.with_features(ef=jnp.asarray(yef, jdt), nf=jnp.asarray(ynf, jdt),
                          gf=None)
    yp = gp.with_features(ef=torch.from_numpy(yef).to(tdt),
                          nf=torch.from_numpy(ynf).to(tdt), gf=None)
    return gj, yj, gp, yp


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


class _CastModel:
    """A JAX model whose ``apply`` runs the stack on parameters cast to
    ``dtype`` (the headline step's f32 masters, bf16 compute)."""

    def __init__(self, stack, dtype):
        self.stack, self.dtype = stack, dtype

    def apply(self, params, x, training=False, rng=None):
        cast = jax.tree_util.tree_map(lambda p: p.astype(self.dtype), params)
        return self.stack.apply(cast, x, training=training)


def _jax_grads(model, params, gj, yj):
    return jax.value_and_grad(
        lambda p: jl.graph_loss_nf_ef(model.apply(p, gj, training=True),
                                      yj))(params)


def _jax_step(gj, yj, d, dtype):
    """JAX: loss, gradients (flat) and the parameters after one step."""
    stack = gn.GNCoreList([gn.GNCore((d, d, d)) for _ in range(2)])
    params = stack.init(jax.random.PRNGKey(0))
    model = _CastModel(stack, dtype)
    loss, grads = _jax_grads(model, params, gj, yj)
    opt = optax.adamw(LR)
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(1))
    state, metrics = make_train_step(model, opt)(state, gj, yj)
    return (params, float(loss), _flat(grads), _flat(state.params),
            {k: float(v) for k, v in metrics.items()})


def _port_step(params, gp, yp, d, compute_dtype):
    stack = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu")
                           for _ in range(2)])
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), stack)
    step = pt.make_train_step(stack, pt.adamw(stack.parameters(), LR),
                              compute_dtype=compute_dtype)
    metrics = step(gp, yp)
    grads = {n: p.grad.numpy() for n, p in stack.named_parameters()}
    for n, p in stack.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
    return ({k: float(v) for k, v in metrics.items()}, grads,
            _flat(pt.to_numpy_tree(stack)))


@pytest.mark.parametrize("padded", [False, True])
def test_train_step_kernel_route_matches_jax(kernels_on, padded):
    d = 128
    gj, yj, gp, yp = _batches(1, d, padded, bf16=True)
    assert gp.slot_shape == (N_SLOTS, N_SLOTS * DEG)
    params, loss_j, grads_j, new_j, metrics_j = _jax_step(gj, yj, d,
                                                          jnp.bfloat16)
    metrics_p, grads_p, new_p = _port_step(params, gp, yp, d,
                                           torch.bfloat16)
    enable_pallas(False)
    stack = gn.GNCoreList([gn.GNCore((d, d, d)) for _ in range(2)])
    _, pure = _jax_grads(_CastModel(stack, jnp.bfloat16), params, gj, yj)
    spread = {n: np.abs(g - grads_j[n]).max() for n, g in _flat(pure).items()}
    assert abs(metrics_p["loss"] - loss_j) <= 1e-2 * abs(loss_j)
    assert abs(metrics_p["loss"] - metrics_j["loss"]) <= 1e-2 * abs(loss_j)
    for k in ("node_acc", "edge_acc", "graph_acc"):
        assert 0.0 <= metrics_p[k] <= 1.0
    assert set(grads_p) == set(grads_j) == set(new_p)
    for n, gref in grads_j.items():
        assert np.isfinite(grads_p[n]).all(), n
        err = np.abs(grads_p[n] - gref).max()
        bound = max(5e-2 * np.abs(gref).max(), spread[n])
        assert err <= bound + 1e-12, (n, err, bound)
        np.testing.assert_allclose(new_p[n], new_j[n], rtol=0,
                                   atol=2 * LR + 1e-6, err_msg=n)


def test_train_step_pure_route_matches_jax(kernels_off):
    d = 32
    gj, yj, gp, yp = _batches(2, d, True, bf16=False)
    params, loss_j, grads_j, new_j, _ = _jax_step(gj, yj, d, jnp.float32)
    metrics_p, grads_p, new_p = _port_step(params, gp, yp, d, None)
    np.testing.assert_allclose(metrics_p["loss"], loss_j, rtol=1e-5)
    for n, gref in grads_j.items():
        np.testing.assert_allclose(grads_p[n], gref, rtol=1e-3,
                                   atol=1e-5 * np.abs(gref).max() + 1e-12,
                                   err_msg=n)
        np.testing.assert_allclose(new_p[n], new_j[n], rtol=0,
                                   atol=2 * LR + 1e-6, err_msg=n)


def test_adamw_matches_optax():
    rng = np.random.default_rng(3)
    p0 = {"w": rng.normal(size=(6, 5)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    opt = optax.adamw(LR)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(pj)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = pt.adamw(tp.values(), LR)
    for g in grads:
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                state, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-9)



@pytest.mark.parametrize("path", ["optimizer", "plain"])
def test_missing_gradient_matches_optax(path):
    """A parameter with no gradient (``None``) is one with a zero gradient,
    as optax updates every leaf: decayed, its moments advanced.  Over 3
    steps, through ``pt.adamw``'s own step and through the plain version
    of the card's one-launch update (``ops/kernels/adamw``), against
    ``optax.adamw`` given zeros for that leaf; tolerances as above."""
    from graphnets_tpu_torch.ops.kernels import adamw as pt_aw
    rng = np.random.default_rng(4)
    p0 = {"w": rng.normal(size=(6, 5)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": None} for _ in range(3)]
    opt = optax.adamw(LR)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(pj)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = pt.adamw(tp.values(), LR)
    moments = {k: (torch.zeros_like(p), torch.zeros_like(p), torch.zeros(()))
               for k, p in tp.items()}
    for g in grads:
        gj = {k: jnp.zeros_like(pj[k]) if v is None else jnp.asarray(v)
              for k, v in g.items()}
        upd, state = opt.update(gj, state, pj)
        pj = optax.apply_updates(pj, upd)
        gt = {k: None if v is None else torch.from_numpy(v)
              for k, v in g.items()}
        if path == "optimizer":
            for k, p in tp.items():
                p.grad = gt[k]
            topt.step()
        else:
            with torch.no_grad():
                pt_aw.adamw_update_plain(
                    list(tp.values()), [gt[k] for k in tp],
                    *[[moments[k][i] for k in tp] for i in range(3)],
                    lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                    weight_decay=1e-4)
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-9)
    assert not np.array_equal(tp["b"].detach().numpy(), p0["b"])

_PLAIN = [(pt_eu, "fused_edge_update_plain"),
          (pt_ss, "sorted_segment_sum_plain"),
          (pt_ss, "windowed_segment_sum_plain"),
          (pt_ga, "sorted_gather_plain"),
          (pt_ll, "ln_linear_backward_plain"),
          (pt_eu, "fused_edge_update_agg_plain"),
          (pt_ffn, "ln_ffn_residual_plain")]


@pytest.mark.parametrize("d", [128, 384])
def test_train_step_takes_the_training_kernels(kernels_on, monkeypatch, d):
    """Per core and step: one edge update (h alone), one sorted sum
    forward and one in the edge update's backward, one windowed sum, one
    sorted gather (the sum's backward) and one LN backward.  The inference
    forms and the fused FFN are not reached: at d = 128 the small feature
    sets take the composed reference, at d = 384 branch 2 is composed from
    plain ops (the JAX training gates)."""
    calls = {name: 0 for _, name in _PLAIN}
    for mod, name in _PLAIN:
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    _, _, gp, yp = _batches(4, d, False, bf16=True)
    stack = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu")
                           for _ in range(2)])
    step = pt.make_train_step(stack, pt.adamw(stack.parameters(), LR),
                              compute_dtype=torch.bfloat16)
    before = (pt_eu.LAUNCHES_NO_AGG, pt_ss.LAUNCHES, pt_ga.LAUNCHES,
              pt_ll.LAUNCHES, pt_ss.WINDOWED_LAUNCHES)
    m = step(gp, yp)
    assert np.isfinite(float(m["loss"]))
    assert calls == {"fused_edge_update_plain": 2,
                     "sorted_segment_sum_plain": 4,
                     "windowed_segment_sum_plain": 2,
                     "sorted_gather_plain": 2,
                     "ln_linear_backward_plain": 2,
                     "fused_edge_update_agg_plain": 0,
                     "ln_ffn_residual_plain": 0}
    assert (pt_eu.LAUNCHES_NO_AGG, pt_ss.LAUNCHES, pt_ga.LAUNCHES,
            pt_ll.LAUNCHES, pt_ss.WINDOWED_LAUNCHES) == before


def test_fused_ffn_training_gates_match_jax(kernels_on):
    """The gate constants are the JAX package's, and the case the JAX
    package sends to the fused FFN backward (d <= 256 and a feature set of
    >= 65,536 rows; the row bound is lowered here to reach it at a test
    size) trains through the fused function's own backward."""
    assert pt.GNCore._FUSED_FFN_TRAIN_MAX_DIM == \
        gn.GNCore._FUSED_FFN_TRAIN_MAX_DIM
    assert pt.GNCore._FUSED_FFN_TRAIN_MIN_ROWS == \
        gn.GNCore._FUSED_FFN_TRAIN_MIN_ROWS
    d = 128
    _, _, gp, _ = _batches(5, d, False, bf16=True)
    core = pt.GNCore((d, d, d), device="cpu", dtype=torch.bfloat16)
    calls = []
    real = pt_ffn.ln_ffn_backward_plain
    try:
        pt_ffn.ln_ffn_backward_plain = \
            lambda *a: calls.append(a[0].shape[0]) or real(*a)
        core._FUSED_FFN_TRAIN_MIN_ROWS = gp.num_edge_slots
        core(gp, training=True).ef.float().sum().backward()
        assert calls == [gp.num_edge_slots]   # the edge set alone
        assert np.isfinite(core.ffwd.eff[0].w.grad.float().numpy()).all()
        core._FUSED_FFN_TRAIN_MIN_ROWS = gp.num_edge_slots + 1
        out = core(gp, training=True).ef
        out.float().sum().backward()
        assert calls == [gp.num_edge_slots]   # below the bound: composed
    finally:
        pt_ffn.ln_ffn_backward_plain = real
    assert np.isfinite(out.detach().float().numpy()).all()


def test_losses_match_jax():
    d = 16
    gj, yj, gp, yp = _batches(6, d, True, bf16=False)
    rng = np.random.default_rng(7)
    pef = rng.normal(size=(gj.num_edge_slots, d)).astype(np.float32)
    pnf = rng.normal(size=(gj.num_node_slots, d)).astype(np.float32)
    # Make graph 0 entirely right so graph accuracy is not trivially 0.
    lo, hi = 0, N_SLOTS
    pnf[lo:hi] = np.asarray(yj.nf)[lo:hi] * 10
    pef[:N_SLOTS * DEG] = np.asarray(yj.ef)[:N_SLOTS * DEG] * 10
    pj = gj.with_features(ef=jnp.asarray(pef), nf=jnp.asarray(pnf))
    pp = gp.with_features(ef=torch.from_numpy(pef), nf=torch.from_numpy(pnf))
    np.testing.assert_allclose(float(pt.graph_loss_nf_ef(pp, yp)),
                               float(jl.graph_loss_nf_ef(pj, yj)), rtol=1e-6)
    np.testing.assert_allclose(
        float(pt.masked_logit_crossentropy(pp.ef, yp.ef, pp.edge_mask)),
        float(jl.masked_logit_crossentropy(pj.ef, yj.ef, pj.edge_mask)),
        rtol=1e-6)
    assert float(pt.masked_accuracy(pp.nf, yp.nf, pp.node_mask)) == \
        pytest.approx(float(jl.masked_accuracy(pj.nf, yj.nf, pj.node_mask)))
    real = np.asarray(gj.graph_mask)
    np.testing.assert_array_equal(
        pt.per_graph_correct(pp, yp).numpy()[real],
        np.asarray(jl.per_graph_correct(pj, yj))[real])
    acc = float(pt.graph_accuracy(pp, yp))
    assert acc == pytest.approx(float(jl.graph_accuracy(pj, yj)))
    assert acc > 0


def test_to_numpy_tree_inverts_from_jax_params():
    a = pt.GNCore((8, 8, 8), device="cpu",
                  generator=torch.Generator().manual_seed(1))
    b = pt.GNCore((8, 8, 8), device="cpu",
                  generator=torch.Generator().manual_seed(2))
    tree = pt.to_numpy_tree(a)
    assert set(tree) == {"block", "ffwd", "gn1", "gn2"}
    assert tree["block"]["edgefn"]["w"].shape == (32, 8)
    pt.from_jax_params(tree, b)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
