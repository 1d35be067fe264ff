"""``remat`` in the port (``GNCoreList(remat=True)``,
``EncodeProcessDecode(remat=True)``): each core under activation
checkpointing, as the JAX package runs each under ``jax.checkpoint``.

On the CPU, loss and gradients with ``remat`` are bit-equal to those
without, dropout > 0 drawn from an explicit generator included (the
recompute replays the generator from the state its core began with), and
with the parameters cast for the forward as ``make_train_step`` casts
them.  Against JAX's ``remat=True`` in f32 (no dropout: the two packages'
random streams differ): the loss within 1e-5 relative and each gradient
within 1e-4 of its largest magnitude (f32 sums in another order).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.models.encode_process_decode import \
    EncodeProcessDecode as JEncodeProcessDecode


def _data(seed=17, d=8):
    rng = np.random.default_rng(seed)
    adjs = [np.ones((3, 3), int), np.ones((4, 4), int),
            (rng.random((5, 5)) < 0.5).astype(int)]
    return {
        "graphs": adjs,
        "ef": [rng.normal(size=(int(a.sum()), d)).astype(np.float32)
               for a in adjs],
        "nf": [rng.normal(size=(a.shape[0], d)).astype(np.float32)
               for a in adjs],
        "gf": rng.normal(size=(3, d)).astype(np.float32),
    }


def _weights(g, seed=3):
    """Random loss weights on the real slots (padded slots carry no
    meaning, and the two packages may differ there)."""
    rng = np.random.default_rng(seed)
    masks = {"ef": g.edge_mask, "nf": g.node_mask, "gf": g.graph_mask}
    return {k: rng.normal(size=tuple(getattr(g, k).shape)).astype(np.float32)
            * masks[k].numpy()[:, None].astype(np.float32)
            for k in ("ef", "nf", "gf") if getattr(g, k) is not None}


def _loss_pt(y, w):
    return sum((getattr(y, k).float() * torch.from_numpy(v)).sum()
               for k, v in w.items())


def _loss_jax(y, w):
    return sum(jnp.sum(getattr(y, k) * v) for k, v in w.items())


def _run(model, x, w, dropout_seed, cast=None):
    """Loss and gradients of one training forward; dropout masks from a
    fresh explicit generator seeded ``dropout_seed``."""
    gen = torch.Generator().manual_seed(dropout_seed)
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    run = params if cast is None else {n: p.to(cast)
                                       for n, p in params.items()}
    y = functional_call(model, run, (x,), {"training": True,
                                           "generator": gen})
    loss = _loss_pt(y, w)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in params.items()
                           if p.grad is not None}, gen.get_state()


def _corelist(d, dropout, remat):
    gen = torch.Generator().manual_seed(1)
    return pt.GNCoreList([pt.GNCore((d, d, d), dropout, device="cpu",
                                    generator=gen) for _ in range(3)],
                         remat=remat)


@pytest.mark.parametrize("cast", [None, torch.float64])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_corelist_remat_bit_equal_without(dropout, cast):
    x = pt.batch(_data(), pad=pt.PadSpec(16, 64, 4), device="cpu")
    if cast is not None:
        x = x.with_features(ef=x.ef.to(cast), nf=x.nf.to(cast),
                            gf=x.gf.to(cast))
    w = _weights(x)
    plain = _corelist(8, dropout, remat=False)
    remat = copy.deepcopy(plain)
    remat.remat = True
    l1, g1, s1 = _run(plain, x, w, 5, cast)
    l2, g2, s2 = _run(remat, x, w, 5, cast)
    assert torch.equal(l1, l2)
    assert g1.keys() == g2.keys() and len(g1) == len(
        list(plain.parameters()))
    for n in g1:
        assert torch.equal(g1[n], g2[n]), n
    # The generator ends where it would without remat: the recompute put
    # it back after replaying the forward's masks.
    assert torch.equal(s1, s2)


def test_epd_remat_bit_equal_without_dropout_generator():
    cfg = pt.SortTaskConfig()
    x, y = pt.get_batch(np.random.default_rng(0), cfg, device="cpu")
    kw = dict(x_dims=(0, cfg.vocab_size, 0), core_dims=(16, 16, 16),
              y_dims=(2, 2, 0), n_cores=2, dropout=0.3, device="cpu",
              generator=torch.Generator().manual_seed(2))
    plain = pt.EncodeProcessDecode(**kw)
    remat = pt.EncodeProcessDecode(remat=True, **kw)
    assert remat.core.remat and not plain.core.remat
    remat.load_state_dict(plain.state_dict())
    out = []
    for m in (plain, remat):
        gen = torch.Generator().manual_seed(9)
        for p in m.parameters():
            p.grad = None
        loss = pt.graph_loss_nf_ef(m(x, training=True, generator=gen), y)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in m.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_remat_train_step_bit_equal_without():
    """``make_train_step`` on a remat model: the same loss and the same
    parameters after an AdamW step, with dropout drawn from the step's
    generator."""
    cfg = pt.SortTaskConfig()
    x, y = pt.get_batch(np.random.default_rng(1), cfg, device="cpu")
    models = [pt.EncodeProcessDecode((0, cfg.vocab_size, 0), (16,) * 3,
                                     (2, 2, 0), dropout=0.1, remat=r,
                                     device="cpu") for r in (False, True)]
    losses = []
    for m in models:
        step = pt.make_train_step(m, pt.adamw(m.parameters()),
                                  generator=torch.Generator().manual_seed(4))
        losses.append(step(x, y)["loss"])
    assert torch.equal(*losses)
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)


def test_remat_without_grad_is_the_plain_forward():
    x = pt.batch(_data(), pad=pt.PadSpec(16, 64, 4), device="cpu")
    plain = _corelist(8, 0.0, remat=False)
    remat = copy.deepcopy(plain)
    remat.remat = True
    with torch.no_grad():
        a, b = plain(x), remat(x)
    for k in ("ef", "nf", "gf"):
        assert torch.equal(getattr(a, k), getattr(b, k))


def _g1_batch(seed=31, N=128, E=512, d=128, pad_edges=64):
    """One graph (the single-graph route): random senders, ascending
    receivers, pad edges on the last node, bf16 features and targets."""
    rng = np.random.default_rng(seed)
    n_real, e_real = N - 1, E - pad_edges
    senders = np.concatenate([rng.integers(0, n_real, e_real),
                              np.full(pad_edges, N - 1)]).astype(np.int32)
    receivers = np.concatenate([np.sort(rng.integers(0, n_real, e_real)),
                                np.full(pad_edges, N - 1)]).astype(np.int32)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(torch.bfloat16)
    x = pt.GraphsTuple(
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        node_graph=torch.zeros(N, dtype=torch.int32),
        edge_graph=torch.zeros(E, dtype=torch.int32),
        n_node=torch.tensor([n_real], dtype=torch.int32),
        n_edge=torch.tensor([e_real], dtype=torch.int32),
        node_mask=torch.arange(N) < n_real, edge_mask=torch.arange(E) < e_real,
        graph_mask=torch.ones(1, dtype=torch.bool), ef=f(E, d), nf=f(N, d),
        gf=f(1, d))
    return x, x.with_features(ef=f(E, d), nf=f(N, d), gf=None)


def _kernel_route_batch(layout):
    if layout == "single":
        return _g1_batch()
    rng = np.random.default_rng(8)
    adjs = [(rng.random((15, 15)) < 0.4).astype(int) for _ in range(4)]
    E = sum(int(a.sum()) for a in adjs)
    data = {"graphs": adjs,
            "ef": [rng.normal(size=(int(a.sum()), 128)).astype(np.float32)
                   for a in adjs],
            "nf": [rng.normal(size=(15, 128)).astype(np.float32)
                   for _ in adjs],
            "gf": rng.normal(size=(4, 128)).astype(np.float32)}
    pad = (pt.PadSpec.uniform(16, 128) if layout == "uniform"
           else pt.PadSpec.bucketed(60, E, 4))
    x = pt.batch(data, pad=pad, device="cpu")
    bf = lambda t: t.to(torch.bfloat16)
    x = x.with_features(ef=bf(x.ef), nf=bf(x.nf), gf=bf(x.gf))
    y = x.with_features(ef=bf(torch.randn(x.ef.shape)),
                        nf=bf(torch.randn(x.nf.shape)), gf=None)
    return x, y


@pytest.mark.parametrize("layout", ["single", "uniform", "bucketed"])
def test_remat_on_the_kernel_routes(layout):
    """The kernel routes' autograd functions (their plain versions on the
    CPU) under remat: a backward may unpack its saved tensors only once
    under checkpointing.  One bf16 train step, loss and parameters
    bit-equal to the step without remat."""
    old = pt.use_kernels()
    pt.enable_kernels(True)
    try:
        x, y = _kernel_route_batch(layout)
        models = []
        for remat in (False, True):
            gen = torch.Generator().manual_seed(0)
            models.append(pt.GNCoreList(
                [pt.GNCore((128,) * 3, device="cpu", generator=gen)
                 for _ in range(2)], remat=remat))
        losses = []
        for m in models:
            step = pt.make_train_step(m, pt.adamw(m.parameters()),
                                      compute_dtype=torch.bfloat16)
            losses.append(step(x, y)["loss"])
    finally:
        pt.enable_kernels(old)
    assert torch.isfinite(losses[0]) and torch.equal(*losses)
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-30)


def test_corelist_remat_matches_jax_remat():
    data = _data(seed=23)
    pad = gn.PadSpec(16, 64, 4)
    xj = gn.batch(data, pad=pad)
    xp = pt.batch(data, pad=pt.PadSpec(16, 64, 4), device="cpu")
    w = _weights(xp)
    jmodel = gn.GNCoreList([gn.GNCore((8, 8, 8)) for _ in range(3)],
                           remat=True)
    params = jmodel.init(jax.random.PRNGKey(0))
    lj, gj = jax.value_and_grad(
        lambda p: _loss_jax(jmodel.apply(p, xj, training=True), w))(params)
    model = _corelist(8, 0.0, remat=True)
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), model)
    lp, gp, _ = _run(model, xp, w, 0)
    assert abs(float(lp) - float(lj)) <= 1e-5 * abs(float(lj))
    flat = pt.params._flatten_tree(jax.tree_util.tree_map(np.asarray, gj))
    for n, g in gp.items():
        _close(g.numpy(), flat[n], 1e-4)


def test_epd_remat_matches_jax_remat():
    cfg = pt.SortTaskConfig()
    x, y = pt.get_batch(np.random.default_rng(3), cfg, device="cpu")
    from graphnets_tpu.data.sort_task import get_batch as j_get_batch
    from graphnets_tpu.training.losses import graph_loss_nf_ef as j_loss
    xj, yj = j_get_batch(np.random.default_rng(3), cfg)
    jmodel = JEncodeProcessDecode((0, cfg.vocab_size, 0), (16,) * 3,
                                  (2, 2, 0), n_cores=2, remat=True)
    params = jmodel.init(jax.random.PRNGKey(1))
    lj, gj = jax.value_and_grad(
        lambda p: j_loss(jmodel.apply(p, xj, training=True), yj))(params)
    model = pt.EncodeProcessDecode((0, cfg.vocab_size, 0), (16,) * 3,
                                   (2, 2, 0), n_cores=2, remat=True,
                                   device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), model)
    loss = pt.graph_loss_nf_ef(model(x, training=True), y)
    loss.backward()
    assert abs(float(loss) - float(lj)) <= 1e-5 * abs(float(lj))
    flat = pt.params._flatten_tree(jax.tree_util.tree_map(np.asarray, gj))
    for n, p in model.named_parameters():
        if p.numel():
            g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
            _close(g, flat[n], 1e-4)
