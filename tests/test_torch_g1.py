"""The port's single-graph (G = 1) route against graphnets_tpu's.

A batch of one graph whose shape the gate admits takes the single-graph
edge update: ``LN(ef) @ W0 + src + tr[rl] + gb`` in one pass, with the
edge->node sum of the rounded result in the same pass.  The same numpy
inputs go through the JAX functions (Pallas in interpret mode) and the
port's (on the CPU its wrappers run their plain versions).  Tolerances,
each with its reason:

* f32: 1e-5 of the reference's largest magnitude (the same f32 sums in
  another order); gradients rtol 5e-4 / atol 5e-5, as the JAX package's
  own large-graph test holds its kernel route to its pure route;
* bf16 ``h``: one bf16 ulp of the largest magnitude (2^-7: a normalised
  value or the sum may round the other way); ``agg``: 1e-5 of the largest
  magnitude of the f32 sum of each package's own rounded ``h``, and one
  bf16 ulp x the largest in-degree between the packages;
* models in bf16: as ``tests/test_torch_train.py``: outputs and gradients
  within 5e-2 of the tensor's largest magnitude, or within the distance
  between the JAX package's own two bf16 routes where that is larger.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.ops.pallas import edge_update_g1 as j_g1
from graphnets_tpu.training import losses as jl
from graphnets_tpu.utils import config as j_config
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops.kernels import edge_update_g1 as pt_g1
from graphnets_tpu_torch.ops.kernels import gather as pt_ga
from graphnets_tpu_torch.ops.kernels import ln_linear as pt_ll
from graphnets_tpu_torch.ops.kernels import segment_sum as pt_ss
from graphnets_tpu_torch.utils import config as pt_config

_DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
       "f32": (torch.float32, jnp.float32)}


@pytest.fixture
def kernels_on():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(True, interpret=True)
    pt.enable_kernels(True)
    yield
    enable_pallas(old[0], interpret=old[1])
    pt_config.get_config().use_kernels = old_pt


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _close(out, ref, tol, what=""):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(out).all(), what
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30), \
        (what, np.abs(out - ref).max(), np.abs(ref).max())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


# -- the gate -----------------------------------------------------------

_GATE_SHAPES = [
    # (E, N): the large graph, the sampled subgraph, a mid size, small ones,
    # and shapes the gate refuses (N % 32, E % 128, N < 32, N % tn).
    (1048576, 65536), (56320, 56960), (262144, 16384), (512, 64), (1024, 96),
    (512, 40), (1000, 64), (512, 16), (4096, 4128), (131072, 32800)]
_GATE_WIDTHS = [(128, 128), (256, 256), (384, 128), (1024, 1024),
                (2048, 512), (100, 128), (128, 200)]


@pytest.mark.parametrize("E,N", _GATE_SHAPES)
def test_supports_g1_edge_update_matches_jax(E, N):
    """The port's gate is the JAX package's on a grid of shapes, widths,
    element sizes of the rows and of the partials, with and without the
    fused sum."""
    seen = set()
    for (de, dout), itemsize, part, with_agg in itertools.product(
            _GATE_WIDTHS, (2, 4), (None, 2, 4), (False, True)):
        want = j_g1.supports_g1_edge_update(E, N, de, dout, itemsize,
                                            with_agg=with_agg,
                                            part_itemsize=part)
        got = pt_g1.supports_g1_edge_update(E, N, de, dout, itemsize,
                                            with_agg=with_agg,
                                            part_itemsize=part)
        assert got == want, (E, N, de, dout, itemsize, part, with_agg)
        seen.add(want)
    assert pt_g1._tiles(E, N) == j_g1._tiles(E, N)
    if (E, N) in ((1048576, 65536), (56320, 56960), (512, 64)):
        assert seen == {True, False}    # the widths decide too
    if N % 32 or E % 128:
        assert seen == {False}


def test_supports_g1_mixed_itemsize():
    """The JAX package's own mixed-size shapes: the large graph at D = 512
    fits with bf16 partials and not with f32 partials."""
    E, N, D = 1 << 20, 65536, 512
    for fn in (j_g1.supports_g1_edge_update, pt_g1.supports_g1_edge_update):
        assert fn(E, N, D, D, 2, part_itemsize=2)
        assert not fn(E, N, D, D, 2, part_itemsize=4)
        assert fn(E, N, D, D, 2) == fn(E, N, D, D, 2, part_itemsize=2)


# -- the kernels' functions ---------------------------------------------


def _receivers(rng, E, N, kind):
    """Ascending receivers.  ``pads``: two fifths of the slots are real
    edges over the first N - 1 nodes, one of them a hub with more edges
    than a 64-row tile, many nodes have none, and the rest are pad edges on
    the last node."""
    if kind == "uniform":
        return np.sort(rng.integers(0, N, size=E)).astype(np.int32)
    real = E * 2 // 5
    r = rng.integers(0, N - 1, size=real)
    r[:E // 5] = 5
    r[r % 3 == 1] = 9            # empty nodes
    return np.sort(np.concatenate(
        [r, np.full(E - real, N - 1)])).astype(np.int32)


def _g1_inputs(seed, E, N, de, dout, kind):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    ef = f(E, de)
    ef[:2] = 0.0                 # var == 0 rows
    return dict(ef=ef, scale=1 + 0.1 * f(de), bias=0.1 * f(de),
                w0=f(de, dout) * de ** -0.5, src=f(E, dout), tr=f(N, dout),
                rl=_receivers(rng, E, N, kind), gb=f(dout))


def _jax_args(a, jdt, jpdt, has_ln):
    ln = {"scale": jnp.asarray(a["scale"]), "bias": jnp.asarray(a["bias"])} \
        if has_ln else None
    return (jnp.asarray(a["ef"], jdt), ln, jnp.asarray(a["w0"], jdt),
            jnp.asarray(a["src"], jpdt), jnp.asarray(a["tr"], jpdt),
            jnp.asarray(a["rl"]), jnp.asarray(a["gb"]))


def _torch_args(a, tdt, tpdt, has_ln, grad=False):
    g = (lambda t: t.requires_grad_()) if grad else (lambda t: t)
    ln = {"scale": g(_t(a["scale"])), "bias": g(_t(a["bias"]))} \
        if has_ln else None
    return (g(_t(a["ef"], tdt)), ln, g(_t(a["w0"], tdt)),
            g(_t(a["src"], tpdt)), g(_t(a["tr"], tpdt)),
            torch.from_numpy(a["rl"]), g(_t(a["gb"])))


@pytest.mark.parametrize("kind", ["uniform", "pads"])
@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("dtype,parts", [("f32", "f32"), ("bf16", "bf16"),
                                         ("bf16", "f32")])
def test_fused_g1_edge_update_matches_jax(kernels_on, dtype, parts, has_ln,
                                          kind):
    E, N, de, dout = 512, 64, 128, 256
    (tdt, jdt), (tpdt, jpdt) = _DT[dtype], _DT[parts]
    a = _g1_inputs(40, E, N, de, dout, kind)
    assert j_g1.supports_g1_edge_update(E, N, de, dout, jnp.dtype(jdt).itemsize,
                                        with_agg=True,
                                        part_itemsize=jnp.dtype(jpdt).itemsize)
    jargs = _jax_args(a, jdt, jpdt, has_ln)
    h_j = j_g1.fused_g1_edge_update(*jargs)
    h2_j, agg_j = j_g1.fused_g1_edge_update_agg(*jargs)
    targs = _torch_args(a, tdt, tpdt, has_ln)
    before = (pt_g1.LAUNCHES, pt_g1.LAUNCHES_NO_AGG)
    h_p = pt_g1.fused_g1_edge_update(*targs)
    h2_p, agg_p = pt_g1.fused_g1_edge_update_agg(*targs)
    assert (pt_g1.LAUNCHES, pt_g1.LAUNCHES_NO_AGG) == before   # CPU
    assert h_p.dtype == tdt and agg_p.dtype == torch.float32
    assert agg_p.shape == (N, dout) == tuple(agg_j.shape)
    tol = 1e-5 if dtype == "f32" else 2.0 ** -7
    _close(h_p, h_j, tol, "h")
    assert torch.equal(h_p, h2_p)
    np.testing.assert_array_equal(_np(h_j), _np(h2_j))
    # agg is the f32 sum of the package's own rounded h ...
    own = np.zeros((N, dout), np.float32)
    np.add.at(own, a["rl"], _np(h2_p))
    _close(agg_p, own, 1e-5, "agg vs own h")
    # ... nodes with no edge read 0, and the packages agree.
    empty = np.bincount(a["rl"], minlength=N) == 0
    assert empty.any() == (kind == "pads") and not _np(agg_p)[empty].any()
    deg = np.bincount(a["rl"], minlength=N).max()
    _close(agg_p, agg_j, 1e-5 if dtype == "f32" else 2.0 ** -7 * deg, "agg")


@pytest.mark.parametrize("with_agg", [False, True])
@pytest.mark.parametrize("has_ln", [True, False])
def test_fused_g1_edge_update_grads_match_jax(kernels_on, has_ln, with_agg):
    """Gradients of all eight inputs in f32 against the JAX package's
    ``_op`` / ``_op2`` (whose backward composes its own kernels)."""
    E, N, de, dout = 512, 64, 128, 128
    a = _g1_inputs(41, E, N, de, dout, "pads")
    rng = np.random.default_rng(42)
    ct_h = rng.normal(size=(E, dout)).astype(np.float32)
    ct_a = rng.normal(size=(N, dout)).astype(np.float32)
    names = ("ef", "scale", "bias", "w0", "src", "tr", "gb")

    def loss_j(ef, scale, bias, w0, src, tr, gb):
        ln = {"scale": scale, "bias": bias} if has_ln else None
        rl = jnp.asarray(a["rl"])
        if with_agg:
            h, agg = j_g1.fused_g1_edge_update_agg(ef, ln, w0, src, tr, rl,
                                                   gb)
            return jnp.sum(h * ct_h) + jnp.sum(agg * ct_a)
        return jnp.sum(j_g1.fused_g1_edge_update(ef, ln, w0, src, tr, rl,
                                                 gb) * ct_h)

    grads_j = jax.grad(loss_j, argnums=tuple(range(7)))(
        *[jnp.asarray(a[n]) for n in names])
    ef, ln, w0, src, tr, rl, gb = _torch_args(a, torch.float32,
                                              torch.float32, has_ln, True)
    if with_agg:
        h, agg = pt_g1.fused_g1_edge_update_agg(ef, ln, w0, src, tr, rl, gb)
        loss = (h * _t(ct_h)).sum() + (agg * _t(ct_a)).sum()
    else:
        loss = (pt_g1.fused_g1_edge_update(ef, ln, w0, src, tr, rl, gb)
                * _t(ct_h)).sum()
    loss.backward()
    got = {"ef": ef, "w0": w0, "src": src, "tr": tr, "gb": gb}
    if has_ln:
        got.update(scale=ln["scale"], bias=ln["bias"])
    for n, gj in zip(names, grads_j):
        if n not in got:
            assert not np.asarray(gj).any()   # no LN: zero gradients
            continue
        ref = np.asarray(gj)
        np.testing.assert_allclose(_np(got[n].grad), ref, rtol=5e-4,
                                   atol=5e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=n)


def test_fused_g1_edge_update_bf16_agg_backward_rounds_once(kernels_on):
    """bf16: the agg cotangent is rounded to bf16, gathered and added to the
    cotangent of h in f32 with one rounding; d src is that sum."""
    E, N, d = 512, 64, 128
    a = _g1_inputs(43, E, N, d, d, "uniform")
    rng = np.random.default_rng(44)
    ct_h = rng.normal(size=(E, d)).astype(np.float32)
    ct_a = rng.normal(size=(N, d)).astype(np.float32)
    bf = torch.bfloat16
    ef, ln, w0, src, tr, rl, gb = _torch_args(a, bf, bf, True, True)
    h, agg = pt_g1.fused_g1_edge_update_agg(ef, ln, w0, src, tr, rl, gb)
    torch.autograd.backward([h, agg], [_t(ct_h, bf), _t(ct_a)])
    want = (_t(ct_h, bf).float()
            + _t(ct_a).to(bf)[torch.from_numpy(a["rl"]).long()].float()
            ).to(bf)
    assert torch.equal(src.grad, want)
    jargs = _jax_args(a, jnp.bfloat16, jnp.bfloat16, True)
    _, vjp = jax.vjp(lambda s: j_g1.fused_g1_edge_update_agg(
        jargs[0], jargs[1], jargs[2], s, *jargs[4:]), jargs[3])
    (d_src_j,) = vjp((jnp.asarray(ct_h, jnp.bfloat16), jnp.asarray(ct_a)))
    np.testing.assert_array_equal(_np(src.grad), _np(d_src_j))


def test_fused_g1_edge_update_takes_the_reference_outside_its_gate():
    """E not a multiple of 128: both packages compose the reference, and
    the gradients still flow through the composed backward."""
    E, N, d = 200, 64, 128
    a = _g1_inputs(45, E, N, d, d, "uniform")
    assert not j_g1.supports_g1_edge_update(E, N, d, d, 4)
    assert not pt_g1.supports_g1_edge_update(E, N, d, d, 4)
    h_j, agg_j = j_g1.fused_g1_edge_update_agg(
        *_jax_args(a, jnp.float32, jnp.float32, True))
    targs = _torch_args(a, torch.float32, torch.float32, True, True)
    h_p, agg_p = pt_g1.fused_g1_edge_update_agg(*targs)
    _close(h_p, h_j, 1e-5)
    _close(agg_p, agg_j, 1e-5)
    (h_p.sum() + agg_p.sum()).backward()
    assert np.isfinite(_np(targs[0].grad)).all()


# -- GNBlock and GNCoreList on a single graph ---------------------------


def _g1_batches(seed, N, E, d, dtype="bf16", pad_edges=0):
    """One graph of N node slots and E edge slots (the last ``pad_edges``
    of them padding on the last node, which is then a pad node), random
    senders, ascending receivers, features of width d on all three sets,
    and random node and edge targets."""
    rng = np.random.default_rng(seed)
    n_real, e_real = (N - 1, E - pad_edges) if pad_edges else (N, E)
    senders = np.concatenate(
        [rng.integers(0, n_real, size=e_real),
         np.full(pad_edges, N - 1)]).astype(np.int32)
    receivers = np.concatenate(
        [np.sort(rng.integers(0, n_real, size=e_real)),
         np.full(pad_edges, N - 1)]).astype(np.int32)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    ef, nf, gf, yef, ynf = f(E, d), f(N, d), f(1, d), f(E, d), f(N, d)
    node_mask, edge_mask = np.arange(N) < n_real, np.arange(E) < e_real
    tdt, jdt = _DT[dtype]
    gj = gn.GraphsTuple(
        senders=jnp.asarray(senders), receivers=jnp.asarray(receivers),
        node_graph=jnp.zeros((N,), jnp.int32),
        edge_graph=jnp.zeros((E,), jnp.int32),
        n_node=jnp.asarray([n_real], jnp.int32),
        n_edge=jnp.asarray([e_real], jnp.int32),
        node_mask=jnp.asarray(node_mask), edge_mask=jnp.asarray(edge_mask),
        graph_mask=jnp.ones((1,), bool), ef=jnp.asarray(ef, jdt),
        nf=jnp.asarray(nf, jdt), gf=jnp.asarray(gf, jdt))
    gp = pt.GraphsTuple(
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        node_graph=torch.zeros(N, dtype=torch.int32),
        edge_graph=torch.zeros(E, dtype=torch.int32),
        n_node=torch.tensor([n_real], dtype=torch.int32),
        n_edge=torch.tensor([e_real], dtype=torch.int32),
        node_mask=torch.from_numpy(node_mask),
        edge_mask=torch.from_numpy(edge_mask),
        graph_mask=torch.ones(1, dtype=torch.bool), ef=_t(ef, tdt),
        nf=_t(nf, tdt), gf=_t(gf, tdt))
    yj = gj.with_features(ef=jnp.asarray(yef, jdt), nf=jnp.asarray(ynf, jdt),
                          gf=None)
    yp = gp.with_features(ef=_t(yef, tdt), nf=_t(ynf, tdt), gf=None)
    return gj, yj, gp, yp


_PLAIN = [(pt_g1, "g1_edge_update_agg_plain"), (pt_g1, "g1_edge_update_plain"),
          (pt_ll, "ln_matmul_reference"),
          (pt_ll, "ln_linear_backward_plain"),
          (pt_ss, "sorted_segment_sum_plain"),
          (pt_ga, "sorted_gather_plain"), (pt_ga, "sorted_gather_add_plain")]


def _spy(monkeypatch):
    calls = {name: 0 for _, name in _PLAIN}
    for mod, name in _PLAIN:
        def spy(*a, _real=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    # The plain sum calls the plain update: count the latter's own calls.
    calls["h_alone"] = lambda: (calls["g1_edge_update_plain"]
                                - calls["g1_edge_update_agg_plain"])
    # edge_update_g1 binds these two names at import.
    monkeypatch.setattr(pt_g1, "ln_matmul_reference",
                        pt_ll.ln_matmul_reference)
    monkeypatch.setattr(pt_g1, "ln_linear_backward",
                        pt_ll.ln_linear_backward)
    return calls


def _jax_g1_spy(monkeypatch):
    """Counts the JAX package's single-graph kernel launches by variant."""
    calls = {"agg": 0, "h": 0}
    real = j_g1._forward

    def spy(*a, with_agg=False, **k):
        calls["agg" if with_agg else "h"] += 1
        return real(*a, with_agg=with_agg, **k)
    monkeypatch.setattr(j_g1, "_forward", spy)
    return calls


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("training", [False, True])
def test_gnblock_g1_matches_jax(kernels_on, monkeypatch, dtype, training):
    """A bare GNBlock (no LN) on a padded single graph: both packages take
    the single-graph kernel with its fused sum, in inference and (by
    default) under training."""
    N, E, d = 64, 512, 128
    gj, _, gp, _ = _g1_batches(50, N, E, d, dtype, pad_edges=100)
    tdt, jdt = _DT[dtype]
    block_j = gn.GNBlock((d, d, d), (d, d, d))
    params = block_j.init(jax.random.PRNGKey(0))
    cast = jax.tree_util.tree_map(lambda p: p.astype(jdt), params)
    jcalls = _jax_g1_spy(monkeypatch)
    y_j = block_j.apply(cast, gj, training=training)
    block_p = pt.GNBlock((d, d, d), (d, d, d), device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), block_p)
    block_p.to(tdt)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        y_p = block_p(gp, training=training)
    assert jcalls == {"agg": 1, "h": 0}
    assert calls["g1_edge_update_agg_plain"] == 1
    assert calls["h_alone"]() == 0
    assert calls["ln_matmul_reference"] == 0        # no LN handed in
    tol = 1e-5 if dtype == "f32" else 3e-2
    for key, mask in (("ef", gj.edge_mask), ("nf", gj.node_mask),
                      ("gf", gj.graph_mask)):
        m = np.asarray(mask)
        _close(_np(getattr(y_p, key))[m], _np(getattr(y_j, key))[m], tol,
               key)


def test_gnblock_g1_agg_fusion_training_gate_matches_jax(kernels_on,
                                                         monkeypatch):
    """With ``g1_agg_fusion_training`` off both packages take the kernel
    without the sum under training, and aggregate after it."""
    N, E, d = 128, 512, 128
    gj, _, gp, _ = _g1_batches(51, N, E, d, "f32")
    block_j = gn.GNBlock((d, d, d), (d, d, d))
    params = block_j.init(jax.random.PRNGKey(1))
    monkeypatch.setattr(j_config.get_config(), "g1_agg_fusion_training",
                        False)
    monkeypatch.setattr(pt_config.get_config(), "g1_agg_fusion_training",
                        False)
    assert not pt_config.g1_agg_fusion_training()
    jcalls = _jax_g1_spy(monkeypatch)
    y_j = block_j.apply(params, gj, training=True)
    block_p = pt.GNBlock((d, d, d), (d, d, d), device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), block_p)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        y_p = block_p(gp, training=True)
        assert calls["h_alone"]() == 1
        assert calls["g1_edge_update_agg_plain"] == 0
        assert calls["sorted_segment_sum_plain"] == 1
        block_p(gp, training=False)          # inference keeps the sum
        assert calls["g1_edge_update_agg_plain"] == 1
        assert calls["h_alone"]() == 1
    assert jcalls == {"agg": 0, "h": 1}
    for key in ("ef", "nf", "gf"):
        _close(getattr(y_p, key), getattr(y_j, key), 1e-5, key)


def test_g1_agg_fusion_training_env_name():
    """The override follows the port's pattern: GRAPHNETS_TPU_TORCH_* for
    the JAX package's GRAPHNETS_TPU_*, on by default in both."""
    import inspect
    assert "GRAPHNETS_TPU_TORCH_G1_AGG_TRAIN" in inspect.getsource(pt_config)
    assert "GRAPHNETS_TPU_G1_AGG_TRAIN" in inspect.getsource(j_config)
    assert pt_config.Config().g1_agg_fusion_training is True
    assert j_config.Config().g1_agg_fusion_training is True


@pytest.mark.parametrize("N,E", [(40, 512), (64, 200), (16, 512)])
def test_g1_batch_outside_the_gate_takes_the_split_path(kernels_on,
                                                        monkeypatch, N, E):
    """N % 32 != 0, E % 128 != 0 or N < 32: neither package launches the
    single-graph kernel; both take the split-linear path."""
    d = 128
    gj, _, gp, _ = _g1_batches(52, N, E, d, "f32")
    core_j = gn.GNCore((d, d, d))
    params = core_j.init(jax.random.PRNGKey(2))
    jcalls = _jax_g1_spy(monkeypatch)
    y_j = core_j.apply(params, gj)
    core_p = pt.GNCore((d, d, d), device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), core_p)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        y_p = core_p(gp)
    assert jcalls == {"agg": 0, "h": 0}
    assert calls["g1_edge_update_agg_plain"] == 0
    assert calls["g1_edge_update_plain"] == 0
    assert calls["ln_matmul_reference"] == (1 if E % 8 == 0 else 0)
    for key in ("ef", "nf", "gf"):
        _close(getattr(y_p, key), getattr(y_j, key), 1e-4, key)


@pytest.mark.parametrize("route", ["kernels", "pure"])
def test_g1_stack_forward_matches_jax(monkeypatch, route):
    """A 2-core GNCoreList on a single graph in f32, on both routes."""
    N, E, d = 64, 512, 128
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(route == "kernels", interpret=route == "kernels")
    pt.enable_kernels(route == "kernels")
    try:
        gj, _, gp, _ = _g1_batches(53, N, E, d, "f32", pad_edges=64)
        stack_j = gn.GNCoreList([gn.GNCore((d, d, d)) for _ in range(2)])
        params = stack_j.init(jax.random.PRNGKey(3))
        jcalls = _jax_g1_spy(monkeypatch)
        y_j = stack_j.apply(params, gj)
        stack_p = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu")
                                 for _ in range(2)])
        pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           stack_p)
        calls = _spy(monkeypatch)
        with torch.no_grad():
            y_p = stack_p(gp)
    finally:
        enable_pallas(old[0], interpret=old[1])
        pt_config.get_config().use_kernels = old_pt
    n = 2 if route == "kernels" else 0
    assert jcalls == {"agg": n, "h": 0}
    assert calls["g1_edge_update_agg_plain"] == n
    for key, mask in (("ef", gj.edge_mask), ("nf", gj.node_mask),
                      ("gf", gj.graph_mask)):
        m = np.asarray(mask)
        _close(_np(getattr(y_p, key))[m], _np(getattr(y_j, key))[m], 1e-4,
               key)


class _CastModel:
    """A JAX model whose ``apply`` runs on parameters cast to ``dtype``."""

    def __init__(self, stack, dtype):
        self.stack, self.dtype = stack, dtype

    def apply(self, params, x, training=False, rng=None):
        cast = jax.tree_util.tree_map(lambda p: p.astype(self.dtype), params)
        return self.stack.apply(cast, x, training=training)


@pytest.mark.parametrize("route", ["kernels", "pure"])
def test_g1_stack_train_step_matches_jax(monkeypatch, route):
    """One train step of a 2-core stack on a single graph (f32 masters,
    bf16 compute, ``graph_loss_nf_ef``): loss and every gradient against
    the JAX package's on the same route, under the rule of
    ``tests/test_torch_train.py``."""
    N, E, d = 128, 512, 128
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    try:
        gj, yj, gp, yp = _g1_batches(54, N, E, d, "bf16", pad_edges=64)
        stack_j = gn.GNCoreList([gn.GNCore((d, d, d)) for _ in range(2)])
        params = stack_j.init(jax.random.PRNGKey(4))
        model = _CastModel(stack_j, jnp.bfloat16)
        loss_of = lambda p: jl.graph_loss_nf_ef(
            model.apply(p, gj, training=True), yj)
        enable_pallas(True, interpret=True)
        jcalls = _jax_g1_spy(monkeypatch)
        loss_k, grads_k = jax.value_and_grad(loss_of)(params)
        assert jcalls == {"agg": 2, "h": 0}
        enable_pallas(False)
        loss_u, grads_u = jax.value_and_grad(loss_of)(params)
        grads_k, grads_u = _flat(grads_k), _flat(grads_u)
        loss_j, grads_j = (loss_k, grads_k) if route == "kernels" \
            else (loss_u, grads_u)
        pt.enable_kernels(route == "kernels")
        stack_p = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu")
                                 for _ in range(2)])
        pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           stack_p)
        step = pt.make_train_step(stack_p,
                                  pt.adamw(stack_p.parameters(), 3e-4),
                                  compute_dtype=torch.bfloat16)
        calls = _spy(monkeypatch)
        m = step(gp, yp)
    finally:
        enable_pallas(old[0], interpret=old[1])
        pt_config.get_config().use_kernels = old_pt
    if route == "kernels":
        # Per core: the kernel with its sum; in its backward the LN
        # backward, the gather of the agg cotangent, and two sorted sums
        # (d tr, and the senders' sort-once scatter).
        assert calls.pop("h_alone")() == 0
        assert calls == {"g1_edge_update_agg_plain": 2,
                         "g1_edge_update_plain": 2, "ln_matmul_reference": 2,
                         "ln_linear_backward_plain": 2,
                         "sorted_segment_sum_plain": 4,
                         "sorted_gather_plain": 2,
                         "sorted_gather_add_plain": 0}
    else:
        calls.pop("h_alone")
        assert not any(calls.values())
    assert abs(float(m["loss"]) - float(loss_j)) <= 1e-2 * abs(float(loss_j))
    for n, p in stack_p.named_parameters():
        gref = grads_j[n]
        err = np.abs(_np(p.grad) - gref).max()
        bound = max(5e-2 * np.abs(gref).max(),
                    np.abs(grads_k[n] - grads_u[n]).max())
        assert np.isfinite(_np(p.grad)).all() and err <= bound + 1e-12, \
            (n, err, bound)


# ---- h written over a dead sender term (the JAX kernel's donation) --------

@pytest.mark.parametrize("with_agg", [False, True])
@pytest.mark.parametrize("parts", ["bf16", "f32"])
def test_fused_g1_edge_update_src_is_dead_aliases(kernels_on, parts,
                                                  with_agg):
    """A public call writes a fresh ``h`` and leaves ``src`` as it was;
    with ``src_is_dead`` and ``src`` of ``ef``'s type, ``h`` is ``src``
    itself (same storage, same values); with f32 partials it is not."""
    E, N, d = 512, 64, 128
    a = _g1_inputs(60, E, N, d, d, "pads")
    fn = (pt_g1.fused_g1_edge_update_agg if with_agg
          else pt_g1.fused_g1_edge_update)
    first = lambda out: out[0] if with_agg else out
    args = _torch_args(a, torch.bfloat16, _DT[parts][0], True)
    src = args[3]
    kept = src.clone()
    public = fn(*args)
    assert torch.equal(src, kept)
    assert first(public).data_ptr() != src.data_ptr()
    dead = src.clone()
    out = fn(*args[:3], dead, *args[4:], src_is_dead=True)
    aliased = first(out).data_ptr() == dead.data_ptr()
    assert aliased == (parts == "bf16")
    if not aliased:
        assert torch.equal(dead, kept)
    assert torch.equal(first(out), first(public))
    if with_agg:
        assert torch.equal(out[1], public[1])


def _alias_spy(monkeypatch):
    """Records, per call of the single-graph kernel functions, whether
    ``h`` came back in ``src``'s storage and whether the caller said its
    ``src`` was dead."""
    seen = []
    for name in ("fused_g1_edge_update", "fused_g1_edge_update_agg"):
        def spy(*a, _real=getattr(pt_g1, name), **k):
            ptr = a[3].data_ptr()
            out = _real(*a, **k)
            h = out[0] if isinstance(out, tuple) else out
            seen.append((h.data_ptr() == ptr, k.get("src_is_dead", False)))
            return out
        monkeypatch.setattr(pt_g1, name, spy)
    return seen


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("parts", ["bf16", "f32"])
def test_gnblock_g1_writes_h_over_dead_src(kernels_on, monkeypatch, parts,
                                           training):
    """``GNBlock`` hands its gathered sender term over as dead: with bf16
    partials (the gather gate pinned on in both packages) ``h`` lands in
    its storage, with f32 partials it does not; the output matches the
    JAX ``GNBlock`` as ``test_gnblock_g1_matches_jax`` holds it."""
    N, E, d = 64, 512, 128
    on = parts == "bf16"
    monkeypatch.setattr(j_config.get_config(), "bf16_gather_partials", on)
    monkeypatch.setattr(pt_config.get_config(), "bf16_gather_partials", on)
    gj, _, gp, _ = _g1_batches(53, N, E, d, "bf16", pad_edges=100)
    block_j = gn.GNBlock((d, d, d), (d, d, d))
    params = block_j.init(jax.random.PRNGKey(4))
    cast = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    y_j = block_j.apply(cast, gj, training=training)
    block_p = pt.GNBlock((d, d, d), (d, d, d), device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), block_p)
    block_p.to(torch.bfloat16)
    seen = _alias_spy(monkeypatch)
    with torch.no_grad():
        y_p = block_p(gp, training=training)
    assert seen == [(on, True)]
    for key, mask in (("ef", gj.edge_mask), ("nf", gj.node_mask),
                      ("gf", gj.graph_mask)):
        m = np.asarray(mask)
        _close(_np(getattr(y_p, key))[m], _np(getattr(y_j, key))[m], 3e-2,
               key)


@pytest.mark.parametrize("agg_training", [True, False])
def test_g1_alias_leaves_gradients_unchanged(kernels_on, monkeypatch,
                                             agg_training):
    """A training step's gradients through the aliased sender term are
    bit-equal to those of the same step with a fresh ``h`` buffer."""
    N, E, d = 64, 512, 128
    monkeypatch.setattr(pt_config.get_config(), "bf16_gather_partials", True)
    monkeypatch.setattr(pt_config.get_config(), "g1_agg_fusion_training",
                        agg_training)
    _, _, gp, _ = _g1_batches(54, N, E, d, "bf16", pad_edges=60)
    block = pt.GNBlock((d, d, d), (d, d, d), device="cpu",
                       generator=torch.Generator().manual_seed(5))
    block.to(torch.bfloat16)

    def grads(alias):
        if not alias:
            for name in ("fused_g1_edge_update", "fused_g1_edge_update_agg"):
                real = getattr(pt_g1, name)
                monkeypatch.setattr(
                    pt_g1, name,
                    lambda *a, _real=real, src_is_dead=False, **k:
                        _real(*a, **k))
        block.zero_grad()
        y = block(gp, training=True)
        loss = sum(getattr(y, k).float().square().mean()
                   for k in ("ef", "nf", "gf"))
        loss.backward()
        return {n: p.grad.clone() for n, p in block.named_parameters()}

    with_alias = grads(True)
    without = grads(False)
    assert with_alias.keys() == without.keys()
    for name in with_alias:
        assert torch.equal(with_alias[name], without[name]), name
