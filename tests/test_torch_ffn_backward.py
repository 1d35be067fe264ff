"""The port's fused LN->FFN->residual backward against graphnets_tpu's.

``ln_ffn_residual`` is differentiable in both packages; its backward keeps
only ``x`` from the forward and recomputes the LN statistics and the hidden
activation.  The same numpy inputs go through the JAX package's
``_fused_backward`` (Pallas in interpret mode), through ``jax.vjp`` of its
composed reference, and through the port's plain backward (what its CUDA
kernel is held against on the card).  Tolerances, each with its reason:

* f32: 1e-5 of the reference's largest magnitude (the same f32 sums in
  another order) against the kernel's own arithmetic, 1e-4 against the
  composed reference (which keeps its hidden activation instead of
  recomputing it);
* bf16: dx within 2^-6 of its largest magnitude, the parameter gradients
  within 1e-2 (sums of products of bf16-rounded values in another order,
  and a relu mask that may flip where the f32 pre-activation is within
  rounding of 0);
* models in bf16: as ``tests/test_torch_train.py``: gradients within 5e-2
  of the tensor's largest magnitude, or within the distance between the
  JAX package's own two bf16 routes where that is larger.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.ops.pallas import fused_ffn as j_ffn
from graphnets_tpu.training import losses as jl
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops.kernels import fused_ffn as pt_ffn
from graphnets_tpu_torch.utils import config as pt_config

_DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
       "f32": (torch.float32, jnp.float32)}
_NAMES = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")


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


def _inputs(seed, T, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = f(T, d)
    x[:2] = 0.0                      # var == 0 rows
    return dict(x=x, scale=1 + 0.1 * f(d), bias=0.1 * f(d),
                w1=f(d, 4 * d) * d ** -0.5, b1=0.1 * f(4 * d),
                w2=f(4 * d, d) * (4 * d) ** -0.5, b2=0.1 * f(d),
                extra=f(T, d), g=f(T, d))


_ARGS = ("x", "scale", "bias", "w1", "b1", "w2")


@pytest.mark.parametrize("T", [8, 64, 200])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_ffn_backward_plain_matches_jax_kernel(kernels_on, dtype, T):
    """The plain backward against the JAX package's Pallas backward."""
    d = 128
    tdt, jdt = _DT[dtype]
    a = _inputs(60 + T, T, d)
    cast = lambda n, lib: (jnp.asarray(a[n], jdt) if lib == "j"
                           else _t(a[n], tdt))
    # Row vectors stay f32 in the module path's masters; the weights are
    # cast to the compute type, as the train step casts them.
    jargs = [cast(n, "j") for n in _ARGS] + [cast("g", "j")]
    assert j_ffn.supports_fused_ffn(T, d)
    out_j = j_ffn._fused_backward(*jargs)
    out_p = pt_ffn.ln_ffn_backward_plain(
        *[cast(n, "p") for n in _ARGS], cast("g", "p"))
    assert out_p[0].dtype == tdt
    assert all(o.dtype == torch.float32 for o in out_p[1:])
    tols = dict(zip(_NAMES, (1e-5,) * 7 if dtype == "f32"
                    else (2.0 ** -6,) + (1e-2,) * 6))
    for n, o, r in zip(_NAMES, out_p, out_j):
        _close(o, r, tols[n], n)


@pytest.mark.parametrize("with_extra", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_ffn_residual_grads_match_jax(kernels_on, dtype, with_extra):
    """``ln_ffn_residual`` through autograd against ``jax.vjp`` of the JAX
    function (its Pallas backward) and of its composed reference: all
    eight gradients, with the contract of ``extra`` (not saved; its
    gradient is the cotangent in its own type)."""
    T, d = 64, 128
    tdt, jdt = _DT[dtype]
    a = _inputs(61, T, d)
    names = _ARGS + ("b2",) + (("extra",) if with_extra else ())
    jargs = [jnp.asarray(a[n], jdt) for n in names]

    def fused(*args):
        return j_ffn.ln_ffn_residual(*args[:7], extra=args[7]
                                     if with_extra else None)

    def reference(*args):
        return j_ffn.ln_ffn_residual_reference(
            *args[:7], extra=args[7] if with_extra else None)

    y_j, vjp = jax.vjp(fused, *jargs)
    grads_j = vjp(jnp.asarray(a["g"], jdt))
    _, vjp_ref = jax.vjp(reference, *jargs)
    grads_ref = vjp_ref(jnp.asarray(a["g"], jdt))

    targs = [_t(a[n], tdt).requires_grad_() for n in names]
    calls = []
    real = pt_ffn.ln_ffn_backward_plain
    try:
        pt_ffn.ln_ffn_backward_plain = \
            lambda *args: calls.append(1) or real(*args)
        before = (pt_ffn.LAUNCHES, pt_ffn.BWD_LAUNCHES)
        y_p = pt_ffn.ln_ffn_residual(*targs[:7], extra=targs[7]
                                     if with_extra else None)
        y_p.backward(_t(a["g"], tdt))
    finally:
        pt_ffn.ln_ffn_backward_plain = real
    assert calls == [1]                  # the function's own backward
    assert (pt_ffn.LAUNCHES, pt_ffn.BWD_LAUNCHES) == before     # CPU
    _close(y_p, y_j, 1e-5 if dtype == "f32" else 2.0 ** -6, "y")
    for n, t, gj, gr in zip(names, targs, grads_j, grads_ref):
        assert t.grad.dtype == tdt
        if n == "extra":
            np.testing.assert_array_equal(_np(t.grad), _np(gj))
            continue
        tol = 1e-5 if dtype == "f32" else (2.0 ** -6 if n == "x" else 1e-2)
        _close(t.grad, gj, tol, n)
        if dtype == "f32":
            # (In bf16 the composed reference rounds every op of its
            # backward to bf16 and is no yardstick for an f32 sum.)
            _close(t.grad, gr, 1e-4, n + " vs reference")


def test_ln_ffn_backward_var0_rows():
    """A constant row has var == 0: z = 0, sigma taken as 1, and its dx is
    (dz - mean dz) / eps plus the passthrough, in both packages."""
    T, d = 8, 128
    a = _inputs(62, T, d)
    a["x"][:] = np.arange(T, dtype=np.float32)[:, None]   # every row constant
    jargs = [jnp.asarray(a[n]) for n in _ARGS] + [jnp.asarray(a["g"])]
    old = (get_config().use_pallas, get_config().pallas_interpret)
    enable_pallas(True, interpret=True)
    try:
        out_j = j_ffn._fused_backward(*jargs)
    finally:
        enable_pallas(old[0], interpret=old[1])
    out_p = pt_ffn.ln_ffn_backward_plain(*[_t(a[n]) for n in _ARGS],
                                         _t(a["g"]))
    assert np.abs(_np(out_p[0])).max() > 1e3     # the 1 / eps rows
    assert not _np(out_p[1]).any()               # dscale = sum dxn * 0
    for n, o, r in zip(_NAMES, out_p, out_j):
        _close(o, r, 1e-5, n)


def test_ln_ffn_backward_refuses_other_widths_on_the_card():
    """The backward kernel takes what the JAX gate takes (d = 128 to 512,
    whole 8-row tiles) on bf16 and f32 rows; the wrapper refuses the rest
    before any launch, so it shows on the CPU too when called directly."""
    z = torch.zeros
    for T, d, dt in ((8, 640, torch.bfloat16), (8, 200, torch.bfloat16),
                     (8, 128, torch.float16), (12, 128, torch.bfloat16)):
        x = z(T, d, dtype=dt)
        with pytest.raises(ValueError, match="unsupported"):
            pt_ffn._launch_backward(x, z(d), z(d), z(d, 4 * d), z(4 * d),
                                    z(4 * d, d), x)
        assert not pt_ffn.supports_fused_ffn(T, d, dt)
        assert not j_ffn.supports_fused_ffn(T, d) or dt == torch.float16


@pytest.mark.parametrize("d", [384, 512])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_ffn_backward_plain_wide_matches_jax_kernel(kernels_on, dtype, d):
    """The plain backward (the CUDA kernel's yardstick) against the JAX
    package's Pallas backward at the widths the JAX gate adds beyond the
    trained ones, with the module docstring's tolerances."""
    T = 16
    tdt, jdt = _DT[dtype]
    a = _inputs(70 + d, T, d)
    assert j_ffn.supports_fused_ffn(T, d) and \
        pt_ffn.supports_fused_ffn(T, d, tdt)
    out_j = j_ffn._fused_backward(
        *[jnp.asarray(a[n], jdt) for n in _ARGS], jnp.asarray(a["g"], jdt))
    out_p = pt_ffn.ln_ffn_backward_plain(*[_t(a[n], tdt) for n in _ARGS],
                                         _t(a["g"], tdt))
    tols = dict(zip(_NAMES, (1e-5,) * 7 if dtype == "f32"
                    else (2.0 ** -6,) + (1e-2,) * 6))
    for n, o, r in zip(_NAMES, out_p, out_j):
        _close(o, r, tols[n], n)


def _batch_pair(seed, d, dtype):
    """Two graphs of 16 nodes, in-degree 8, batched uniformly in both
    packages: 256 edge rows, 32 node rows, 2 graph rows."""
    rng = np.random.default_rng(seed)
    adjs, efs, nfs = [], [], []
    for _ in range(2):
        adj = np.zeros((16, 16), np.int64)
        for r in range(16):
            adj[rng.choice(16, size=8, replace=False), r] = 1
        adjs.append(adj)
        efs.append(rng.normal(size=(128, d)).astype(np.float32))
        nfs.append(rng.normal(size=(16, d)).astype(np.float32))
    data = {"graphs": adjs, "ef": efs, "nf": nfs,
            "gf": rng.normal(size=(2, d)).astype(np.float32)}
    tdt, jdt = _DT[dtype]
    pad = gn.PadSpec.uniform(16, 128)
    gj = gn.batch(data, pad=pad)
    gj = gj.with_features(ef=gj.ef.astype(jdt), nf=gj.nf.astype(jdt),
                          gf=gj.gf.astype(jdt))
    gp = pt.batch(data, pad=pad, device="cpu")
    gp = gp.with_features(ef=gp.ef.to(tdt), nf=gp.nf.to(tdt),
                          gf=gp.gf.to(tdt))
    return gj, gp


@pytest.mark.parametrize("dtype,d", [("bf16", 512), ("f32", 128),
                                     ("f32", 512)])
def test_gncore_forward_fuses_where_jax_does(kernels_on, monkeypatch, dtype,
                                             d):
    """With the kernels forced on, a GNCore forward on f32 rows or at
    d = 512 takes the fused FFN for the edge and node sets in both packages
    (the 2-row graph set composes in both), and the outputs agree: f32 at
    1e-4, bf16 at 5e-2 of each set's largest magnitude."""
    tdt, jdt = _DT[dtype]
    gj, gp = _batch_pair(80 + d, d, dtype)
    core_j = gn.GNCore((d, d, d))
    params = jax.tree_util.tree_map(
        lambda w: np.asarray(w.astype(jdt)), core_j.init(
            jax.random.PRNGKey(6)))
    core_p = pt.GNCore((d, d, d), device="cpu", dtype=tdt)
    pt.from_jax_params(params, core_p)
    calls = {"jax": 0, "port": 0}

    def count(key, real):
        def spy(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return spy
    monkeypatch.setattr(j_ffn, "_fused_forward",
                        count("jax", j_ffn._fused_forward))
    monkeypatch.setattr(pt_ffn, "ln_ffn_residual_plain",
                        count("port", pt_ffn.ln_ffn_residual_plain))
    yj = core_j.apply(jax.tree_util.tree_map(jnp.asarray, params), gj)
    with torch.no_grad():
        yp = core_p(gp)
    assert calls == {"jax": 2, "port": 2}
    for key in ("ef", "nf", "gf"):
        a = np.asarray(getattr(yj, key), np.float32)
        b = _np(getattr(yp, key))
        assert np.isfinite(b).all()
        tol = 1e-4 if dtype == "f32" else 5e-2
        assert np.abs(b - a).max() <= tol * max(np.abs(a).max(), 1.0), key


# -- the GNCore's training gates ----------------------------------------


def _g1_batches(seed, N, E, d):
    """One graph in bf16 in both packages, with node and edge targets."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=E).astype(np.int32)
    receivers = np.sort(rng.integers(0, N, size=E)).astype(np.int32)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    ef, nf, gf, yef, ynf = f(E, d), f(N, d), f(1, d), f(E, d), f(N, d)
    bj, bt = jnp.bfloat16, torch.bfloat16
    gj = gn.GraphsTuple(
        senders=jnp.asarray(senders), receivers=jnp.asarray(receivers),
        node_graph=jnp.zeros((N,), jnp.int32),
        edge_graph=jnp.zeros((E,), jnp.int32),
        n_node=jnp.asarray([N], jnp.int32), n_edge=jnp.asarray([E], jnp.int32),
        node_mask=jnp.ones((N,), bool), edge_mask=jnp.ones((E,), bool),
        graph_mask=jnp.ones((1,), bool), ef=jnp.asarray(ef, bj),
        nf=jnp.asarray(nf, bj), gf=jnp.asarray(gf, bj))
    gp = pt.GraphsTuple(
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        node_graph=torch.zeros(N, dtype=torch.int32),
        edge_graph=torch.zeros(E, dtype=torch.int32),
        n_node=torch.tensor([N], dtype=torch.int32),
        n_edge=torch.tensor([E], dtype=torch.int32),
        node_mask=torch.ones(N, dtype=torch.bool),
        edge_mask=torch.ones(E, dtype=torch.bool),
        graph_mask=torch.ones(1, dtype=torch.bool), ef=_t(ef, bt),
        nf=_t(nf, bt), gf=_t(gf, bt))
    yj = gj.with_features(ef=jnp.asarray(yef, bj), nf=jnp.asarray(ynf, bj),
                          gf=None)
    yp = gp.with_features(ef=_t(yef, bt), nf=_t(ynf, bt), gf=None)
    return gj, yj, gp, yp


def _ffn_spies(monkeypatch):
    """Counts the port's fused forward, fused backward and composed
    reference calls, and the JAX package's fused backward launches."""
    calls = {"fwd": 0, "bwd": 0, "reference": 0, "jax_bwd": 0}
    from graphnets_tpu_torch.models import gn_core as pt_core

    def count(key, real):
        def spy(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return spy
    monkeypatch.setattr(pt_ffn, "ln_ffn_residual_plain",
                        count("fwd", pt_ffn.ln_ffn_residual_plain))
    monkeypatch.setattr(pt_ffn, "ln_ffn_backward_plain",
                        count("bwd", pt_ffn.ln_ffn_backward_plain))
    monkeypatch.setattr(pt_core, "ln_ffn_residual_reference",
                        count("reference", pt_core.ln_ffn_residual_reference))
    monkeypatch.setattr(j_ffn, "_fused_backward",
                        count("jax_bwd", j_ffn._fused_backward))
    return calls


@pytest.mark.parametrize("min_rows,want", [
    # (the row bound patched onto both classes, the port's calls per core:
    #  fused forward, fused backward, composed reference)
    (512, (1, 1, 2)),      # the 512-row edge set alone trains fused
    (128, (2, 2, 1)),      # edge and node sets; the 1-row graph set composes
    (1024, (0, 0, 3)),     # below the bound every set composes
])
def test_gncore_training_ffn_gate_per_feature_set(kernels_on, monkeypatch,
                                                  min_rows, want):
    """Under training each feature set takes the fused FFN and its
    recomputing backward from ``_FUSED_FFN_TRAIN_MIN_ROWS`` rows up and the
    composed reference below, in both packages; the gradients agree."""
    N, E, d = 128, 512, 128
    gj, yj, gp, yp = _g1_batches(63, N, E, d)
    monkeypatch.setattr(gn.GNCore, "_FUSED_FFN_TRAIN_MIN_ROWS", min_rows)
    monkeypatch.setattr(pt.GNCore, "_FUSED_FFN_TRAIN_MIN_ROWS", min_rows)
    core_j = gn.GNCore((d, d, d))
    params = core_j.init(jax.random.PRNGKey(5))
    cast = lambda p: jax.tree_util.tree_map(
        lambda w: w.astype(jnp.bfloat16), p)
    loss_of = lambda p: jl.graph_loss_nf_ef(
        core_j.apply(cast(p), gj, training=True), yj)
    calls = _ffn_spies(monkeypatch)
    grads_k = _flat(jax.grad(loss_of)(params))
    assert calls["jax_bwd"] == want[1]
    enable_pallas(False)
    grads_u = _flat(jax.grad(loss_of)(params))
    enable_pallas(True, interpret=True)

    core_p = pt.GNCore((d, d, d), device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), core_p)
    step = pt.make_train_step(core_p, pt.adamw(core_p.parameters(), 3e-4),
                              compute_dtype=torch.bfloat16)
    for k in calls:
        calls[k] = 0
    m = step(gp, yp)
    assert np.isfinite(float(m["loss"]))
    assert (calls["fwd"], calls["bwd"], calls["reference"]) == want
    for n, p in core_p.named_parameters():
        gref = grads_k[n]
        err = np.abs(_np(p.grad) - gref).max()
        bound = max(5e-2 * np.abs(gref).max(),
                    np.abs(grads_u[n] - gref).max())
        assert np.isfinite(_np(p.grad)).all() and err <= bound + 1e-12, \
            (n, err, bound)


def test_gncore_training_above_max_dim_composes(kernels_on, monkeypatch):
    """Above ``_FUSED_FFN_TRAIN_MAX_DIM`` the second branch is composed
    from plain modules under training, whatever the row counts, and fused
    in inference."""
    N, E, d = 128, 512, 128
    _, _, gp, _ = _g1_batches(64, N, E, d)
    monkeypatch.setattr(pt.GNCore, "_FUSED_FFN_TRAIN_MIN_ROWS", 8)
    monkeypatch.setattr(pt.GNCore, "_FUSED_FFN_TRAIN_MAX_DIM", 64)
    calls = _ffn_spies(monkeypatch)
    core = pt.GNCore((d, d, d), device="cpu", dtype=torch.bfloat16)
    out = core(gp, training=True)
    assert (calls["fwd"], calls["reference"]) == (0, 0)
    assert np.isfinite(_np(out.ef)).all()
    with torch.no_grad():
        core(gp, training=False)
    assert (calls["fwd"], calls["reference"]) == (2, 1)


def test_gncore_training_with_dropout_composes(kernels_on, monkeypatch):
    """Dropout is not fused: with it the training step composes the second
    branch (``gn_core.py:188``)."""
    N, E, d = 128, 512, 128
    _, _, gp, _ = _g1_batches(65, N, E, d)
    monkeypatch.setattr(pt.GNCore, "_FUSED_FFN_TRAIN_MIN_ROWS", 8)
    calls = _ffn_spies(monkeypatch)
    core = pt.GNCore((d, d, d), dropout=0.1, device="cpu",
                     dtype=torch.bfloat16)
    core(gp, training=True, generator=torch.Generator().manual_seed(0))
    assert (calls["fwd"], calls["reference"]) == (0, 0)
