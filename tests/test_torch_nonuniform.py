"""The port's non-uniform (bucket-padded) route against graphnets_tpu's.

Every batch that is not in the uniform slot layout takes the split-linear
edge update: with kernels on, the first sorted gathered term is completed by
``sorted_gather_add`` and the row inside ``ln_matmul``.  The same numpy
inputs go through the JAX functions (Pallas in interpret mode) and the
port's (on the CPU its wrappers run their plain versions).  Tolerances,
each with its reason:

* f32: 1e-5 of the reference's largest magnitude (the same f32 sums in
  another order); gradients that are sums over hundreds of rows 1e-4;
* ``ln_matmul`` in bf16: the completed row one bf16 ulp of the largest
  magnitude (2^-7), the f32 partial 1e-3 (a normalised value may round the
  other way); its VJP dx 2^-6 and dW, dscale, dbias 1e-3, as the LN
  backward's own test;
* ``sorted_gather_add``: one f32 add and one rounding of the same values:
  bit-equal; its table gradient one bf16 ulp (an f32 sum in another order);
* models in bf16: as ``tests/test_torch_train.py``: outputs and gradients
  within 5e-2 of the tensor's largest magnitude, or within the distance
  between the JAX package's own two bf16 routes where that is larger.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.ops import scatter as j_scatter
from graphnets_tpu.ops.pallas import edge_update as j_eu
from graphnets_tpu.ops.pallas import gather as j_ga
from graphnets_tpu.ops.pallas import ln_linear as j_ll
from graphnets_tpu.training import losses as jl
from graphnets_tpu.training.train import TrainState, make_train_step
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops import scatter as pt_scatter
from graphnets_tpu_torch.ops.kernels import edge_update as pt_eu
from graphnets_tpu_torch.ops.kernels import gather as pt_ga
from graphnets_tpu_torch.ops.kernels import ln_linear as pt_ll
from graphnets_tpu_torch.ops.kernels import segment_sum as pt_ss
from graphnets_tpu_torch.utils import config as pt_config

LR = 3e-4
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


# -- ln_matmul ----------------------------------------------------------


@pytest.mark.parametrize("addend", [None, "f32", "bf16"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_ln_matmul_matches_jax(kernels_on, dtype, addend):
    T, d, dout = 64, 128, 256
    tdt, jdt = _DT[dtype]
    rng = np.random.default_rng(20)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = f(T, d)
    x[:2] = 0.0                      # var == 0 rows
    x[2] = 3.0
    scale, bias, w = 1 + 0.1 * f(d), 0.1 * f(d), f(d, dout) * d ** -0.5
    add, ct = f(T, dout), f(T, dout)
    assert j_ll.supports_ln_matmul(T, d, dout)
    assert pt_ll.supports_ln_matmul(T, d, dout, tdt)
    adt = None if addend is None else _DT[addend]

    def jax_fn(x_, s_, b_, w_, a_):
        return j_ll.ln_matmul(x_, s_, b_, w_,
                              addend=None if adt is None else a_)
    jargs = (jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
             jnp.asarray(w), jnp.asarray(add, adt[1] if adt else jnp.float32))
    out_j, vjp = jax.vjp(jax_fn, *jargs)
    grads_j = vjp(jnp.asarray(ct, out_j.dtype))

    targs = [_t(x, tdt), _t(scale), _t(bias), _t(w),
             _t(add, adt[0] if adt else torch.float32)]
    for t in targs:
        t.requires_grad_()
    before = (pt_ll.FWD_LAUNCHES, pt_ll.LAUNCHES)
    out_p = pt_ll.ln_matmul(*targs[:4],
                            addend=None if adt is None else targs[4])
    out_p.backward(_t(ct, out_p.dtype))
    assert (pt_ll.FWD_LAUNCHES, pt_ll.LAUNCHES) == before  # CPU: no launch
    assert out_p.dtype == (torch.float32 if adt is None else tdt)
    assert str(out_j.dtype) == str(out_p.dtype).replace("torch.", "")
    if dtype == "f32":
        tols = dict(out=1e-5, x=1e-5, rest=1e-5)
    else:
        tols = dict(out=1e-3 if adt is None else 2.0 ** -7, x=2.0 ** -6,
                    rest=1e-3)
    _close(out_p, out_j, tols["out"], "out")
    _close(targs[0].grad, grads_j[0], tols["x"], "dx")
    for i, name in ((1, "dscale"), (2, "dbias"), (3, "dw")):
        _close(targs[i].grad, grads_j[i], tols["rest"], name)
    if adt is not None:
        assert targs[4].grad.dtype == adt[0]
        np.testing.assert_array_equal(_np(targs[4].grad), _np(grads_j[4]))


@pytest.mark.parametrize("shape", [
    (16384, 384, 384), (512, 384, 384), (16, 512, 512), (512, 512, 128),
    (64, 640, 640), (8, 1024, 1024), (64, 128, 256), (12, 128, 128),
    (16, 100, 128), (16, 128, 200), (4, 128, 128), (0, 128, 128)])
def test_supports_ln_matmul_matches_jax(shape):
    """The port's gate is the JAX package's on every shape, for bf16 and
    for f32 rows (the kernels' shared memory no longer refuses a width),
    and the backward kernel takes whatever the gate admits."""
    want = j_ll.supports_ln_matmul(*shape)
    for dtype in (torch.float32, torch.bfloat16):
        assert pt_ll.supports_ln_matmul(*shape, dtype) == want
        if want:
            assert pt_ll.supports_ln_linear_backward(*shape, dtype)
    assert not pt_ll.supports_ln_matmul(*shape, torch.float16)


@pytest.mark.parametrize("rows", [8, 512, 16384])
def test_supports_ln_matmul_grid_matches_jax(rows):
    """d and dout over 128 .. 1152 in steps of 128, and the widest d and
    dout the JAX gate admits: the two gates agree everywhere, and so does
    the backward's."""
    widths = list(range(128, 1153, 128))
    pairs = [(d, dout) for d in widths for dout in widths] + [
        (2816, 128), (2944, 128), (128, 5248), (128, 5376), (96, 128)]
    admitted = 0
    for d, dout in pairs:
        want = j_ll.supports_ln_matmul(rows, d, dout)
        for dtype in (torch.bfloat16, torch.float32):
            assert pt_ll.supports_ln_matmul(rows, d, dout, dtype) == want, \
                (rows, d, dout, dtype)
            assert pt_ll.supports_ln_linear_backward(rows, d, dout,
                                                     dtype) or not want
        admitted += want
    assert j_ll.supports_ln_matmul(rows, 1024, 1024)
    assert not j_ll.supports_ln_matmul(rows, 1152, 1024)
    assert 0 < admitted < len(pairs)


def test_ln_matmul_f32_at_d512_matches_jax(kernels_on):
    """d = 512 in f32: both packages take their kernel route (here the
    interpreter and the plain version behind the same autograd function)."""
    T, d, dout = 16, 512, 128
    rng = np.random.default_rng(24)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, scale, bias, w = f(T, d), 1 + 0.1 * f(d), 0.1 * f(d), \
        f(d, dout) * d ** -0.5
    add, ct = f(T, dout), f(T, dout)
    assert j_ll.supports_ln_matmul(T, d, dout)
    assert pt_ll.supports_ln_matmul(T, d, dout, torch.float32)
    out_j, vjp = jax.vjp(lambda *a: j_ll.ln_matmul(*a[:4], addend=a[4]),
                         *map(jnp.asarray, (x, scale, bias, w, add)))
    grads_j = vjp(jnp.asarray(ct))
    targs = [_t(a).requires_grad_() for a in (x, scale, bias, w, add)]
    calls = []
    real = pt_ll.ln_linear_backward
    try:
        pt_ll.ln_linear_backward = lambda *a: calls.append(1) or real(*a)
        out_p = pt_ll.ln_matmul(*targs[:4], addend=targs[4])
        out_p.backward(_t(ct))
    finally:
        pt_ll.ln_linear_backward = real
    assert calls == [1]  # the fused function's backward, not autograd's
    _close(out_p, out_j, 1e-5, "out")
    for t, gj, name in zip(targs, grads_j, ("dx", "dscale", "dbias", "dw",
                                            "daddend")):
        _close(t.grad, gj, 1e-5, name)


def test_ln_matmul_takes_the_reference_outside_its_gate():
    """A shape outside the gate takes the plain composition in both
    packages (here: rows not a multiple of 8, and f16 rows)."""
    rng = np.random.default_rng(21)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, scale, bias, w = f(12, 128), 1 + 0.1 * f(128), 0.1 * f(128), \
        f(128, 128) * 0.1
    assert not j_ll.supports_ln_matmul(12, 128, 128)
    assert not pt_ll.supports_ln_matmul(12, 128, 128, torch.float32)
    assert not pt_ll.supports_ln_matmul(16, 128, 128, torch.float16)
    assert not pt_ll.supports_ln_matmul(16, 1152, 1024, torch.bfloat16)
    assert not j_ll.supports_ln_matmul(16, 1152, 1024)
    ref = j_ll.ln_matmul(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), jnp.asarray(w))
    out = pt_ll.ln_matmul(_t(x), _t(scale), _t(bias), _t(w))
    _close(out, ref, 1e-5)


# -- sorted_gather_add --------------------------------------------------


@pytest.mark.parametrize("addend", ["f32", "bf16"])
@pytest.mark.parametrize("table", ["f32", "bf16"])
def test_sorted_gather_add_matches_jax(kernels_on, table, addend):
    d, E, N = 128, 256, 64
    (ttd, tjd), (atd, ajd) = _DT[table], _DT[addend]
    rng = np.random.default_rng(22)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    tab, add, ct = f(N, d), f(E, d), f(E, d)
    idx = np.sort(rng.integers(0, N, size=E)).astype(np.int32)
    assert j_ga.supports_sorted_gather(E, N, d)
    assert pt_ga.supports_sorted_gather(E, N, d)
    out_j, vjp = jax.vjp(
        lambda t, a: j_ga.sorted_gather_add(t, jnp.asarray(idx), a),
        jnp.asarray(tab, tjd), jnp.asarray(add, ajd))
    g_j = vjp(jnp.asarray(ct, out_j.dtype))
    tt = _t(tab, ttd).requires_grad_()
    ta = _t(add, atd).requires_grad_()
    before = pt_ga.ADD_LAUNCHES
    out_p = pt_ga.sorted_gather_add(tt, torch.from_numpy(idx), ta)
    out_p.backward(_t(ct, out_p.dtype))
    assert pt_ga.ADD_LAUNCHES == before
    assert out_p.dtype == torch.promote_types(ttd, atd)
    np.testing.assert_array_equal(_np(out_p), _np(out_j))
    assert tt.grad.dtype == ttd and ta.grad.dtype == atd
    _close(tt.grad, g_j[0], 2.0 ** -7 if table == "bf16" else 1e-5)
    np.testing.assert_array_equal(_np(ta.grad), _np(g_j[1]))


def test_sorted_gather_add_out_of_range_ids_read_zero_rows():
    """The Pallas contract: an id outside [0, N) adds nothing, and its
    cotangent row reaches no table row."""
    rng = np.random.default_rng(23)
    tab = _t(rng.normal(size=(32, 128))).requires_grad_()
    add = _t(rng.normal(size=(128, 128)))
    idx = np.sort(rng.integers(0, 32, size=128)).astype(np.int32)
    idx[-3:] = (32, 40, 41)
    out = pt_ga.sorted_gather_add(tab, torch.from_numpy(idx), add)
    np.testing.assert_array_equal(_np(out[-3:]), _np(add[-3:]))
    np.testing.assert_array_equal(
        _np(out[:-3]), _np(tab.detach()[idx[:-3].astype(np.int64)] + add[:-3]))
    out.sum().backward()
    counts = np.bincount(idx[:-3], minlength=32).astype(np.float32)
    np.testing.assert_allclose(_np(tab.grad), counts[:, None]
                               * np.ones((1, 128), np.float32))


@pytest.mark.parametrize("shape", [
    (16384, 1056, 384), (512, 41, 384), (16384, 1032, 384), (512, 64, 100),
    (100, 64, 128), (512, 7, 128), (256, 32, 128), (1056, 9, 384)])
def test_supports_sorted_gather_matches_jax(shape):
    assert pt_ga.supports_sorted_gather(*shape) == \
        j_ga.supports_sorted_gather(*shape) == \
        j_ga.supports_sorted_gather(*shape, 2)


@pytest.mark.parametrize("dim", [128, 1024, 1920, 2048, 2176, 3072, 4096])
def test_supports_sorted_gather_vmem_term_matches_jax(dim):
    """The JAX gate's VMEM term refuses wide rows (from about 2048 values a
    row with 512-row tiles): the port's gate carries the same term, for
    both element sizes, so the two routes agree there too."""
    seen = set()
    for num_out, num_rows in ((16384, 1056), (512, 64), (1048576, 65536),
                              (256, 32), (128, 4096)):
        for itemsize in (2, 4):
            want = j_ga.supports_sorted_gather(num_out, num_rows, dim,
                                               itemsize)
            assert pt_ga.supports_sorted_gather(num_out, num_rows, dim,
                                                itemsize) == want
            seen.add(want)
        assert pt_ga.supports_sorted_gather(num_out, num_rows, dim) == \
            j_ga.supports_sorted_gather(num_out, num_rows, dim)
        assert pt_ga._pick_tn(num_rows, num_out, 512) == \
            j_ga._pick_tn(num_rows, num_out, 512)
    if dim == 128:
        assert seen == {True}
    if dim >= 3072:
        assert False in seen    # the 512-row tiles no longer fit


# -- take_rows_sorted_grad ----------------------------------------------


def _bucketed_ids(rng, sizes, deg, n_pad, e_pad):
    """Canonical ids of a bucket-padded batch: ascending receivers,
    graph-local senders, one padding graph that owns the padding, padded
    edges pointing at the first padding node."""
    snd, rcv, ng, eg = [], [], [], []
    off = 0
    for b, n in enumerate(sizes):
        r = np.repeat(np.arange(n), deg) + off
        s = rng.integers(0, n, n * deg) + off
        snd.append(s), rcv.append(r)
        ng.append(np.full(n, b)), eg.append(np.full(n * deg, b))
        off += n
    e = sum(len(x) for x in snd)
    snd.append(np.full(e_pad - e, off)), rcv.append(np.full(e_pad - e, off))
    ng.append(np.full(n_pad - off, len(sizes)))
    eg.append(np.full(e_pad - e, len(sizes)))
    cat = lambda x: np.concatenate(x).astype(np.int32)
    return cat(snd), cat(rcv), cat(ng), cat(eg)


@pytest.mark.parametrize("route", ["sorted", "windowed", "unsorted"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_take_rows_sorted_grad_matches_jax(kernels_on, monkeypatch, route,
                                           dtype):
    """All three backward routes, on a bucketed batch's ids (the last
    window holds the padding): N = 128 > 64 segments, so the sorted and
    windowed kernels' plain versions are what runs."""
    tdt, jdt = _DT[dtype]
    rng = np.random.default_rng(24)
    N, E, d, G = 128, 1024, 128, 5
    snd, rcv, ng, eg = _bucketed_ids(rng, [31, 30, 29, 28], 8, N, E)
    gi = np.arange(G + 1, dtype=np.int32)
    win = (np.searchsorted(ng, gi).astype(np.int32),
           np.searchsorted(eg, gi).astype(np.int32))
    assert win[0][-1] == N and win[1][-1] == E and win[1][-2] < E
    idx = rcv if route == "sorted" else snd
    x = rng.normal(size=(N, d)).astype(np.float32)
    ct = rng.normal(size=(E, d)).astype(np.float32)
    kw_j = dict(idx_sorted=route == "sorted",
                windows=tuple(map(jnp.asarray, win))
                if route == "windowed" else None)
    out_j, vjp = jax.vjp(lambda t: j_scatter.take_rows_sorted_grad(
        t, jnp.asarray(idx), **kw_j), jnp.asarray(x, jdt))
    g_j = vjp(jnp.asarray(ct, jdt))[0]
    calls = {"sorted_segment_sum_plain": 0, "windowed_segment_sum_plain": 0,
             "sorted_gather_plain": 0}
    for mod, name in ((pt_ss, "sorted_segment_sum_plain"),
                      (pt_ss, "windowed_segment_sum_plain"),
                      (pt_ga, "sorted_gather_plain")):
        def spy(*a, _real=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    tx = _t(x, tdt).requires_grad_()
    out_p = pt_scatter.take_rows_sorted_grad(
        tx, torch.from_numpy(idx), idx_sorted=route == "sorted",
        windows=tuple(map(torch.from_numpy, win))
        if route == "windowed" else None)
    out_p.backward(_t(ct, tdt))
    assert calls == {
        "sorted_segment_sum_plain": int(route != "windowed"),
        "windowed_segment_sum_plain": int(route == "windowed"),
        "sorted_gather_plain": int(route == "sorted")}
    np.testing.assert_array_equal(_np(out_p), _np(out_j))
    assert tx.grad.dtype == tdt
    _close(tx.grad, g_j, 2.0 ** -7 if dtype == "bf16" else 1e-5)


def test_take_rows_sorted_grad_small_shapes_take_plain_ops(kernels_on):
    """Outside the kernels' gates (41 segments, 2 columns: the sort task's
    decoder) every route is plain torch and still the f32 sum."""
    rng = np.random.default_rng(25)
    snd, rcv, ng, eg = _bucketed_ids(rng, [10, 9, 8, 7], 4, 41, 256)
    gi = np.arange(6, dtype=np.int32)
    win = tuple(torch.from_numpy(np.searchsorted(a, gi).astype(np.int32))
                for a in (ng, eg))
    x = rng.normal(size=(41, 2)).astype(np.float32)
    ref = np.zeros((41, 2), np.float32)
    np.add.at(ref, snd, np.ones((256, 2), np.float32))
    for kw in (dict(windows=win), dict()):
        tx = _t(x).requires_grad_()
        pt_scatter.take_rows_sorted_grad(
            tx, torch.from_numpy(snd), **kw).sum().backward()
        np.testing.assert_allclose(_np(tx.grad), ref)


# -- GNBlock with the deferred receiver term ------------------------------


def _gather_block_data():
    """The batch of the JAX package's own test of this route: two full
    graphs padded to (32, 512, 3)."""
    rng = np.random.default_rng(7)
    d = 128
    adjs = [np.ones((16, 16), int), np.ones((12, 12), int)]
    ef = [rng.normal(size=(256, d)).astype(np.float32),
          rng.normal(size=(144, d)).astype(np.float32)]
    nf = [rng.normal(size=(16, d)).astype(np.float32),
          rng.normal(size=(12, d)).astype(np.float32)]
    return {"graphs": adjs, "ef": ef, "nf": nf, "gf": None}, d


def _masked_sq(y, lib):
    if lib is jnp:
        return (jnp.sum(jnp.where(y.edge_mask[:, None],
                                  y.ef.astype(jnp.float32), 0) ** 2)
                + jnp.sum(jnp.where(y.node_mask[:, None],
                                    y.nf.astype(jnp.float32), 0) ** 2))
    return ((y.ef.float() * y.edge_mask[:, None]) ** 2).sum() \
        + ((y.nf.float() * y.node_mask[:, None]) ** 2).sum()


def test_gnblock_fused_gather_term_matches_jax(kernels_on, monkeypatch):
    data, d = _gather_block_data()
    xj = gn.batch(data, pad=gn.PadSpec(32, 512, 3))
    xp = pt.batch(data, pad=pt.PadSpec(32, 512, 3), device="cpu")
    block_j = gn.GNBlock((d, d, 0), (d, d, 0))
    params = block_j.init(jax.random.PRNGKey(0))
    (loss_j, y_j), g_j = jax.value_and_grad(
        lambda p: (lambda y: (_masked_sq(y, jnp), y))(block_j.apply(p, xj)),
        has_aux=True)(params)
    calls = []
    real = pt_ga.sorted_gather_add_plain
    monkeypatch.setattr(pt_ga, "sorted_gather_add_plain",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    block_p = pt.GNBlock((d, d, 0), (d, d, 0), device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), block_p)
    y_p = block_p(xp)
    loss_p = _masked_sq(y_p, torch)
    loss_p.backward()
    # The receivers term of the edge update, and nothing else, is deferred.
    assert calls == [(32, d)]
    real_e, real_n = np.asarray(xj.edge_mask), np.asarray(xj.node_mask)
    _close(_np(y_p.ef)[real_e], _np(y_j.ef)[real_e], 1e-5, "ef")
    _close(_np(y_p.nf)[real_n], _np(y_j.nf)[real_n], 1e-5, "nf")
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j),
                               rtol=1e-5)
    named = dict(block_p.named_parameters())
    for n, gref in _flat(g_j).items():
        assert tuple(named[n].shape) == gref.shape, n
        if gref.size:  # the zero-width graph update has nothing to compare
            _close(named[n].grad, gref, 1e-4, n)


# -- bf16 gather partials -------------------------------------------------


@pytest.mark.parametrize("forced", [True, False])
def test_bf16_gather_partials_matches_jax(kernels_on, forced):
    """Forced on, both packages round the gathered partials to bf16 before
    the gather; the outputs then differ from the f32-partial route."""
    data, d = _gather_block_data()
    xj = gn.batch(data, pad=gn.PadSpec(32, 512, 3))
    xp = pt.batch(data, pad=pt.PadSpec(32, 512, 3), device="cpu")
    xj = xj.with_features(ef=xj.ef.astype(jnp.bfloat16),
                          nf=xj.nf.astype(jnp.bfloat16))
    xp = xp.with_features(ef=xp.ef.bfloat16(), nf=xp.nf.bfloat16())
    block_j = gn.GNBlock((d, d, 0), (d, d, 0))
    params = block_j.init(jax.random.PRNGKey(1))
    block_p = pt.GNBlock((d, d, 0), (d, d, 0), device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), block_p)
    cj, cp = get_config(), pt_config.get_config()
    old = (cj.bf16_gather_partials, cp.bf16_gather_partials)
    try:
        cj.bf16_gather_partials = cp.bf16_gather_partials = forced
        y_j = block_j.apply(params, xj)
        y_p = block_p(xp)
        cp.bf16_gather_partials = not forced
        y_other = block_p(xp)
    finally:
        cj.bf16_gather_partials, cp.bf16_gather_partials = old
    real = np.asarray(xj.edge_mask)
    # One bf16 ulp of the largest magnitude: the same roundings, f32 sums
    # in another order.
    _close(_np(y_p.ef)[real], _np(y_j.ef)[real], 2.0 ** -7)
    assert not torch.equal(y_p.ef, y_other.ef)


def test_bf16_gather_partials_auto_gate():
    cp = pt_config.get_config()
    assert cp.bf16_gather_partials is None
    assert cp.bf16_gather_rows == get_config().bf16_gather_rows == 1 << 17
    assert not pt_config.bf16_gather_partials((1 << 17) - 1)
    assert pt_config.bf16_gather_partials(1 << 17)
    assert cp.sorted_scatter_grad and get_config().sorted_scatter_grad


# -- the fused edge update's gate -----------------------------------------


@pytest.mark.parametrize("G,n_slots,e_slots", [
    (8, 128, 2048),     # the headline layout
    (2, 16, 128), (4, 32, 256), (5, 16, 128),
    (4, 11, 128),       # k = 4 gives a node window of 44: refused
    (3, 5, 128),        # no divisor of 3 aligns the node window: refused
    (2, 16, 100),       # edge tile never lane-aligned: refused
    (4, 4, 128),        # k = 2 aligns 8 nodes
    (2, 2048, 128),     # node window over 2048 once k = 2; k = 1 fits
    (2, 4096, 128),     # node window too large: refused
])
def test_fused_edge_update_gate_matches_jax(G, n_slots, e_slots):
    args = (G * e_slots, G * n_slots, G, 128, 128, n_slots, e_slots)
    assert pt_eu.supports_fused_edge_update(*args, torch.bfloat16) == \
        j_eu.supports_fused_edge_update(*args, jnp.bfloat16)
    assert pt_eu._pick_k(G, n_slots, e_slots) == \
        j_eu._pick_k(G, n_slots, e_slots)


def test_fused_edge_update_gate_refuses_what_jax_refuses():
    """A uniform layout the JAX kernel cannot tile takes the split-linear
    route in both packages."""
    args = (3 * 128, 3 * 5, 3, 128, 128, 5, 128)
    assert not j_eu.supports_fused_edge_update(*args, jnp.bfloat16)
    assert not pt_eu.supports_fused_edge_update(*args, torch.bfloat16)


# -- two cores end to end on a bucketed bf16 batch ----------------------------

G_REAL, DEG = 4, 8


def _bucketed_batches(seed, d, bf16=True):
    """4 graphs of 31..28 nodes, in-degree 8, padded with
    ``PadSpec.bucketed(..., node_multiple=32)`` to N = 128, E = 1024,
    G = 5; random normal node and edge targets."""
    rng = np.random.default_rng(seed)
    adjs, efs, nfs = [], [], []
    for b in range(G_REAL):
        n = 31 - b
        adj = np.zeros((n, n), np.int64)
        for r in range(n):
            adj[rng.choice(n, size=DEG, replace=False), r] = 1
        adjs.append(adj)
        efs.append(rng.normal(size=(n * DEG, d)).astype(np.float32))
        nfs.append(rng.normal(size=(n, d)).astype(np.float32))
    data = {"graphs": adjs, "ef": efs, "nf": nfs,
            "gf": rng.normal(size=(G_REAL, d)).astype(np.float32)}
    n_tot, e_tot = sum(a.shape[0] for a in adjs), sum(len(e) for e in efs)
    gj = gn.batch(data, pad=gn.PadSpec.bucketed(n_tot, e_tot, G_REAL,
                                                node_multiple=32))
    gp = pt.batch(data, pad=pt.PadSpec.bucketed(n_tot, e_tot, G_REAL,
                                                node_multiple=32),
                  device="cpu")
    assert (gp.num_node_slots, gp.num_edge_slots, gp.num_graph_slots) == \
        (128, 1024, 5) and gp.slot_shape is None
    yef = rng.normal(size=(1024, d)).astype(np.float32)
    ynf = rng.normal(size=(128, d)).astype(np.float32)
    tdt, jdt = _DT["bf16" if bf16 else "f32"]
    gj = gj.with_features(ef=gj.ef.astype(jdt), nf=gj.nf.astype(jdt),
                          gf=gj.gf.astype(jdt))
    gp = gp.with_features(ef=gp.ef.to(tdt), nf=gp.nf.to(tdt),
                          gf=gp.gf.to(tdt))
    yj = gj.with_features(ef=jnp.asarray(yef, jdt), nf=jnp.asarray(ynf, jdt),
                          gf=None)
    yp = gp.with_features(ef=_t(yef, tdt), nf=_t(ynf, tdt), gf=None)
    return gj, yj, gp, yp


class _CastModel:
    """A JAX model whose ``apply`` runs on parameters cast to ``dtype``."""

    def __init__(self, stack, dtype):
        self.stack, self.dtype = stack, dtype

    def apply(self, params, x, training=False, rng=None):
        cast = jax.tree_util.tree_map(lambda p: p.astype(self.dtype), params)
        return self.stack.apply(cast, x, training=training)


_PLAIN = [(pt_ll, "ln_matmul_reference"), (pt_ga, "sorted_gather_add_plain"),
          (pt_ll, "ln_linear_backward_plain"),
          (pt_ss, "sorted_segment_sum_plain"),
          (pt_ss, "windowed_segment_sum_plain"),
          (pt_ga, "sorted_gather_plain"),
          (pt_eu, "fused_edge_update_plain")]


def _spy(monkeypatch):
    calls = {name: 0 for _, name in _PLAIN}
    for mod, name in _PLAIN:
        def spy(*a, _real=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return calls


def test_bucketed_forward_matches_jax(kernels_on, monkeypatch):
    d = 128
    gj, _, gp, _ = _bucketed_batches(30, d)
    stack_j = gn.GNCoreList([gn.GNCore((d, d, d)) for _ in range(2)])
    params = stack_j.init(jax.random.PRNGKey(0))
    cast = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    y_j = stack_j.apply(cast, gj)
    enable_pallas(False)
    y_pure = stack_j.apply(cast, gj)
    enable_pallas(True, interpret=True)
    stack_p = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu")
                             for _ in range(2)])
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), stack_p)
    stack_p.to(torch.bfloat16)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        y_p = stack_p(gp)
    # Per core: one ln_matmul, one deferred receivers term, one sorted
    # edge->node sum; no fused edge update off the uniform layout.
    assert calls == {"ln_matmul_reference": 2, "sorted_gather_add_plain": 2,
                     "ln_linear_backward_plain": 0,
                     "sorted_segment_sum_plain": 2,
                     "windowed_segment_sum_plain": 0,
                     "sorted_gather_plain": 0, "fused_edge_update_plain": 0}
    masks = {"ef": gj.edge_mask, "nf": gj.node_mask, "gf": gj.graph_mask}
    for key, mask in masks.items():
        m = np.asarray(mask)
        ref = _np(getattr(y_j, key))[m]
        spread = np.abs(_np(getattr(y_pure, key))[m] - ref).max()
        err = np.abs(_np(getattr(y_p, key))[m] - ref).max()
        assert err <= max(5e-2 * np.abs(ref).max(), spread), (key, err)


def _assert_update_matches(name, old, new_p, new_j, gref, flip_below):
    """AdamW's first step moves a weight by about LR against the sign of
    its gradient, so the two packages' new parameters agree to f32
    rounding (1e-6) wherever the gradients' signs must agree: where
    ``|gref|`` exceeds ``flip_below``, the most the two gradients may
    differ by.  There the port's parameter must also have moved by at
    least LR / 2.  Entries below may flip sign and are held to 2 LR.
    Returns the number of entries held to 1e-6 and the total."""
    np.testing.assert_allclose(new_p, new_j, rtol=0, atol=2 * LR + 1e-6,
                               err_msg=name)
    firm = np.abs(gref) > flip_below
    assert np.abs(new_p - new_j)[firm].max(initial=0.0) <= 1e-6, name
    assert np.abs(new_p - old)[firm].min(initial=LR) >= 0.5 * LR, name
    return int(firm.sum()), firm.size


def test_bucketed_train_step_matches_jax(kernels_on, monkeypatch):
    d = 128
    gj, yj, gp, yp = _bucketed_batches(31, d)
    stack_j = gn.GNCoreList([gn.GNCore((d, d, d)) for _ in range(2)])
    params = stack_j.init(jax.random.PRNGKey(0))
    model = _CastModel(stack_j, jnp.bfloat16)
    loss_of = lambda p: jl.graph_loss_nf_ef(
        model.apply(p, gj, training=True), yj)
    loss_j, grads_j = jax.value_and_grad(loss_of)(params)
    opt = optax.adamw(LR)
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(1))
    state, _ = make_train_step(model, opt)(state, gj, yj)
    new_j = _flat(state.params)
    enable_pallas(False)
    _, pure = jax.value_and_grad(loss_of)(params)
    enable_pallas(True, interpret=True)
    grads_j, pure = _flat(grads_j), _flat(pure)

    stack_p = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu")
                             for _ in range(2)])
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), stack_p)
    step = pt.make_train_step(stack_p, pt.adamw(stack_p.parameters(), LR),
                              compute_dtype=torch.bfloat16)
    calls = _spy(monkeypatch)
    m = step(gp, yp)
    # Per core and step: ln_matmul and its backward, the deferred receivers
    # term and its sorted-sum backward, the edge->node sorted sum and its
    # gather backward, and the senders' windowed sum.
    assert calls == {"ln_matmul_reference": 2, "sorted_gather_add_plain": 2,
                     "ln_linear_backward_plain": 2,
                     "sorted_segment_sum_plain": 4,
                     "windowed_segment_sum_plain": 2,
                     "sorted_gather_plain": 2, "fused_edge_update_plain": 0}
    assert abs(float(m["loss"]) - float(loss_j)) <= 1e-2 * abs(float(loss_j))
    new_p, old = _flat(pt.to_numpy_tree(stack_p)), _flat(params)
    firm = total = 0
    for n, p in stack_p.named_parameters():
        gref = grads_j[n]
        assert p.grad.dtype == torch.float32
        err = np.abs(_np(p.grad) - gref).max()
        bound = max(5e-2 * np.abs(gref).max(), np.abs(pure[n] - gref).max())
        assert np.isfinite(_np(p.grad)).all() and err <= bound + 1e-12, \
            (n, err, bound)
        # A gradient within ``bound`` of gref keeps its sign above it.
        k, size = _assert_update_matches(n, old[n], new_p[n], new_j[n], gref,
                                         bound + 1e-7)
        firm, total = firm + k, total + size
    # 0.47 of the entries on these inputs: the last core's graph branch
    # has no gradient under the node/edge loss, and bf16 leaves the sign
    # of the smallest gradients open.
    assert firm >= 0.4 * total, (firm, total)


def test_bucketed_f32_forward_matches_jax(kernels_on):
    """The same route in f32 (the sort task's type): 1e-5 of the largest
    magnitude of each real feature set after two cores."""
    d = 128
    gj, _, gp, _ = _bucketed_batches(32, d, bf16=False)
    stack_j = gn.GNCoreList([gn.GNCore((d, d, d)) for _ in range(2)])
    params = stack_j.init(jax.random.PRNGKey(2))
    y_j = stack_j.apply(params, gj)
    stack_p = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu")
                             for _ in range(2)])
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), stack_p)
    with torch.no_grad():
        y_p = stack_p(gp)
    for key, mask in (("ef", gj.edge_mask), ("nf", gj.node_mask),
                      ("gf", gj.graph_mask)):
        m = np.asarray(mask)
        _close(_np(getattr(y_p, key))[m], _np(getattr(y_j, key))[m], 1e-5,
               key)
