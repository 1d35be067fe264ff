"""The port's training-path kernel modules against the JAX package's Pallas
kernels: the sorted and windowed segment sums, the sorted gather, the
LN->matmul backward and the gradients of the non-agg fused edge update.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in Pallas interpret mode.  The same numpy inputs (a uniform layout of
4 graphs x 32 node slots x 256 edge slots: E = 1024 rows into N = 128 > 64
segments, d = 128) go to both.  Tolerances, each with its reason:

* segment sums: f32 sums of the same rows in another order, rounded once
  to bf16, may round the other way: one bf16 ulp of the largest magnitude
  (2^-7 x max |ref|); in f32, rtol 1e-5;
* sorted gather: a copy, bit-equal;
* LN backward: dx is bf16 after an f32 pullback (2^-6 x max |ref|); dW,
  dscale and dbias are f32 sums over 1024 rows in another order
  (1e-3 x max |ref|);
* fused edge update gradients: bf16 cotangents through bf16 products
  (5e-2 x max |ref| per tensor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops import scatter as pt_scatter
from graphnets_tpu_torch.ops.kernels import edge_update as pt_eu
from graphnets_tpu_torch.ops.kernels import gather as pt_ga
from graphnets_tpu_torch.ops.kernels import ln_linear as pt_ll
from graphnets_tpu_torch.ops.kernels import segment_sum as pt_ss
from graphnets_tpu_torch.utils import config as pt_config

G, N_SLOTS, E_SLOTS, D = 4, 32, 256, 128
N, E = G * N_SLOTS, G * E_SLOTS
_DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
       "f32": (torch.float32, jnp.float32)}


@pytest.fixture
def interpret_mode():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    enable_pallas(True, interpret=True)
    yield
    enable_pallas(old[0], interpret=old[1])


def _ids(seed, padded):
    """Uniform-layout senders (unsorted, graph-local) and receivers
    (ascending); with ``padded`` each slot's tail edges target its last
    node, a padding node."""
    rng = np.random.default_rng(seed)
    snd, rcv = [], []
    for b in range(G):
        n_real = N_SLOTS - 1 if padded else N_SLOTS
        e_real = E_SLOTS - 37 if padded else E_SLOTS
        s = rng.integers(0, n_real, E_SLOTS) + b * N_SLOTS
        r = np.sort(rng.integers(0, n_real, E_SLOTS)) + b * N_SLOTS
        s[e_real:] = r[e_real:] = (b + 1) * N_SLOTS - 1
        snd.append(s)
        rcv.append(r)
    return (np.concatenate(snd).astype(np.int32),
            np.concatenate(rcv).astype(np.int32))


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _assert_sum_close(out, ref, dtype):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    if dtype == "bf16":
        assert np.abs(out - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_sorted_segment_sum_matches_pallas(interpret_mode, dtype, padded):
    from graphnets_tpu.ops.pallas.segment_sum import sorted_segment_sum
    tdt, jdt = _DT[dtype]
    _, rcv = _ids(1, padded)
    x = np.random.default_rng(2).normal(size=(E, D)).astype(np.float32)
    ref = sorted_segment_sum(jnp.asarray(x, jdt), jnp.asarray(rcv), N)
    before = pt_ss.LAUNCHES
    out = pt_ss.sorted_segment_sum(_t(x, tdt), torch.from_numpy(rcv), N)
    assert pt_ss.LAUNCHES == before  # CPU tensors never launch
    assert out.dtype == tdt
    _assert_sum_close(out, ref, dtype)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_windowed_segment_sum_matches_pallas(interpret_mode, dtype, padded):
    """The senders' sum; a 128-segment tile of the TPU kernel spans four
    32-node graphs here."""
    from graphnets_tpu.ops.pallas.segment_sum import windowed_segment_sum
    tdt, jdt = _DT[dtype]
    snd, _ = _ids(3, padded)
    x = np.random.default_rng(4).normal(size=(E, D)).astype(np.float32)
    gi = np.arange(G + 1, dtype=np.int32)
    ref = windowed_segment_sum(jnp.asarray(x, jdt), jnp.asarray(snd), N,
                               jnp.asarray(gi * N_SLOTS),
                               jnp.asarray(gi * E_SLOTS))
    out = pt_ss.windowed_segment_sum(
        _t(x, tdt), torch.from_numpy(snd), N, torch.from_numpy(gi * N_SLOTS),
        torch.from_numpy(gi * E_SLOTS))
    assert out.dtype == tdt
    _assert_sum_close(out, ref, dtype)


@pytest.mark.parametrize("layout", [
    # (nodes, edges) a graph.  The sort task's padded batch: its pad graph
    # sends all 297 pad edges from one node (a segment the CUDA kernel
    # shares among its warps).  Empty graphs between full ones.
    ([9, 7, 7, 6, 12], [81, 49, 49, 36, 297]),
    ([5, 0, 20, 0, 3, 12], [40, 0, 0, 0, 30, 186]),
])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_windowed_segment_sum_pad_node_and_empty_graphs(interpret_mode,
                                                        dtype, layout):
    """The senders' sum on windows that are not uniform: overlapping tiles,
    a pad node that collects every pad edge, graphs with no nodes."""
    from graphnets_tpu.ops.pallas.segment_sum import windowed_segment_sum
    tdt, jdt = _DT[dtype]
    nodes, edges = layout
    rng = np.random.default_rng(5)
    no = np.concatenate([[0], np.cumsum(nodes)]).astype(np.int32)
    eo = np.concatenate([[0], np.cumsum(edges)]).astype(np.int32)
    snd = np.concatenate([rng.integers(no[i], max(no[i + 1], no[i] + 1),
                                       size=edges[i])
                          for i in range(len(nodes))]).astype(np.int32)
    snd[eo[-2]:] = no[-2]
    n = int(no[-1])
    x = rng.normal(size=(int(eo[-1]), D)).astype(np.float32)
    ref = windowed_segment_sum(jnp.asarray(x, jdt), jnp.asarray(snd), n,
                               jnp.asarray(no), jnp.asarray(eo))
    out = pt_ss.windowed_segment_sum(
        _t(x, tdt), torch.from_numpy(snd), n, torch.from_numpy(no),
        torch.from_numpy(eo))
    assert out.dtype == tdt
    _assert_sum_close(out, ref, dtype)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_sorted_gather_matches_pallas_bit_equal(interpret_mode, dtype,
                                                padded):
    from graphnets_tpu.ops.pallas.gather import sorted_gather
    tdt, jdt = _DT[dtype]
    _, rcv = _ids(5, padded)
    table = np.random.default_rng(6).normal(size=(N, D)).astype(np.float32)
    ref = sorted_gather(jnp.asarray(table, jdt), jnp.asarray(rcv))
    before = pt_ga.LAUNCHES
    out = pt_ga.sorted_gather(_t(table, tdt), torch.from_numpy(rcv))
    assert pt_ga.LAUNCHES == before
    assert out.dtype == tdt
    np.testing.assert_array_equal(_np(out), _np(ref))


def test_sorted_gather_reads_zeros_out_of_range():
    """Ids outside [0, N) read zero rows (the kernel contract,
    gather.py:325-329), where ``index_select`` would raise.  (The Pallas
    kernel itself may also double-count in-range rows of such a tile, so
    it is not the reference here.)"""
    table = torch.randn(N, D)
    idx = torch.tensor([-1, 0, 5, N - 1, N, N + 7], dtype=torch.int32)
    out = pt_ga.sorted_gather(table, idx)
    assert not out[0].any() and not out[4:].any()
    assert torch.equal(out[1:4], table[[0, 5, N - 1]])


def test_sorted_segment_sum_and_gather_are_each_others_backward():
    _, rcv = _ids(7, True)
    ids = torch.from_numpy(rcv)
    x = torch.randn(E, D, dtype=torch.float64, generator=torch.Generator()
                    .manual_seed(0)).float().requires_grad_()
    g = torch.randn(N, D)
    pt_ss.sorted_segment_sum(x, ids, N).backward(g)
    np.testing.assert_array_equal(x.grad.numpy(), g[rcv].numpy())
    table = torch.randn(N, D).requires_grad_()
    ge = torch.randn(E, D)
    pt_ga.sorted_gather(table, ids).backward(ge)
    ref = torch.zeros(N, D).index_add_(0, ids.long(), ge)
    np.testing.assert_allclose(table.grad.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("zero_row", [False, True])
def test_ln_linear_backward_matches_pallas(interpret_mode, zero_row):
    """dx, dW, dscale, dbias of bf16(LN(x)) @ W; with ``zero_row`` some
    rows are constant (var == 0, the Flux guard)."""
    from graphnets_tpu.ops.pallas.ln_linear import _backward
    rng = np.random.default_rng(8)
    T, dout = 1024, 256
    x = rng.normal(size=(T, D)).astype(np.float32)
    if zero_row:
        x[:5] = 0.0
        x[7] = 1.5
    scale = (1 + 0.1 * rng.normal(size=D)).astype(np.float32)
    bias = (0.1 * rng.normal(size=D)).astype(np.float32)
    w = (rng.normal(size=(D, dout)) * D ** -0.5).astype(np.float32)
    g = rng.normal(size=(T, dout)).astype(np.float32)
    bf = jnp.bfloat16
    ref = _backward(jnp.asarray(x, bf), jnp.asarray(scale),
                    jnp.asarray(bias), jnp.asarray(w, bf), jnp.asarray(g, bf))
    before = pt_ll.LAUNCHES
    out = pt_ll.ln_linear_backward(
        _t(x, torch.bfloat16), _t(scale), _t(bias), _t(w, torch.bfloat16),
        _t(g, torch.bfloat16))
    assert pt_ll.LAUNCHES == before
    assert out[0].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in out[1:])
    for name, o, r, tol in zip(("dx", "dscale", "dbias", "dw"), out, ref,
                               (2.0 ** -6, 1e-3, 1e-3, 1e-3)):
        o, r = _np(o), _np(r)
        assert o.shape == r.shape, name
        assert np.isfinite(o).all(), name
        assert np.abs(o - r).max() <= tol * np.abs(r).max(), name


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("padded", [False, True])
def test_fused_edge_update_gradients_match_jax_vjp(interpret_mode, padded,
                                                   use_ln):
    from graphnets_tpu.ops.pallas.edge_update import fused_edge_update
    snd, rcv = _ids(9, padded)
    rng = np.random.default_rng(10)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a = dict(ef=f(E, D), scale=1 + 0.1 * f(D), bias=0.1 * f(D),
             w0=f(D, D) * D ** -0.5, ts=f(N, D), tr=f(N, D), tg=f(G, D),
             b=f(D))
    ct = f(E, D)
    bf = jnp.bfloat16
    names = ("ef", "scale", "bias", "w0", "ts", "tr", "tg", "b")
    jdt = {"ef": bf, "w0": bf}
    prim = [jnp.asarray(a[k], jdt.get(k, jnp.float32)) for k in names]

    def jfn(ef, scale, bias, w0, ts, tr, tg, b):
        ln = {"scale": scale, "bias": bias} if use_ln else None
        return fused_edge_update(ef, ln, w0, ts, tr, tg, b,
                                 jnp.asarray(snd), jnp.asarray(rcv),
                                 N_SLOTS, E_SLOTS)

    h_j, vjp = jax.vjp(jfn, *prim)
    grads_j = vjp(jnp.asarray(ct, bf))

    tdt = {"ef": torch.bfloat16, "w0": torch.bfloat16}
    ins = {k: _t(a[k], tdt.get(k, torch.float32)).requires_grad_()
           for k in names}
    ln = {"scale": ins["scale"], "bias": ins["bias"]} if use_ln else None
    before = pt_eu.LAUNCHES_NO_AGG
    h = pt_eu.fused_edge_update(ins["ef"], ln, ins["w0"], ins["ts"],
                                ins["tr"], ins["tg"], ins["b"],
                                torch.from_numpy(snd), torch.from_numpy(rcv),
                                N_SLOTS, E_SLOTS)
    assert pt_eu.LAUNCHES_NO_AGG == before
    assert h.dtype == torch.bfloat16
    assert np.abs(_np(h) - _np(h_j)).max() <= 5e-2 * np.abs(_np(h_j)).max()
    h.backward(_t(ct, torch.bfloat16))
    for k, gj in zip(names, grads_j):
        if not use_ln and k in ("scale", "bias"):
            assert ins[k].grad is None or not ins[k].grad.any()
            continue
        gp, gj = _np(ins[k].grad), _np(gj)
        assert gp.shape == gj.shape, k
        assert np.abs(gp - gj).max() <= 5e-2 * np.abs(gj).max(), k


def test_scatter_routes_sorted_pad_safe_sums_to_the_kernel(monkeypatch):
    """``aggregate_edges_for_nodes`` takes the sorted kernel under the JAX
    gate (kernels on, > 64 segments, supported shape) and the masked plain
    sum otherwise; both give the same sum on a pad-safe layout."""
    from graphnets_tpu.ops.pallas.segment_sum import \
        supports_sorted_segment_sum
    for shape in [(1024, 128, 128), (1000, 128, 128), (1024, 128, 96),
                  (64, 8, 128)]:
        assert pt_ss.supports_sorted_segment_sum(*shape) == \
            supports_sorted_segment_sum(*shape)
    _, rcv = _ids(11, True)
    ids = torch.from_numpy(rcv)
    mask = torch.from_numpy((np.arange(E) % E_SLOTS) < E_SLOTS - 37)
    x = torch.randn(E, D).bfloat16()
    calls = []
    real = pt_ss.sorted_segment_sum
    monkeypatch.setattr(pt_ss, "sorted_segment_sum",
                        lambda *a: calls.append(a[2]) or real(*a))
    old = pt_config.get_config().use_kernels
    try:
        pt_config.enable_kernels(True)
        y_k = pt_scatter.aggregate_edges_for_nodes(x, ids, N, mask)
        pt_scatter.segment_sum(x[:512], ids[:512] // 64, 8, None,
                               sorted_pad_safe=True)  # 8 <= 64 segments
        pt_config.enable_kernels(False)
        y_p = pt_scatter.aggregate_edges_for_nodes(x, ids, N, mask)
    finally:
        pt_config.get_config().use_kernels = old
    assert calls == [N]
    # Padded edges land on each slot's padding node only on the kernel
    # route (it skips the mask); real nodes agree exactly.
    real = np.arange(N) % N_SLOTS != N_SLOTS - 1
    np.testing.assert_array_equal(_np(y_k)[real], _np(y_p)[real])
