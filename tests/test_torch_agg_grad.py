"""The gradients of the inference edge update with its edge->node sum
(``fused_edge_update_agg``) against the JAX package's ``custom_vjp``.

JAX's ``fused_edge_update_agg`` is differentiable through both outputs:
its backward adds the sorted gather of ``agg``'s cotangent to ``h``'s and
then takes the LN->matmul backward and the sums of the variant without
the sum (``graphnets_tpu/ops/pallas/edge_update.py:264-297``).  The port's
``_FusedEdgeUpdateAgg`` does the same on both devices; on the CPU its
forward is the plain version.  The JAX kernels run in Pallas interpret
mode; the same numpy inputs (a uniform layout of 4 graphs x 32 node slots
x 256 edge slots, d = 128) go to both.  ``GNBlock(training=False)`` on a
uniform layout takes the agg variant in both packages, and its gradients
are held against ``jax.grad`` of ``block.apply``.  Tolerances are those of
``tests/test_torch_edge_update_gate.py`` and
``tests/test_torch_backward_kernels.py``: 5e-2 of each tensor's largest
magnitude (bf16 cotangents through bf16 products; f32 rows take the same
bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.ops.pallas import edge_update as j_eu
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops.kernels import edge_update as pt_eu
from graphnets_tpu_torch.ops.kernels import gather as pt_ga
from graphnets_tpu_torch.utils import config as pt_config

G, N_SLOTS, E_SLOTS, D = 4, 32, 256, 128
N, E = G * N_SLOTS, G * E_SLOTS
_DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
       "f32": (torch.float32, jnp.float32)}
NAMES = ("ef", "scale", "bias", "w0", "ts", "tr", "tg", "b")


@pytest.fixture
def kernels_on():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(True, interpret=True)
    pt.enable_kernels(True)
    yield
    enable_pallas(old[0], interpret=old[1])
    pt_config.get_config().use_kernels = old_pt


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(out, ref, what):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, what
    assert np.isfinite(out).all(), what
    assert np.abs(out - ref).max() <= 5e-2 * np.abs(ref).max(initial=1e-30), \
        (what, np.abs(out - ref).max(), np.abs(ref).max())


def _ids(seed, padded):
    """Graph-local senders in no order, ascending receivers; with
    ``padded`` each slot's tail edges target its last node."""
    rng = np.random.default_rng(seed)
    snd, rcv = [], []
    for b in range(G):
        n_real = N_SLOTS - 1 if padded else N_SLOTS
        s = rng.integers(0, n_real, E_SLOTS) + b * N_SLOTS
        r = np.sort(rng.integers(0, n_real, E_SLOTS)) + b * N_SLOTS
        if padded:
            s[E_SLOTS - 37:] = r[E_SLOTS - 37:] = (b + 1) * N_SLOTS - 1
        snd.append(s)
        rcv.append(r)
    return (np.concatenate(snd).astype(np.int32),
            np.concatenate(rcv).astype(np.int32))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_fused_edge_update_agg_gradients_match_jax_vjp(kernels_on, dtype,
                                                       use_ln, padded):
    """Both outputs' cotangents at once, every input's gradient."""
    tdt, jdt = _DT[dtype]
    snd, rcv = _ids(9, padded)
    rng = np.random.default_rng(10)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a = dict(ef=f(E, D), scale=1 + 0.1 * f(D), bias=0.1 * f(D),
             w0=f(D, D) * D ** -0.5, ts=f(N, D), tr=f(N, D), tg=f(G, D),
             b=f(D))
    ct_h, ct_agg = f(E, D), f(N, D)
    low = {"ef", "w0"}
    prim = [jnp.asarray(a[k], jdt if k in low else jnp.float32)
            for k in NAMES]

    def jfn(ef, scale, bias, w0, ts, tr, tg, b):
        ln = {"scale": scale, "bias": bias} if use_ln else None
        return j_eu.fused_edge_update_agg(ef, ln, w0, ts, tr, tg, b,
                                          jnp.asarray(snd), jnp.asarray(rcv),
                                          N_SLOTS, E_SLOTS)

    (h_j, agg_j), vjp = jax.vjp(jfn, *prim)
    grads_j = vjp((jnp.asarray(ct_h, jdt), jnp.asarray(ct_agg)))

    ins = {k: torch.from_numpy(a[k]).to(tdt if k in low else torch.float32)
           .requires_grad_() for k in NAMES}
    ln = {"scale": ins["scale"], "bias": ins["bias"]} if use_ln else None
    h, agg = pt_eu.fused_edge_update_agg(
        ins["ef"], ln, ins["w0"], ins["ts"], ins["tr"], ins["tg"], ins["b"],
        torch.from_numpy(snd), torch.from_numpy(rcv), N_SLOTS, E_SLOTS)
    # Both outputs come from the one differentiable op.
    assert h.grad_fn is agg.grad_fn
    assert h.grad_fn.name() == "_FusedEdgeUpdateAggBackward"
    _close(h, h_j, "h")
    _close(agg, agg_j, "agg")
    torch.autograd.backward((h, agg), (torch.from_numpy(ct_h).to(tdt),
                                       torch.from_numpy(ct_agg)))
    for k, gj in zip(NAMES, grads_j):
        if not use_ln and k in ("scale", "bias"):
            assert ins[k].grad is None or not ins[k].grad.any()
            continue
        _close(ins[k].grad, gj, k)


def test_agg_cotangent_goes_through_the_sorted_gather(monkeypatch):
    """The backward gathers ``agg``'s cotangent by receiver in ``h``'s type
    (the sorted gather's plain version on the CPU) and adds it to ``h``'s:
    with a zero ``h`` cotangent, ``ts``'s gradient is the windowed sum of
    the gathered rows."""
    snd, rcv = _ids(3, False)
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    ef = f(E, D).to(torch.bfloat16)
    ts, tr, tg = (f(N, D).requires_grad_(), f(N, D), f(G, D))
    calls = []
    real = pt_ga.sorted_gather_plain

    def spy(table, idx):
        calls.append((table.dtype, tuple(table.shape)))
        return real(table, idx)

    monkeypatch.setattr(pt_ga, "sorted_gather_plain", spy)
    h, agg = pt_eu.fused_edge_update_agg(
        ef, None, f(D, D).to(torch.bfloat16), ts, tr, tg, None,
        torch.from_numpy(snd), torch.from_numpy(rcv), N_SLOTS, E_SLOTS)
    g_agg = f(N, D)
    agg.backward(g_agg)
    assert calls == [(torch.bfloat16, (N, D))]
    rows = g_agg.to(torch.bfloat16).float()[torch.from_numpy(rcv).long()]
    want = torch.zeros(N, D).index_add_(0, torch.from_numpy(snd).long(),
                                        rows.to(torch.bfloat16).float())
    _close(ts.grad, want, "ts")


def _batch(seed, G, ns, es, dims):
    rng = np.random.default_rng(seed)
    de, dn, dg = dims
    adjs, efs, nfs = [], [], []
    for _ in range(G):
        n = ns - 3
        m = min(es - 5, n * n)
        cells = rng.choice(n * n, size=m, replace=False)
        adj = np.zeros((n, n), np.int64)
        adj[cells // n, cells % n] = 1
        adjs.append(adj)
        efs.append(rng.normal(size=(m, de)).astype(np.float32))
        nfs.append(rng.normal(size=(n, dn)).astype(np.float32))
    data = {"graphs": adjs, "ef": efs, "nf": nfs,
            "gf": rng.normal(size=(G, dg)).astype(np.float32)}
    pad = gn.PadSpec.uniform(ns, es, edge_multiple=64)
    bf = lambda g, c: g.with_features(ef=c(g.ef), nf=c(g.nf), gf=c(g.gf))
    gj = bf(gn.batch(data, pad=pad), lambda x: x.astype(jnp.bfloat16))
    gp = bf(pt.batch(data, pad=pad, device="cpu"),
            lambda x: x.to(torch.bfloat16))
    return gj, gp


def test_gnblock_inference_backward_matches_jax(kernels_on, monkeypatch):
    """``GNBlock(training=False)`` on a uniform bf16 layout takes the agg
    variant in both packages; the gradients of a masked sum of squares of
    its outputs to every parameter agree with ``jax.grad``."""
    dims = (128, 128, 128)
    gj, gp = _batch(7, 8, 32, 512, dims)
    block_j = gn.GNBlock(dims, dims)
    params = block_j.init(jax.random.PRNGKey(3))
    block_p = pt.GNBlock(dims, dims, device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), block_p)
    masks = [np.asarray(m, np.float32) for m in
             (gj.edge_mask, gj.node_mask, gj.graph_mask)]

    def loss_j(p):
        y = block_j.apply(p, gj, training=False)
        return sum(jnp.sum((getattr(y, k).astype(jnp.float32)
                            * m[:, None]) ** 2)
                   for k, m in zip(("ef", "nf", "gf"), masks))

    calls = []
    for who, mod in (("jax", j_eu), ("port", pt_eu)):
        real = mod.fused_edge_update_agg
        monkeypatch.setattr(mod, "fused_edge_update_agg",
                            lambda *a, _r=real, _w=who, **k:
                            calls.append(_w) or _r(*a, **k))
    grads_j = jax.grad(loss_j)(params)
    y = block_p(gp, training=False)
    loss = sum(((getattr(y, k).float() * torch.from_numpy(m)[:, None]) ** 2
                ).sum() for k, m in zip(("ef", "nf", "gf"), masks))
    loss.backward()
    assert calls == ["jax", "port"]
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = v
    walk(grads_j)
    named = dict(block_p.named_parameters())
    assert set(flat) == set(named)
    for n, gj_ in flat.items():
        if named[n].numel():
            _close(named[n].grad, gj_, n)
