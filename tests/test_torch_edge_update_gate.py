"""The uniform fused edge update's gate and route against graphnets_tpu's.

``supports_fused_edge_update`` is the JAX package's gate term for term (its
tile choice, its VMEM budget and the ``with_agg`` term), and ``GNBlock``
asks it as the JAX ``GNBlock`` does: the kernel with the fused edge->node
sum in inference where the ``with_agg`` gate holds, the kernel alone
otherwise and under training, the composed split-linear path where the
gate refuses.  The same numpy batch goes through both packages (the JAX
kernels in Pallas interpret mode, the port's wrappers in their plain
versions on the CPU).  Outputs are held at the JAX kernel tests' bf16
tolerance: 5e-2 of each feature set's largest magnitude.
"""

import itertools

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
from graphnets_tpu_torch.utils import config as pt_config

# (G, n_slots, e_slots): the headline's, small and large node windows, a
# layout whose tile needs several graphs, one no tile fits.
_LAYOUTS = [(8, 128, 2048), (16, 64, 1024), (8, 32, 512), (8, 256, 64),
            (2, 24, 100)]
_WIDTHS = (128, 256, 384, 512, 640, 768, 1024)
_OUT_WIDTHS = (128, 256, 384, 512, 1024)


@pytest.fixture
def kernels_on():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(True, interpret=True)
    pt.enable_kernels(True)
    yield
    enable_pallas(old[0], interpret=old[1])
    pt_config.get_config().use_kernels = old_pt


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_supports_fused_edge_update_matches_jax(layout, dtype):
    """Every width pair, with and without the sum, on each layout."""
    G, ns, es = layout
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    E, N = G * es, G * ns
    for de, dout, with_agg in itertools.product(_WIDTHS, _OUT_WIDTHS,
                                                (False, True)):
        want = j_eu.supports_fused_edge_update(E, N, G, de, dout, ns, es,
                                               jdt, with_agg=with_agg)
        got = pt_eu.supports_fused_edge_update(E, N, G, de, dout, ns, es,
                                               tdt, with_agg=with_agg)
        assert got == want, (layout, de, dout, with_agg)


def test_supports_fused_edge_update_inconsistent_layouts():
    """Layouts that are not G uniform slots are refused, as in JAX."""
    bf = torch.bfloat16
    for args in [(16384, 1024, 1, 384, 384, 1024, 16384),   # G = 1
                 (16384, 1000, 8, 384, 384, 128, 2048),     # N != G n_slots
                 (16000, 1024, 8, 384, 384, 128, 2048)]:    # E != G e_slots
        assert not pt_eu.supports_fused_edge_update(*args, bf)
        assert not j_eu.supports_fused_edge_update(*args, jnp.bfloat16)


def _batch(seed, G, ns, es, dims, dtype):
    """G random graphs, each a few nodes and edges short of its uniform
    slots (``PadSpec.uniform(ns, es)``), features of widths ``dims``."""
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
    tdt, jdt = dtype
    gj = gn.batch(data, pad=pad)
    gj = gj.with_features(ef=gj.ef.astype(jdt), nf=gj.nf.astype(jdt),
                          gf=gj.gf.astype(jdt))
    gp = pt.batch(data, pad=pad, device="cpu")
    gp = gp.with_features(ef=gp.ef.to(tdt), nf=gp.nf.to(tdt),
                          gf=gp.gf.to(tdt))
    assert gp.slot_shape == (ns, es)
    return gj, gp


def _spies(monkeypatch):
    """Counts each package's calls of the uniform kernel and its agg
    variant (both ``GNBlock``s import them when they run)."""
    calls = {"jax": {"agg": 0, "h": 0}, "port": {"agg": 0, "h": 0}}
    for who, mod in (("jax", j_eu), ("port", pt_eu)):
        for key, name in (("agg", "fused_edge_update_agg"),
                          ("h", "fused_edge_update")):
            def spy(*a, _real=getattr(mod, name), _c=calls[who], _k=key,
                    **k):
                _c[_k] += 1
                return _real(*a, **k)
            monkeypatch.setattr(mod, name, spy)
    return calls


# (layout, dims in, dims out, dtype, what JAX's gate decides there):
# de = 512 on (8, 32, 512), which the port refused before it took JAX's
# gate; a layout where JAX fuses the update but not the sum; f32 rows,
# which compose.
_ROUTES = {
    "wide_ef": ((8, 32, 512), (512, 128, 128), (128, 128, 128), "bf16",
                {False: {"agg": 1, "h": 0}, True: {"agg": 0, "h": 1}}),
    "update_without_sum": ((8, 256, 64), (128, 128, 128), (256, 128, 128),
                           "bf16",
                           {False: {"agg": 0, "h": 1},
                            True: {"agg": 0, "h": 1}}),
    "f32_composes": ((8, 32, 512), (128, 128, 128), (128, 128, 128), "f32",
                     {False: {"agg": 0, "h": 0}, True: {"agg": 0, "h": 0}}),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("case", sorted(_ROUTES))
def test_gnblock_uniform_route_matches_jax(kernels_on, monkeypatch, case,
                                           training):
    """``GNBlock`` takes the kernel, its agg variant or the composed path
    exactly where the JAX ``GNBlock`` does, and its output agrees."""
    layout, din, dout, dtype, want = _ROUTES[case]
    dt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
          else (torch.float32, jnp.float32))
    gj, gp = _batch(7, *layout, din, dt)
    block_j = gn.GNBlock(din, dout)
    params = block_j.init(jax.random.PRNGKey(3))
    cast = jax.tree_util.tree_map(lambda p: p.astype(dt[1]), params)
    block_p = pt.GNBlock(din, dout, device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), block_p)
    block_p.to(dt[0])
    calls = _spies(monkeypatch)
    y_j = block_j.apply(cast, gj, training=training)
    with torch.no_grad():
        y_p = block_p(gp, training=training)
    assert calls["jax"] == want[training]
    assert calls["port"] == calls["jax"]
    for key, mask in (("ef", gj.edge_mask), ("nf", gj.node_mask),
                      ("gf", gj.graph_mask)):
        m = np.asarray(mask)
        a = np.asarray(getattr(y_j, key), np.float32)[m]
        b = getattr(y_p, key).float().numpy()[m]
        assert np.isfinite(b).all()
        err = np.abs(b - a).max() / max(np.abs(a).max(), 1e-6)
        assert err <= 5e-2, (case, key, err)
