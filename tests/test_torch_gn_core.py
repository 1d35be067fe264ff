"""The port's GNBlock / GNCore / GNCoreList forward against graphnets_tpu.

The same numpy graphs and the same parameters (moved by
``from_jax_params``) go through both packages on the CPU; real slots are
compared after ``unbatch``.  Tolerances: f32 at rtol 1e-4 / atol 1e-4
(the partial sums add in another order); bf16 at 5e-2 relative to the
largest output magnitude (a few bf16 ulps after two residual cores, the
JAX kernel tests' bf16 tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops.kernels import edge_update as pt_eu
from graphnets_tpu_torch.ops.kernels import fused_ffn as pt_ffn
from graphnets_tpu_torch.utils import config as pt_config


@pytest.fixture
def kernels_on():
    """JAX Pallas kernels in interpret mode and the port's kernel routes
    (plain versions on the CPU); both restored afterwards."""
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


def _graphs(seed, G, n, deg, d, padded):
    """G random graphs of n nodes, each node with ``deg`` in-edges; with
    ``padded`` the graphs are smaller than their uniform slots."""
    rng = np.random.default_rng(seed)
    adjs, efs, nfs = [], [], []
    for b in range(G):
        nb = n - 1 - b if padded else n
        adj = np.zeros((nb, nb), np.int64)
        for r in range(nb):
            adj[rng.choice(nb, size=min(deg, nb), replace=False), r] = 1
        adjs.append(adj)
        efs.append(rng.normal(size=(int(adj.sum()), d)).astype(np.float32))
        nfs.append(rng.normal(size=(nb, d)).astype(np.float32))
    gf = rng.normal(size=(G, d)).astype(np.float32)
    return {"graphs": adjs, "ef": efs, "nf": nfs, "gf": gf}


def _pair(data, pad, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    gj = gn.batch(data, pad=pad)
    gj = gj.with_features(ef=gj.ef.astype(jdt), nf=gj.nf.astype(jdt),
                          gf=gj.gf.astype(jdt))
    gp = pt.batch(data, pad=pad, device="cpu")
    gp = gp.with_features(ef=gp.ef.to(dtype), nf=gp.nf.to(dtype),
                          gf=gp.gf.to(dtype))
    return gj, gp


def _np_params(params, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jdt)),
                                  params)


def _compare(yj, yp, dtype):
    uj, up = gn.unbatch(yj), pt.unbatch(yp)
    for key in ("ef", "nf", "gf"):
        a = np.concatenate([np.asarray(v, np.float32).reshape(-1)
                            for v in uj[key]])
        b = np.concatenate([np.asarray(v, np.float32).reshape(-1)
                            for v in up[key]])
        assert np.isfinite(b).all()
        if dtype == torch.float32:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
        else:
            err = np.abs(b - a).max() / np.abs(a).max()
            assert err <= 5e-2, (key, err)


def _corelist(dims, n_cores, dtype):
    stack_j = gn.GNCoreList([gn.GNCore(dims) for _ in range(n_cores)])
    params = _np_params(stack_j.init(jax.random.PRNGKey(0)), dtype)
    stack_p = pt.GNCoreList([pt.GNCore(dims, device="cpu", dtype=dtype)
                             for _ in range(n_cores)])
    pt.from_jax_params(params, stack_p)
    params_j = jax.tree_util.tree_map(jnp.asarray, params)
    return stack_j, params_j, stack_p


_LAYOUTS = {
    "uniform_exact": (False, lambda: gn.PadSpec.uniform(16, 128)),
    "uniform_padded": (True, lambda: gn.PadSpec.uniform(16, 128)),
    "bucketed": (True, lambda: gn.PadSpec(40, 300, 3)),
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_corelist_f32_matches_jax_pure(kernels_off, layout):
    padded, pad = _LAYOUTS[layout]
    d = 128
    data = _graphs(1, 2, 16, 8, d, padded)
    gj, gp = _pair(data, pad(), torch.float32)
    stack_j, params_j, stack_p = _corelist((d, d, d), 2, torch.float32)
    _compare(stack_j.apply(params_j, gj), stack_p(gp), torch.float32)


@pytest.mark.parametrize("padded", [False, True])
def test_corelist_bf16_kernels_match_jax_kernels(kernels_on, padded):
    """The slice: GNCoreList with the kernel routes (port: plain versions
    on the CPU; JAX: interpret-mode Pallas) on a uniform batch."""
    d = 128
    data = _graphs(2, 2, 16, 8, d, padded)
    gj, gp = _pair(data, gn.PadSpec.uniform(16, 128), torch.bfloat16)
    assert gp.slot_shape == (16, 128) and gp.pad_aliases_real == padded
    stack_j, params_j, stack_p = _corelist((d, d, d), 2, torch.bfloat16)
    calls = {"edge": 0, "ffn": 0}
    real_edge, real_ffn = pt_eu.fused_edge_update_agg, pt_ffn.ln_ffn_residual

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    launches = (pt_eu.LAUNCHES, pt_ffn.LAUNCHES)
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(pt_eu, "fused_edge_update_agg", spy("edge", real_edge))
        import graphnets_tpu_torch.models.gn_core as core_mod
        m.setattr(core_mod, "ln_ffn_residual", spy("ffn", real_ffn))
        yp = stack_p(gp)
    # Both kernel routes were taken: 1 edge update and 3 FFN calls per core.
    assert calls == {"edge": 2, "ffn": 6}
    assert (pt_eu.LAUNCHES, pt_ffn.LAUNCHES) == launches
    _compare(stack_j.apply(params_j, gj), yp, torch.bfloat16)


def test_corelist_bf16_pure_matches_jax_pure(kernels_off):
    d = 128
    data = _graphs(3, 2, 16, 8, d, True)
    gj, gp = _pair(data, gn.PadSpec.uniform(16, 128), torch.bfloat16)
    stack_j, params_j, stack_p = _corelist((d, d, d), 2, torch.bfloat16)
    _compare(stack_j.apply(params_j, gj), stack_p(gp), torch.bfloat16)


def test_kernel_route_matches_pure_route_bf16():
    """Within the port: the kernel route's output equals the pure route's
    within the stated bf16 tolerance."""
    d = 128
    data = _graphs(4, 2, 16, 8, d, False)
    gp = pt.batch(data, pad=pt.PadSpec.uniform(16, 128), device="cpu")
    gp = gp.with_features(ef=gp.ef.bfloat16(), nf=gp.nf.bfloat16(),
                          gf=gp.gf.bfloat16())
    stack = pt.GNCoreList([pt.GNCore((d, d, d), device="cpu",
                                     dtype=torch.bfloat16)
                           for _ in range(2)])
    old = pt_config.get_config().use_kernels
    try:
        pt.enable_kernels(True)
        y_k = pt.unbatch(stack(gp))
        pt.enable_kernels(False)
        y_p = pt.unbatch(stack(gp))
    finally:
        pt_config.get_config().use_kernels = old
    for key in ("ef", "nf", "gf"):
        a, b = np.concatenate(y_p[key]), np.concatenate(y_k[key])
        assert np.abs(a - b).max() <= 5e-2 * np.abs(a).max()


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("dims", [(8, 6, 4), (0, 6, 4), (8, 6, 0)])
def test_gnblock_matches_jax(kernels_off, split, dims):
    de, dn, dg = dims
    rng = np.random.default_rng(5)
    adjs = [np.ones((4, 4), int), np.eye(3, k=1, dtype=int)]
    n_e = [int(a.sum()) for a in adjs]
    data = {"graphs": adjs,
            "ef": [rng.normal(size=(e, de)).astype(np.float32)
                   for e in n_e] if de else None,
            "nf": [rng.normal(size=(a.shape[0], dn)).astype(np.float32)
                   for a in adjs],
            "gf": rng.normal(size=(2, dg)).astype(np.float32) if dg else None}
    pad = gn.PadSpec.bucketed(7, 19, 2)
    gj = gn.batch(data, pad=pad)
    gp = pt.batch(data, pad=pad, device="cpu")
    out_dims = (5, 7, 3)
    block_j = gn.GNBlock(dims, out_dims)
    params = jax.tree_util.tree_map(np.asarray,
                                    block_j.init(jax.random.PRNGKey(1)))
    block_p = pt.from_jax_params(params, pt.GNBlock(dims, out_dims,
                                                    device="cpu"))
    cfg, cfg_pt = get_config(), pt_config.get_config()
    old = (cfg.split_linear, cfg_pt.split_linear)
    cfg.split_linear = cfg_pt.split_linear = split
    try:
        yj = block_j.apply(jax.tree_util.tree_map(jnp.asarray, params), gj)
        yp = block_p(gp)
    finally:
        cfg.split_linear, cfg_pt.split_linear = old
    _compare(yj, yp, torch.float32)


def test_corelist_copies_repeated_core():
    core = pt.GNCore((8, 8, 8), device="cpu")
    stack = pt.GNCoreList([core] * 3)
    ws = [stack.get_submodule(f"{i}.block.edgefn").w for i in range(3)]
    assert len({w.data_ptr() for w in ws}) == 3
    assert all(torch.equal(ws[0], w) for w in ws)
    names = {n for n, _ in stack.named_parameters()}
    assert {"0.block.edgefn.w", "2.ffwd.eff.0.w", "1.gn1.edgeln.scale"} \
        <= names
