"""The port's nn modules, scatter primitives and parameter loading against
graphnets_tpu, on the CPU.  f32 comparisons at 1e-5 (1e-4 for sums in
another order); bf16 at one bf16 rounding (2^-7 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
from graphnets_tpu.nn import core as jcore
from graphnets_tpu.ops import scatter as jsc
from graphnets_tpu.ops.pallas.ln_linear import ln_matmul_reference
from graphnets_tpu_torch.nn import core as pcore
from graphnets_tpu_torch.ops import ln_linear as pln
from graphnets_tpu_torch.ops import scatter as psc


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("din,dout", [(6, 5), (0, 4), (4, 0)])
def test_linear_matches_jax(din, dout):
    x = np.random.default_rng(0).normal(size=(7, din)).astype(np.float32)
    lj = jcore.Linear(din, dout)
    params = lj.init(jax.random.PRNGKey(0))
    params["b"] = jnp.arange(dout, dtype=jnp.float32)
    lp = pt.from_jax_params(_np_tree(params), pcore.Linear(din, dout,
                                                           device="cpu"))
    out = lp(torch.from_numpy(x))
    assert out.shape == (7, dout)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(lj.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_linear_init_is_glorot_and_seeded():
    a = pcore.Linear(64, 32, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    b = pcore.Linear(64, 32, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    limit = (6.0 / (64 + 32)) ** 0.5
    assert torch.equal(a.w, b.w)
    w = a.w.detach()
    assert float(w.abs().max()) <= limit and float(w.std()) > 0.3 * limit
    assert a.w.shape == (64, 32) and torch.count_nonzero(a.b) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 16)).astype(np.float32) * 3 + 1
    x[2] = 0.0   # var == 0 row: std is taken as 0
    x[4] = 5.0
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jcore.LayerNorm(16).apply({"scale": jnp.asarray(scale),
                                     "bias": jnp.asarray(bias)},
                                    jnp.asarray(x, jdt))
    ln = pt.from_jax_params({"scale": scale, "bias": bias},
                            pcore.LayerNorm(16, device="cpu"))
    out = ln(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def test_layernorm_is_flux_not_torch():
    # A small spread, where std + eps and sqrt(var + eps) differ clearly.
    x = torch.tensor([[0.0, 1e-4, 2e-4, 3e-4]])
    y = pcore.layer_norm(x, None, None)
    std = x.std(unbiased=False)
    assert torch.allclose(y, (x - x.mean()) / (std + 1e-5))
    assert not torch.allclose(y, torch.nn.functional.layer_norm(x, (4,)),
                              rtol=1e-2)


def test_layernorm_zero_row_gradient_is_finite():
    x = torch.zeros(3, 8, requires_grad=True)
    scale = torch.ones(8, requires_grad=True)
    pcore.layer_norm(x, scale, torch.zeros(8)).sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(scale.grad).all()


def test_dropout():
    x = torch.ones(1000, 8)
    d = pcore.Dropout(0.25)
    assert d(x) is x and pcore.Dropout(0.0)(x, training=True) is x
    with pytest.raises(ValueError):
        d(x, training=True)
    y1 = d(x, training=True, generator=torch.Generator().manual_seed(0))
    y2 = d(x, training=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y1, y2)
    kept = y1 != 0
    assert torch.allclose(y1[kept], torch.full_like(y1[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.02


def test_feedforward_chain_matches_jax():
    d = 8
    x = np.random.default_rng(2).normal(size=(5, d)).astype(np.float32)
    fj = jcore.FeedForward(d)
    params = fj.init(jax.random.PRNGKey(2))
    fp = pt.from_jax_params(_np_tree(params),
                            pcore.FeedForward(d, device="cpu"))
    assert {n for n, _ in fp.named_parameters()} == {"0.w", "0.b", "1.w",
                                                      "1.b"}
    np.testing.assert_allclose(
        fp(torch.from_numpy(x)).detach().numpy(),
        np.asarray(fj.apply(params, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_from_jax_params_is_strict():
    params = _np_tree(gn.GNCore((8, 8, 8)).init(jax.random.PRNGKey(0)))
    core = pt.GNCore((8, 8, 8), device="cpu")
    pt.from_jax_params(params, core)
    np.testing.assert_array_equal(core.block.edgefn.w.detach().numpy(),
                                  params["block"]["edgefn"]["w"])
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["block"]["edgefn"]["w"] = bad["block"]["edgefn"]["w"].T
    with pytest.raises(ValueError, match="shape"):
        pt.from_jax_params(bad, core)
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["gn2"]["edgeln"]["scale"]
    with pytest.raises(ValueError, match="missing"):
        pt.from_jax_params(missing, core)
    # bf16 arrays load exactly into a bf16 module.
    p16 = jax.tree_util.tree_map(lambda a: np.asarray(
        jnp.asarray(a, jnp.bfloat16)), params)
    c16 = pt.from_jax_params(p16, pt.GNCore((8, 8, 8), device="cpu",
                                            dtype=torch.bfloat16))
    np.testing.assert_array_equal(
        c16.ffwd.eff[0].w.detach().float().numpy(),
        np.asarray(p16["ffwd"]["eff"]["0"]["w"], np.float32))


def _seg_inputs(seed, rows, n_seg, d=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    seg = np.sort(rng.integers(0, n_seg, rows)).astype(np.int32)
    mask = rng.random(rows) < 0.8
    return x, seg, mask


@pytest.mark.parametrize("n_seg", [3, 64, 100])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_matches_jax(n_seg, masked):
    x, seg, mask = _seg_inputs(3, 400, n_seg)
    m = mask if masked else None
    ref = jsc.segment_sum(jnp.asarray(x), jnp.asarray(seg), n_seg,
                          None if m is None else jnp.asarray(m))
    out = psc.segment_sum(torch.from_numpy(x), torch.from_numpy(seg), n_seg,
                          None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_segment_sum_bf16_accumulates_in_f32():
    x = torch.full((4096, 2), 1.0, dtype=torch.bfloat16)
    seg = torch.zeros(4096, dtype=torch.int32)
    out = psc.segment_sum(x, seg, 1)
    assert out.dtype == torch.bfloat16 and float(out[0, 0]) == 4096.0


def test_aggregations_and_broadcasts_match_jax():
    data = {"graphs": [np.ones((3, 3), int), np.eye(4, k=1, dtype=int)],
            "ef": None, "nf": None, "gf": np.ones((2, 1))}
    rng = np.random.default_rng(4)
    data["ef"] = [rng.normal(size=(9, 3)), rng.normal(size=(3, 3))]
    data["nf"] = [rng.normal(size=(3, 3)), rng.normal(size=(4, 3))]
    data["gf"] = rng.normal(size=(2, 3))
    for pad in (gn.PadSpec(9, 16, 3), gn.PadSpec.uniform(5, 12)):
        gj, gp = gn.batch(data, pad=pad), pt.batch(data, pad=pad,
                                                   device="cpu")
        pairs = [
            (jsc.aggregate_edges_for_nodes(gj.ef, gj.receivers,
                                           gj.num_node_slots, gj.edge_mask),
             psc.aggregate_edges_for_nodes(gp.ef, gp.receivers,
                                           gp.num_node_slots, gp.edge_mask)),
            (jsc.aggregate_edges_for_globals(
                gj.ef, gj.edge_graph, gj.num_graph_slots, gj.edge_mask,
                mask_aliases_real=gj.pad_aliases_real),
             psc.aggregate_edges_for_globals(gp.ef, gp.edge_graph,
                                             gp.num_graph_slots,
                                             gp.edge_mask)),
            (jsc.aggregate_nodes_for_globals(
                gj.nf, gj.node_graph, gj.num_graph_slots, gj.node_mask,
                mask_aliases_real=gj.pad_aliases_real),
             psc.aggregate_nodes_for_globals(gp.nf, gp.node_graph,
                                             gp.num_graph_slots,
                                             gp.node_mask)),
            (jsc.broadcast_globals_to_edges(gj.gf, gj.edge_graph),
             psc.broadcast_globals_to_edges(gp.gf, gp.edge_graph)),
            (jsc.broadcast_globals_to_nodes(gj.gf, gj.node_graph),
             psc.broadcast_globals_to_nodes(gp.gf, gp.node_graph)),
            (jsc.gather_nodes(gj.nf, gj.senders),
             psc.gather_nodes(gp.nf, gp.senders)),
        ]
        for a, b in pairs:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("with_addend", [False, True])
def test_ln_matmul_reference_matches_jax(with_addend):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    s, b = rng.normal(size=32).astype(np.float32), \
        rng.normal(size=32).astype(np.float32)
    w = rng.normal(size=(32, 8)).astype(np.float32)
    add = rng.normal(size=(16, 8)).astype(np.float32) if with_addend \
        else None
    ref = ln_matmul_reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s),
                              jnp.asarray(b), jnp.asarray(w),
                              None if add is None else jnp.asarray(add))
    t = lambda a: torch.from_numpy(a)
    out = pln.ln_matmul_reference(t(x).bfloat16(), t(s), t(b), t(w),
                                  None if add is None else t(add))
    assert out.dtype == (torch.bfloat16 if with_addend else torch.float32)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)
