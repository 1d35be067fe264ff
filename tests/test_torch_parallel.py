"""The port's data and tensor parallelism (``graphnets_tpu_torch.parallel``)
against the JAX package's, on 4 gloo ranks of the CPU.

The ranks are spawned once for the file (``tests/torch_rank_cases.py``,
which imports no JAX) and run every multi-rank case; the JAX side runs on
the conftest's 8 virtual CPU devices with Pallas off, as
``tests/test_parallel.py`` does.  Tolerances: the DP step with SGD
against JAX's ``make_dp_train_step`` at that test's (loss rtol 1e-5,
parameters rtol 1e-4 / atol 1e-5), against the port's single process at
1e-5; the DP x TP loss within 1e-4 relative of the single-device loss
(``__graft_entry__.py:111``) and of JAX's, its AdamW parameters within
1e-5 of their largest magnitude plus a tenth of the learning rate (the
captured-vs-eager rule: Adam's first update is sign-like where a gradient
is within rounding of 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import graphnets_tpu_torch as pt
import torch_rank_cases as rc
from graphnets_tpu.data.sort_task import (SortTaskConfig, get_batch,
                                          sort_pad_spec)
from graphnets_tpu.models.encode_process_decode import \
    EncodeProcessDecode as JaxEncodeProcessDecode
from graphnets_tpu.models.gn_core import GNCore as JaxGNCore
from graphnets_tpu.parallel.data_parallel import (make_dp_train_step,
                                                  shard_batch, stack_shards)
from graphnets_tpu.parallel.mesh import make_mesh
from graphnets_tpu.parallel.tensor_parallel import (param_shardings,
                                                    shard_params)
from graphnets_tpu.training.losses import graph_loss_nf_ef
from graphnets_tpu.training.train import TrainState
from graphnets_tpu_torch.parallel import data_parallel as p_dp
from graphnets_tpu_torch.parallel.launch import run_ranks
from graphnets_tpu_torch.params import shard_of
from torch.distributed.tensor import Shard

TP_LR = 1e-3
DROPOUT_SEED = 11


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _amax(a):
    return np.abs(a).max(initial=1e-30)


def _spec_name(sharding):
    """JAX's spec as the port's placement on the ``model`` axis."""
    return {P(): "Replicate()", P(None, "model"): "Shard(dim=1)",
            P("model", None): "Shard(dim=0)"}[sharding.spec]


@pytest.fixture(scope="module")
def jax_side(cpu_devices):
    """The JAX package's parameters and steps, on its CPU mesh."""
    dp_model = JaxEncodeProcessDecode((0, 6, 0), (8, 8, 8), (2, 2, 0),
                                      n_cores=1)
    dp_state = TrainState.create(dp_model, optax.sgd(1e-2),
                                 jax.random.PRNGKey(2))
    cfg = SortTaskConfig(**rc.DP_CFG)
    rng = np.random.default_rng(1)
    shards = [get_batch(rng, cfg, sort_pad_spec(cfg)) for _ in range(4)]
    mesh = make_mesh((4,), ("data",), devices=cpu_devices)
    X = stack_shards([s[0] for s in shards])
    Y = stack_shards([s[1] for s in shards])
    state_dp, m_dp = make_dp_train_step(dp_model, optax.sgd(1e-2), mesh)(
        dp_state, shard_batch(X, mesh), shard_batch(Y, mesh))

    # __graft_entry__.py:74-113: DP x TP over (2, 2), AdamW(1e-3).
    tp_model = JaxEncodeProcessDecode((0, 16, 0), (32, 32, 32), (2, 2, 0),
                                      n_cores=2)
    params0 = tp_model.init(jax.random.PRNGKey(0))
    mesh2 = make_mesh((2, 2), ("data", "model"), devices=cpu_devices[:4])
    opt = optax.adamw(TP_LR)
    placed = shard_params(params0, mesh2, axis="model", min_size=1 << 10)
    state = TrainState(params=placed, opt_state=opt.init(placed),
                       step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(1))
    cfg = SortTaskConfig(**rc.TP_CFG)
    rng = np.random.default_rng(0)
    tshards = [get_batch(rng, cfg, sort_pad_spec(cfg)) for _ in range(2)]
    X = shard_batch(stack_shards([s[0] for s in tshards]), mesh2)
    Y = shard_batch(stack_shards([s[1] for s in tshards]), mesh2)
    state_tp, m_tp = make_dp_train_step(tp_model, opt, mesh2,
                                        param_shardings=True)(state, X, Y)
    ref_loss = float(np.mean([graph_loss_nf_ef(tp_model.apply(params0, x),
                                               y) for x, y in tshards]))
    sh = param_shardings(params0, mesh2, min_size=1 << 10)
    return {
        "dp_tree": _np_tree(dp_state.params),
        "dp_params": _flat(_np_tree(state_dp.params)),
        "dp_loss": float(m_dp["loss"]),
        "tp_tree": _np_tree(params0),
        "tp_params": _flat(_np_tree(state_tp.params)),
        "tp_loss": float(m_tp["loss"]), "tp_ref_loss": ref_loss,
        "tp_specs": {n: _spec_name(s) for n, s in _flat(sh).items()},
    }


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every multi-rank case, on 4 spawned gloo ranks."""
    return run_ranks(rc.parallel_cases, 4,
                     str(tmp_path_factory.mktemp("ranks")),
                     jax_side["dp_tree"], jax_side["tp_tree"], DROPOUT_SEED,
                     device="cpu", timeout_s=300)


def _tp_specs_jax(params, tp, min_size, cpu_devices):
    mesh = make_mesh((8 // tp, tp), ("data", "model"), devices=cpu_devices)
    return {n: _spec_name(s) for n, s in _flat(
        param_shardings(params, mesh, min_size=min_size)).items()}


@pytest.mark.parametrize("which", ["gncore128", "headline"])
def test_param_shardings_match_jax(which, ranks, cpu_devices):
    """The rule on every parameter name: ``GNCore(128)`` at
    ``min_size=1 << 12`` (``tests/test_misc.py:19``) and the headline-width
    ``EncodeProcessDecode`` at the default, on a ``model`` axis of 4."""
    if which == "gncore128":
        params = JaxGNCore((128, 128, 128)).init(jax.random.PRNGKey(0))
        min_size = 1 << 12
    else:
        params = JaxEncodeProcessDecode((0, 100, 0), (384, 384, 384),
                                        (2, 2, 0)).init(
            jax.random.PRNGKey(0))
        min_size = 1 << 14
    want = _tp_specs_jax(params, 4, min_size, cpu_devices)
    got = ranks[0]["specs"][which]
    assert got == want
    assert "Shard(dim=1)" in got.values() and "Shard(dim=0)" in got.values()


def test_param_shardings_dp_tp_model_match_jax(jax_side, ranks):
    dims = ranks[0]["tp_dims"]
    want = {n: s for n, s in jax_side["tp_specs"].items()
            if s != "Replicate()"}
    assert {n: f"Shard(dim={d})" for n, d in dims.items()} == want


def test_make_mesh_shapes_and_errors(ranks):
    for r, got in enumerate(ranks):
        names1, shape1, names2, shape2, i_data, i_model = got["mesh"]
        assert (names1, shape1) == (("data",), (4,))
        assert (names2, shape2) == (("data", "model"), (2, 2))
        assert (i_data, i_model) == divmod(r, 2)
        assert got["placements"] == ("(Replicate(), Replicate())",
                                     "(Replicate(), Shard(dim=0))",
                                     "(Shard(dim=0), Replicate())")
        assert len(got["mesh_errors"]) == 2
        assert "hold 3 ranks, the world has 4" in got["mesh_errors"][0]


def test_stack_and_shard_batch(ranks):
    """``stack_shards`` stacks on a new leading axis and refuses shards of
    other pad sizes; ``shard_batch`` gives rank ``i`` shard ``i``."""
    shards = rc.sort_shards(rc.DP_CFG, 1, 4)
    X = p_dp.stack_shards([s[0] for s in shards])
    assert tuple(X.senders.shape) == (4, shards[0][0].num_edge_slots)
    assert X.slot_shape == shards[0][0].slot_shape
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["shard_senders"],
                                      shards[r][0].senders.numpy())
    cfg = pt.SortTaskConfig(vocab_size=6, min_nodes=2, max_nodes=4,
                            batch_size=2)
    other, _ = pt.get_batch(np.random.default_rng(0), cfg,
                            pt.sort_pad_spec(cfg), device="cpu")
    with pytest.raises(AssertionError, match="pad sizes"):
        p_dp.stack_shards([shards[0][0], other])


def _single_process_step(model, shards, generator=None):
    """One SGD(1e-2) step of the mean loss over ``shards``, shard ``i``
    under ``shard_generator(generator, i)``: the documented DP contract."""
    losses = []
    for i, (x, y) in enumerate(shards):
        gen = (None if generator is None
               else p_dp.shard_generator(generator, i))
        losses.append(pt.graph_loss_nf_ef(
            model(x, training=True, generator=gen), y))
    loss = torch.stack(losses).mean()
    loss.backward()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    opt.step()
    return float(loss.detach()), {n: p.detach().numpy()
                         for n, p in model.named_parameters()}


def test_dp_matches_jax_and_single_process(jax_side, ranks):
    """``tests/test_parallel.py:53`` on the port: 4 ranks, SGD(1e-2),
    dropout 0."""
    loss, params = _single_process_step(rc.dp_model(jax_side["dp_tree"]),
                                        rc.sort_shards(rc.DP_CFG, 1, 4))
    for got in ranks:
        np.testing.assert_allclose(got["dp_loss"], jax_side["dp_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["dp_loss"], loss, rtol=1e-5)
        for n, ref in jax_side["dp_params"].items():
            np.testing.assert_allclose(got["dp_params"][n], ref, rtol=1e-4,
                                       atol=1e-5, err_msg=n)
            np.testing.assert_allclose(got["dp_params"][n], params[n],
                                       rtol=0, atol=1e-5 * _amax(params[n]),
                                       err_msg=n)


def test_dp_dropout_masks_differ_and_match_the_loop(ranks):
    """Dropout 0.5: each rank draws its own masks, and the step equals one
    process looping over the shards with ``shard_generator(gen, i)``
    (``tests/test_parallel.py:720``'s contract)."""
    nf = [got["dropout_nf"] for got in ranks]
    assert not np.allclose(nf[0], nf[1]) and not np.allclose(nf[1], nf[2])
    loss, params = _single_process_step(
        rc.dp_model(dropout=0.5, seed=5), rc.sort_shards(rc.DP_CFG, 7, 4),
        torch.Generator().manual_seed(DROPOUT_SEED))
    for got in ranks:
        np.testing.assert_allclose(got["dropout_loss"], loss, rtol=1e-5)
        for n, ref in params.items():
            np.testing.assert_allclose(got["dropout_params"][n], ref,
                                       rtol=0, atol=1e-5 * _amax(ref),
                                       err_msg=n)


def test_dp_tp_matches_jax(jax_side, ranks):
    """``__graft_entry__.py:74-113`` on the port: DP x TP (2, 2),
    AdamW(1e-3), ``min_size=1 << 10``; the loss equals the single-device
    loss, each rank holds and updates half of each sharded weight."""
    ref = jax_side["tp_ref_loss"]
    for r, got in enumerate(ranks):
        assert abs(got["tp_loss"] - ref) <= 1e-4 * max(1.0, abs(ref))
        np.testing.assert_allclose(got["tp_loss"], jax_side["tp_loss"],
                                   rtol=1e-4)
        coord = r % 2
        for n, full in jax_side["tp_params"].items():
            dim = got["tp_dims"].get(n)
            want = full if dim is None else shard_of(
                full, Shard(dim), coord, 2)
            bound = 1e-5 * _amax(full) + 0.1 * TP_LR
            assert got["tp_params"][n].shape == want.shape, n
            assert np.abs(got["tp_params"][n] - want).max(
                initial=0.0) <= bound, n
        assert got["tp_dims"], "no weight was sharded"
        for n in got["tp_dims"]:
            assert 2 * got["tp_stored"][n] == got["tp_full"][n], n
            assert got["tp_moments"][n] == 2 * got["tp_stored"][n], n


@pytest.mark.parametrize("name", ["mesh", "distributed", "data_parallel",
                                  "tensor_parallel", "pipeline"])
def test_module_surface_matches_jax(name):
    """Each module exports JAX's names, but for JAX's sharding types
    (``P``, ``Mesh``, ``NamedSharding``), whose counterparts are the
    ``DeviceMesh`` and the placements the port exports instead."""
    import importlib
    jax_mod = importlib.import_module(f"graphnets_tpu.parallel.{name}")
    port = importlib.import_module(f"graphnets_tpu_torch.parallel.{name}")
    want = set(jax_mod.__all__) - {"P", "Mesh", "NamedSharding"}
    assert want <= set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)
