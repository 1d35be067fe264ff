"""The port's partitioned stacks and their training step
(``graphnets_tpu_torch.parallel.edge_partition_stack``) against the JAX
package's unpartitioned model and ``make_train_step``, on 4 gloo ranks of
the CPU.

The ranks are spawned once for the file (``tests/torch_rank_cases.py``):
the stack forward over 4 shards (``tests/test_parallel.py:481``), 20
AdamW steps over 4 shards (``:516``), with kernels on (their plain
versions on the CPU) the stack forward at dims 128 (``:776``) and 3
training steps through the single-graph edge update with its sum
(``:589``), one step with that sum off under training over 2 shards
(``:849``), and the GNCore / GNCoreList entry points.  The JAX side runs
its unpartitioned model with Pallas off (eager forwards, jitted steps),
the reference its tests hold the partitioned path to, and for the kernel
route forward its partitioned model with the Pallas kernels in interpret
mode.  Every comparison is direct, at JAX's tests' tolerances (forward
rtol 2e-4 / atol 2e-5; 20 steps: losses rtol 5e-4 / atol 1e-6,
parameters rtol 1e-4 / atol 1e-4; the kernel routes: losses rtol 2e-4 /
atol 1e-6, parameters rtol 2e-3 / atol 2e-4), against JAX and against
the port's own unpartitioned model, but for the 20-step losses from step
16 on (``DRIFT_FROM``).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
import torch_rank_cases as rc
from graphnets_tpu.models.encode_process_decode import EncodeProcessDecode
from graphnets_tpu.training.losses import graph_loss_nf_ef
from graphnets_tpu.training.train import TrainState, make_train_step
from graphnets_tpu_torch.parallel import edge_partition as ep
from graphnets_tpu_torch.parallel import edge_partition_stack as eps
from graphnets_tpu_torch.parallel.launch import run_ranks
from graphnets_tpu_torch.utils.config import enable_kernels

S = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _graph(seed, N, deg, vocab, targets=True):
    """The JAX tests' graphs: random senders and receivers, random node
    inputs, one-hot node and edge targets."""
    rng = np.random.default_rng(seed)
    E = N * deg
    c = {"senders": rng.integers(0, N, size=E).astype(np.int32),
         "receivers": rng.integers(0, N, size=E).astype(np.int32),
         "nf": rng.normal(size=(N, vocab)).astype(np.float32),
         "ef": None, "gf": None}
    if targets:
        c["y_nf"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, N)]
        c["y_ef"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, E)]
    return c


def _jax_graph(c):
    N, E = c["nf"].shape[0], c["senders"].shape[0]
    return gn.GraphsTuple(
        senders=jnp.asarray(c["senders"]),
        receivers=jnp.asarray(c["receivers"]),
        node_graph=jnp.zeros((N,), jnp.int32),
        edge_graph=jnp.zeros((E,), jnp.int32),
        n_node=jnp.array([N], jnp.int32), n_edge=jnp.array([E], jnp.int32),
        node_mask=jnp.ones((N,), bool), edge_mask=jnp.ones((E,), bool),
        graph_mask=jnp.ones((1,), bool), ef=None, nf=jnp.asarray(c["nf"]),
        gf=None)


def _port_graph(c):
    """The case's graph in canonical (receiver-sorted) edge order, and the
    order."""
    order = np.argsort(c["receivers"], kind="stable")
    N, E = c["nf"].shape[0], c["senders"].shape[0]
    t = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a))
    i32 = dict(dtype=torch.int32)
    return pt.GraphsTuple(
        senders=t(c["senders"][order]), receivers=t(c["receivers"][order]),
        node_graph=torch.zeros(N, **i32), edge_graph=torch.zeros(E, **i32),
        n_node=torch.tensor([N], **i32), n_edge=torch.tensor([E], **i32),
        node_mask=torch.ones(N, dtype=torch.bool),
        edge_mask=torch.ones(E, dtype=torch.bool),
        graph_mask=torch.ones(1, dtype=torch.bool),
        ef=None if c["ef"] is None else t(c["ef"][order]), nf=t(c["nf"]),
        gf=None if c["gf"] is None else t(c["gf"])[None]), order


def _epd_case(c, vocab, core, n_cores, key, pad=8, lr=1e-4, steps=0):
    model = EncodeProcessDecode(x_dims=(0, vocab, 0), core_dims=(core,) * 3,
                                y_dims=(2, 2, 0), n_cores=n_cores)
    opt = optax.adamw(lr)
    state = TrainState.create(model, opt, jax.random.PRNGKey(key))
    c = dict(c, tree=_np(state.params), x_dims=(0, vocab, 0),
             core_dims=(core,) * 3, y_dims=(2, 2, 0), n_cores=n_cores,
             pad=pad, lr=lr, steps=steps)
    return c, model, opt, state


def _jax_steps(c, model, opt, state, steps):
    g = _jax_graph(c)
    y = g.with_features(ef=jnp.asarray(c["y_ef"]),
                        nf=jnp.asarray(c["y_nf"]), gf=None)
    step = jax.jit(make_train_step(model, opt, loss_fn=graph_loss_nf_ef))
    losses = []
    for _ in range(steps):
        state, m = step(state, g, y)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _flat(_np(state.params))}


@pytest.fixture(scope="module")
def built():
    """The cases (numpy inputs and JAX's initial parameters) and the JAX
    objects their references need."""
    cases, refs = {}, {}
    for key, graph, args, kw in (
            ("fwd", (41, 48, 3, 12, False), (12, 16, 2, 42), {}),
            ("train", (43, 64, 4, 8), (8, 64, 2, 44), dict(steps=20)),
            ("kfwd", (61, 128, 6, 8, False), (8, 128, 1, 62),
             dict(pad=128)),
            ("ktrain", (71, 128, 6, 8), (8, 128, 1, 72),
             dict(pad=128, steps=3)),
            ("gate_off", (81, 64, 4, 8), (8, 128, 1, 82),
             dict(pad=128, steps=1))):
        cases[key], *refs[key] = _epd_case(_graph(*graph), *args, **kw)
    # GNCore / GNCoreList cases on a graph with all three feature sets.
    rng = np.random.default_rng(91)
    c = _graph(90, 48, 3, 16)
    c["ef"] = rng.normal(size=(48 * 3, 16)).astype(np.float32)
    c["gf"] = rng.normal(size=(16,)).astype(np.float32)
    c["y_nf"] = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 48)]
    c["y_ef"] = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 48 * 3)]
    dims = (16, 16, 16)
    c.update(dims=dims, lr=1e-3,
             tree=_np(gn.GNCore(dims).init(jax.random.PRNGKey(92))),
             list_tree=_np(gn.GNCoreList([gn.GNCore(dims)] * 2).init(
                 jax.random.PRNGKey(93))))
    cases["core"] = c
    return cases, refs


@pytest.fixture(scope="module")
def pending_ranks(built, tmp_path_factory):
    """Every multi-rank case on 4 spawned gloo ranks, started in a thread
    so that the JAX references are computed while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, rc.edge_partition_stack_cases, S,
                          str(tmp_path_factory.mktemp("ranks")), built[0],
                          device="cpu", timeout_s=300)


def _jax_partitioned_kernels(c, model, params):
    """JAX's partitioned model on its kernel route, as
    ``tests/test_parallel.py:776`` runs it but under ``jax.jit``: the
    Pallas kernels in interpret mode over 4 CPU devices.  ``(ef, nf)`` in the input order."""
    from jax.sharding import Mesh

    from graphnets_tpu.parallel.edge_partition import (build_halo_plan,
                                                       partition_edges)
    from graphnets_tpu.parallel.edge_partition_stack import \
        encode_process_decode_partitioned
    from graphnets_tpu.utils.config import enable_pallas
    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("graph",))
    pg = partition_edges(c["senders"], c["receivers"], c["nf"], num_shards=S,
                         edge_pad_multiple=c["pad"])
    enable_pallas(True, interpret=True)
    try:
        plan = build_halo_plan(pg)
        out = jax.jit(lambda p, g: encode_process_decode_partitioned(
            model, p, g, plan, mesh))(params, pg)
    finally:
        enable_pallas(False, interpret=False)
    return _rows([(np.asarray(out.ef)[s], np.asarray(out.nf)[s])
                  for s in range(S)], pg)


def _jax_core(c):
    """JAX's GNCore / GNCoreList forwards on the core case, and one
    ``make_train_step`` step of the GNCoreList."""
    g = _jax_graph(c).with_features(ef=jnp.asarray(c["ef"]),
                                    nf=jnp.asarray(c["nf"]),
                                    gf=jnp.asarray(c["gf"])[None])
    cores = gn.GNCoreList([gn.GNCore(c["dims"])] * 2)
    out = {}
    for key, model, tree in (("core", gn.GNCore(c["dims"]), c["tree"]),
                             ("core_list", cores, c["list_tree"])):
        y = model.apply(tree, g)
        out[key] = (np.asarray(y.ef), np.asarray(y.nf), np.asarray(y.gf))
    opt = optax.adamw(c["lr"])
    params = jax.tree_util.tree_map(jnp.asarray, c["list_tree"])
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(0))
    y = g.with_features(ef=jnp.asarray(c["y_ef"]), nf=jnp.asarray(c["y_nf"]),
                        gf=None)
    state, m = jax.jit(make_train_step(cores, opt))(state, g, y)
    out["core_list_step"] = {"loss": float(m["loss"]),
                             "params": _flat(_np(state.params))}
    return out


@pytest.fixture(scope="module")
def jax_side(built, pending_ranks):
    """The cases and the JAX package's outputs and trajectories: its
    unpartitioned model with Pallas off (eager forwards, as JAX's tests
    take their reference; jitted training steps), its partitioned model on
    the kernel route for ``kfwd``, and its GNCore / GNCoreList."""
    cases, refs = built
    want = {}
    for key, (model, opt, state) in refs.items():
        c = cases[key]
        if c["steps"]:
            want[key] = _jax_steps(c, model, opt, state, c["steps"])
        else:
            y = model.apply(state.params, _jax_graph(c))
            want[key] = (np.asarray(y.ef), np.asarray(y.nf))
    model, _, state = refs["kfwd"]
    want["kfwd_kernels"] = _jax_partitioned_kernels(cases["kfwd"], model,
                                                    state.params)
    want.update(_jax_core(cases["core"]))
    return cases, want


@pytest.fixture(scope="module")
def ranks(pending_ranks):
    return pending_ranks.result()


def _pg(c, shards=S):
    return ep.partition_edges(c["senders"], c["receivers"], c["nf"], shards,
                              ef=c["ef"], gf=c["gf"],
                              edge_pad_multiple=c.get("pad", 8),
                              device="cpu")


def _close(got, want, rtol, atol, what=""):
    """``|got - want| <= atol + rtol |want|`` elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert got.shape == want.shape and not (excess > 0).any(), (
        f"{what}: {int((excess > 0).sum())} of {excess.size} elements out "
        f"of bound, worst by {excess.max():.3e}")


def _rows(got, pg):
    """Every rank's rows in the input order: ``(ef [E], nf [N])``."""
    nm = np.asarray(pg.node_mask).reshape(-1)
    nf = np.concatenate([g[1] for g in got])[nm]
    n_edges = int((pg.edge_index >= 0).sum())
    ef = np.empty((n_edges,) + got[0][0].shape[1:], got[0][0].dtype)
    for s, g in enumerate(got):
        ei = pg.edge_index[s]
        k = int((ei >= 0).sum())
        ef[ei[:k]] = g[0][:k]
    return ef, nf


def _check_rows(got, pg, ref, rtol, atol):
    """Every rank's rows against ``ref = (ef, nf)`` (edges in the input
    order)."""
    for i, (a, r) in enumerate(zip(_rows(got, pg), ref)):
        _close(a, r, rtol, atol, ("ef", "nf")[i])


def _port_model(c, kernels=False):
    """The port's unpartitioned model on the case's graph, ``(ef, nf)`` in
    the input order."""
    model = rc._epd(c)
    g, order = _port_graph(c)
    enable_kernels(kernels)
    try:
        with torch.no_grad():
            y = model(g)
    finally:
        enable_kernels(False)
    ef = np.empty_like(y.ef.numpy())
    ef[order] = y.ef.numpy()
    return ef, y.nf.numpy()


def _port_steps(c, steps, kernels=False):
    """The port's unpartitioned ``make_train_step`` from the same
    parameters: the losses and the parameters after ``steps``."""
    model = rc._epd(c)
    g, order = _port_graph(c)
    y = g.with_features(ef=torch.from_numpy(c["y_ef"][order]),
                        nf=torch.from_numpy(c["y_nf"]), gf=None)
    step = pt.make_train_step(model, pt.adamw(model.parameters(), c["lr"]))
    enable_kernels(kernels)
    try:
        losses = [float(step(g, y)["loss"]) for _ in range(steps)]
    finally:
        enable_kernels(False)
    return {"losses": losses, "params": rc._numpy(model)}


def _check_trajectory(got, want, loss_tol, param_tol, steps=None):
    """Losses (rtol ``loss_tol``, atol 1e-6; the first ``steps`` only,
    when given) and parameters (``param_tol = (rtol, atol)``)."""
    _close(got["losses"][:steps], want["losses"][:steps], loss_tol, 1e-6,
           "losses")
    for n, ref in want["params"].items():
        _close(got["params"][n], ref, *param_tol, n)


# The 20-step case's trajectory has one step that amplifies f32
# summation-order noise: from step 16 on, two summation orders of the same
# model part by up to ~6e-4 of the loss, JAX's from JAX's and the port's
# from the port's (``test_stack_training_drift_is_order_noise``).
# The losses before it are held to JAX's at JAX's tolerance; all 20 are
# held to the port's unpartitioned losses at JAX's tolerance and to JAX's
# at ``LOSS_CAP``, a fixed bound 2.5 times the largest drift measured.
DRIFT_FROM = 16
LOSS_CAP = 2e-3


def _reordered(c, seed):
    """The case's graph with its edges in another order: the same model,
    other summation orders within each receiver's sum."""
    p = np.random.default_rng(seed).permutation(len(c["senders"]))
    return dict(c, senders=c["senders"][p], receivers=c["receivers"][p],
                y_ef=c["y_ef"][p])


def _drift(a, b):
    return np.abs(np.subtract(a, b)) / np.abs(b)


def test_stack_forward_matches_unpartitioned(jax_side, ranks):
    """``tests/test_parallel.py:481``: EncodeProcessDecode (encoder, 2
    cores, decoder) over 4 shards, against JAX's and the port's
    unpartitioned model."""
    cases, want = jax_side
    c = cases["fwd"]
    got = [r["fwd"] for r in ranks]
    _check_rows(got, _pg(c), want["fwd"], 2e-4, 2e-5)
    _check_rows(got, _pg(c), _port_model(c), 2e-4, 2e-5)


def test_stack_training_matches_unpartitioned(jax_side, ranks):
    """``tests/test_parallel.py:516``: 20 AdamW steps over 4 shards, loss
    trajectory and parameters, against JAX's and the port's unpartitioned
    ``make_train_step`` (see ``DRIFT_FROM``); every rank ends with the same
    parameters."""
    cases, want = jax_side
    c, jx = cases["train"], want["train"]
    port = _port_steps(c, 20)
    _close(port["losses"], jx["losses"], LOSS_CAP, 1e-6, "port vs JAX")
    for r in ranks:
        _check_trajectory(r["train"], jx, 5e-4, (1e-4, 1e-4), DRIFT_FROM)
        _close(r["train"]["losses"], jx["losses"], LOSS_CAP, 1e-6, "losses")
        _check_trajectory(r["train"], port, 5e-4, (1e-4, 1e-4))
        for n, p in r["train"]["params"].items():
            np.testing.assert_array_equal(p, ranks[0]["train"]["params"][n])


def test_stack_training_drift_is_order_noise(built, jax_side):
    """The witness for ``DRIFT_FROM``: JAX's and the port's unpartitioned
    steps on the same graph with its edges in another order, a change of
    summation order only, agree with their own to JAX's 5e-4 before step
    16 and part most from step 16 on, as the port parts from JAX; every
    drift stays under ``LOSS_CAP``."""
    cases, want = jax_side
    c, jx = cases["train"], want["train"]
    model, opt, state = built[1]["train"]
    port = _port_steps(c, 20)["losses"]
    drifts = {
        "JAX reordered vs JAX": _drift(_jax_steps(
            _reordered(c, 2), model, opt, state, 20)["losses"], jx["losses"]),
        "port reordered vs port": _drift(
            _port_steps(_reordered(c, 2), 20)["losses"], port),
        "port vs JAX": _drift(port, jx["losses"])}
    for what, d in drifts.items():
        print(f"{what:24s}", np.array2string(d, precision=1))
        assert d[:DRIFT_FROM].max() < 5e-4, what
        assert d.argmax() >= DRIFT_FROM and d.max() < LOSS_CAP, what


def test_stack_kernel_route_forward(jax_side, ranks):
    """``tests/test_parallel.py:776``: kernels on (plain versions on the
    CPU), dims 128, pads to 128: the single-graph edge update with its
    sum in the core, ``sorted_gather_add`` in the encoder, the fused FFN on
    the edge and node sets; equal to JAX's partitioned model on its kernel
    route (Pallas in interpret mode) and to the port's unpartitioned model
    on the kernel route."""
    cases, want = jax_side
    c = cases["kfwd"]
    pg = _pg(c)
    from graphnets_tpu_torch.ops.kernels.edge_update_g1 import \
        supports_g1_edge_update
    Epad, npad = pg.receivers_local.shape[1], pg.nodes_per_shard
    assert supports_g1_edge_update(Epad, npad + ((32 - npad % 32) or 32),
                                   128, 128, 4, with_agg=True)
    for r in ranks:
        assert r["kfwd_routes"] == {"fused_g1_edge_update_agg": 1,
                                    "sorted_gather_add": 1,
                                    "ln_ffn_residual": 2,
                                    "ln_ffn_residual_reference": 1}
    got = [r["kfwd"] for r in ranks]
    _check_rows(got, pg, want["kfwd_kernels"], 2e-4, 2e-5)
    _check_rows(got, pg, _port_model(c, kernels=True), 2e-4, 2e-5)


def test_stack_kernel_route_training(jax_side, ranks):
    """``tests/test_parallel.py:589``: 3 training steps with kernels on,
    the single-graph edge update's sum fused under training (its backward
    included) and the FFN row gate on shard rows (every set composed),
    against JAX's pure steps and the port's unpartitioned steps on the
    kernel route, at JAX's tolerances."""
    cases, want = jax_side
    port = _port_steps(cases["ktrain"], 3, kernels=True)
    for r in ranks:
        assert r["ktrain_routes"] == {"fused_g1_edge_update_agg": 3,
                                      "sorted_gather_add": 3,
                                      "ln_ffn_residual_reference": 9}
        _check_trajectory(r["ktrain"], want["ktrain"], 2e-4, (2e-3, 2e-4))
        _check_trajectory(r["ktrain"], port, 2e-4, (2e-3, 2e-4))


def test_stack_training_agg_gate_off(jax_side, ranks):
    """``tests/test_parallel.py:849``: ``g1_agg_fusion_training`` off
    sends the partitioned core to the composed route (``sorted_gather_add``
    and ``ln_matmul``) under training, over 2 shards; one step equals JAX's
    pure step and the port's unpartitioned step."""
    from graphnets_tpu_torch.utils.config import get_config
    cases, want = jax_side
    get_config().g1_agg_fusion_training = False
    try:
        port = _port_steps(cases["gate_off"], 1, kernels=True)
    finally:
        get_config().g1_agg_fusion_training = True
    for r in ranks:
        assert r["gate_off_routes"] == {"sorted_gather_add": 2,
                                        "ln_matmul": 1,
                                        "ln_ffn_residual_reference": 3}
        _close(r["gate_off"]["losses"], want["gate_off"]["losses"], 2e-4,
               1e-6)
        _close(r["gate_off"]["losses"], port["losses"], 2e-4, 1e-6)


def test_core_entry_points_match_unpartitioned(jax_side, ranks):
    """``gn_core_partitioned``, ``gn_core_list_partitioned`` and one
    ``make_partitioned_core_list_train_step`` step over 4 shards, with all
    three feature sets, against JAX's and the port's unpartitioned GNCore /
    GNCoreList and ``make_train_step``.  ``gf`` comes from pools over the
    whole graph and is held to rtol times its largest magnitude."""
    cases, want = jax_side
    c = cases["core"]
    pg = _pg(c)
    g, order = _port_graph(c)
    core = pt.from_jax_params(c["tree"], pt.GNCore(c["dims"], device="cpu"))
    cores = pt.from_jax_params(c["list_tree"], pt.GNCoreList(
        [pt.GNCore(c["dims"], device="cpu") for _ in range(2)]))
    for key, module in (("core", core), ("core_list", cores)):
        with torch.no_grad():
            y = module(g)
        ef = np.empty_like(y.ef.numpy())
        ef[order] = y.ef.numpy()
        got = [r[key] for r in ranks]
        for ref in (want[key], (ef, y.nf.numpy(), y.gf.numpy())):
            _check_rows(got, pg, ref[:2], 2e-4, 2e-5)
            for r in got:
                _close(r[2], ref[2], 0, 2e-5 + 2e-4 * np.abs(ref[2]).max(),
                       "gf")
    yt = g.with_features(ef=torch.from_numpy(c["y_ef"][order]),
                         nf=torch.from_numpy(c["y_nf"]), gf=None)
    loss = float(pt.make_train_step(cores, pt.adamw(cores.parameters(),
                                                    c["lr"]))(g, yt)["loss"])
    port = {"loss": loss, "params": rc._numpy(cores)}
    for r in ranks:
        got = r["core_list_step"]
        for ref in (want["core_list_step"], port):
            _close(got["loss"], ref["loss"], 2e-4, 1e-6, "loss")
            for n, p in ref["params"].items():
                _close(got["params"][n], p, 1e-4, 1e-4, n)


def test_one_process_step_matches_make_train_step(jax_side):
    """Without a mesh (S = 1) the partitioned step is the unpartitioned
    ``make_train_step``: 5 steps against the port's and JAX's, and it runs
    no collective."""
    from graphnets_tpu_torch.parallel import _comm
    cases, want = jax_side
    c = cases["train"]
    model = rc._epd(c)
    pg = _pg(c, 1)
    plan = ep.build_halo_plan(pg)
    y = ep.partition_edges(c["senders"], c["receivers"], c["y_nf"], 1,
                           ef=c["y_ef"], edge_pad_multiple=8, device="cpu")
    step = eps.make_partitioned_train_step(
        model, pt.adamw(model.parameters(), c["lr"]), plan)
    before = _comm.COLLECTIVES
    got = {"losses": [float(step(pg, y.nf, y.ef)["loss"])
                      for _ in range(5)], "params": rc._numpy(model)}
    assert _comm.COLLECTIVES == before
    _check_trajectory(got, _port_steps(c, 5), 5e-5, (1e-5, 1e-5))
    _close(got["losses"], want["train"]["losses"][:5], 5e-4, 1e-6, "losses")


def test_partitioned_loss_is_the_global_masked_mean(jax_side):
    """``partitioned_loss_nf_ef`` on the stacked layout of one process
    equals JAX's on the same arrays."""
    from graphnets_tpu.parallel.edge_partition import \
        PartitionedGraph as JaxPG
    from graphnets_tpu.parallel.edge_partition_stack import \
        partitioned_loss_nf_ef as jax_loss
    cases, _ = jax_side
    c = cases["train"]
    pg = _pg(c, 1)
    y = ep.partition_edges(c["senders"], c["receivers"], c["y_nf"], 1,
                           ef=c["y_ef"], edge_pad_multiple=8, device="cpu")
    rng = np.random.default_rng(5)
    logits_nf = rng.normal(size=tuple(y.nf.shape)).astype(np.float32)
    logits_ef = rng.normal(size=tuple(y.ef.shape)).astype(np.float32)
    pred = pg.replace(nf=torch.from_numpy(logits_nf),
                      ef=torch.from_numpy(logits_ef))
    got = float(eps.partitioned_loss_nf_ef(pred, y.nf, y.ef))
    jpred = JaxPG(jnp.asarray(pg.senders_global.numpy()),
                  jnp.asarray(pg.receivers_local.numpy()),
                  jnp.asarray(pg.edge_mask.numpy()),
                  jnp.asarray(pg.node_mask.numpy()), jnp.asarray(logits_nf),
                  jnp.asarray(logits_ef))
    want = float(jax_loss(jpred, jnp.asarray(y.nf.numpy()),
                          jnp.asarray(y.ef.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-6)
