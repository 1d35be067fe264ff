"""The port's edge partition (``graphnets_tpu_torch.parallel.edge_partition``)
against the JAX package's, on 4 gloo ranks of the CPU.

The partitioners and the halo plan run on the host in this process and
must be bit-equal to JAX's (every array, its dtype and its pad values).
The blocks run on a ``graph`` axis of 4 ranks spawned once for the file
(``tests/torch_rank_cases.py``, which imports no JAX); the JAX side runs
the cases of ``tests/test_parallel.py:94-223,306-514`` on 4 of the
conftest's 8 virtual CPU devices under ``jax.jit`` (the 8-shard cases at
4).  Tolerances: JAX's tests' (v1 against the unpartitioned block rtol
1e-4 / atol 1e-5, v2 and v3 against v1 rtol 1e-5 / atol 1e-5, gradients
rtol 2e-4 / atol 2e-5, the min-cut layout rtol 1e-4 / atol 1e-4), and the
same against JAX's partitioned outputs shard by shard.  The global
features ``gf``, computed from pools summed over the whole graph, are
held to rtol times their largest magnitude (see ``_check_pooled``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
import torch_rank_cases as rc
from graphnets_tpu.parallel import edge_partition as jep
from graphnets_tpu.parallel.mesh import make_mesh
from graphnets_tpu_torch.parallel import edge_partition as ep
from graphnets_tpu_torch.parallel.launch import run_ranks
from graphnets_tpu_torch.utils.config import (enable_debug_checks,
                                              enable_kernels)

S = 4


def _graph(seed, N, deg, dn, de, dg):
    rng = np.random.default_rng(seed)
    E = N * deg
    return {"senders": rng.integers(0, N, size=E).astype(np.int32),
            "receivers": rng.integers(0, N, size=E).astype(np.int32),
            "nf": rng.normal(size=(N, dn)).astype(np.float32),
            "ef": rng.normal(size=(E, de)).astype(np.float32),
            "gf": rng.normal(size=(dg,)).astype(np.float32)}


def _ring_graph():
    """``tests/test_parallel.py:312``: a ring lattice, labels scrambled."""
    rng = np.random.default_rng(41)
    N = 64
    base_s, base_r = [], []
    for v in range(N):
        for d in (1, 2):
            base_s += [v, (v + d) % N]
            base_r += [(v + d) % N, v]
    relabel = rng.permutation(N)
    senders = relabel[np.array(base_s)].astype(np.int32)
    receivers = relabel[np.array(base_r)].astype(np.int32)
    E = len(senders)
    return {"senders": senders, "receivers": receivers,
            "nf": rng.normal(size=(N, 5)).astype(np.float32),
            "ef": rng.normal(size=(E, 4)).astype(np.float32),
            "gf": rng.normal(size=(3,)).astype(np.float32)}


def _community_graph():
    """``tests/test_parallel.py:419``: 8 communities of 16 nodes, sparse
    links between them, labels scrambled."""
    rng = np.random.default_rng(7)
    C, NC = 8, 16
    N = C * NC
    senders, receivers = [], []
    for c in range(C):
        senders.append(rng.integers(0, NC, size=NC * 6) + c * NC)
        receivers.append(rng.integers(0, NC, size=NC * 6) + c * NC)
    senders = np.concatenate(senders + [rng.integers(0, N, size=40)])
    receivers = np.concatenate(receivers + [rng.integers(0, N, size=40)])
    perm = rng.permutation(N)
    senders, receivers = (perm[senders].astype(np.int32),
                          perm[receivers].astype(np.int32))
    return {"senders": senders, "receivers": receivers,
            "nf": rng.normal(size=(N, 6)).astype(np.float32),
            "ef": rng.normal(size=(len(senders), 4)).astype(np.float32),
            "gf": rng.normal(size=(3,)).astype(np.float32)}


def _jax_graph(c):
    N, E = c["nf"].shape[0], c["senders"].shape[0]
    return gn.GraphsTuple(
        senders=jnp.asarray(c["senders"]),
        receivers=jnp.asarray(c["receivers"]),
        node_graph=jnp.zeros((N,), jnp.int32),
        edge_graph=jnp.zeros((E,), jnp.int32),
        n_node=jnp.array([N], jnp.int32), n_edge=jnp.array([E], jnp.int32),
        node_mask=jnp.ones((N,), bool), edge_mask=jnp.ones((E,), bool),
        graph_mask=jnp.ones((1,), bool), ef=jnp.asarray(c["ef"]),
        nf=jnp.asarray(c["nf"]), gf=jnp.asarray(c["gf"])[None])


def _port_graph(c):
    """The case's graph for the port's unpartitioned block, edges in
    canonical (receiver-sorted) order; returns it and the order."""
    order = np.argsort(c["receivers"], kind="stable")
    N, E = c["nf"].shape[0], c["senders"].shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    i32 = dict(dtype=torch.int32)
    return pt.GraphsTuple(
        senders=t(c["senders"][order]), receivers=t(c["receivers"][order]),
        node_graph=torch.zeros(N, **i32), edge_graph=torch.zeros(E, **i32),
        n_node=torch.tensor([N], **i32), n_edge=torch.tensor([E], **i32),
        node_mask=torch.ones(N, dtype=torch.bool),
        edge_mask=torch.ones(E, dtype=torch.bool),
        graph_mask=torch.ones(1, dtype=torch.bool), ef=t(c["ef"][order]),
        nf=t(c["nf"]), gf=t(c["gf"])[None]), order


def _block_case(c, in_dims, out_dims, key):
    block = gn.GNBlock(in_dims, out_dims)
    params = block.init(jax.random.PRNGKey(key))
    return dict(c, tree=jax.tree_util.tree_map(np.asarray, params),
                in_dims=in_dims, out_dims=out_dims), block, params


def _stacked(out):
    return (None if out.ef is None else np.asarray(out.ef), np.asarray(out.nf),
            None if out.gf is None else np.asarray(out.gf))


@pytest.fixture(scope="module")
def jax_side(cpu_devices):
    """Every block case and JAX's outputs, on a 4-device ``graph`` mesh."""
    mesh = make_mesh((S,), ("graph",), devices=cpu_devices[:S])
    cases, want = {}, {}

    def part(c):
        pg = jep.partition_edges(c["senders"], c["receivers"], c["nf"], S,
                                 ef=c["ef"], gf=c["gf"], edge_pad_multiple=8)
        return pg, jep.build_halo_plan(pg)

    def v1(block, params, pg):
        return _stacked(jax.jit(lambda p, g: jep.gn_block_partitioned(
            block, p, g, mesh))(params, pg))

    def v2(block, params, pg, plan):
        return _stacked(jax.jit(lambda p, g, pl: jep.gn_block_partitioned_halo(
            block, p, g, pl, mesh))(params, pg, plan))

    def v3(block, params, pg, plan):
        return _stacked(jax.jit(
            lambda p, g, pl: jep.gn_block_partitioned_overlap(
                block, p, g, pl, mesh))(params, pg, plan))

    c, block, params = _block_case(_graph(3, 64, 4, 6, 5, 3), (5, 6, 3),
                                   (7, 8, 9), 4)
    cases["v1"] = c
    pg, _ = part(c)
    want["v1"] = {"v1": v1(block, params, pg),
                  "ref": _stacked(jax.jit(block.apply)(params,
                                                       _jax_graph(c)))}
    c, block, params = _block_case(_graph(11, 64, 4, 6, 5, 3), (5, 6, 3),
                                   (7, 8, 9), 12)
    cases["v2"] = c
    pg, plan = part(c)
    want["v2"] = {"v1": v1(block, params, pg),
                  "v2": v2(block, params, pg, plan)}
    cases["v3"], want["v3"] = [], []
    for out_dims in ((7, 8, 9), (2, 8, 9)):   # wide, and narrowing
        c, block, params = _block_case(_graph(21, 64, 4, 16, 5, 3),
                                       (5, 16, 3), out_dims, 12)
        cases["v3"].append(c)
        pg, plan = part(c)
        want["v3"].append({"v1": v1(block, params, pg),
                           "v3": v3(block, params, pg, plan)})
    c, block, params = _block_case(_graph(21, 32, 3, 4, 3, 2), (3, 4, 2),
                                   (5, 6, 7), 22)
    cases["grad"] = c
    g_full = _jax_graph(c)
    grads = jax.jit(jax.grad(
        lambda p: jnp.sum(block.apply(p, g_full).nf ** 2)))(params)
    want["grad"] = _flat_tree(jax.tree_util.tree_map(np.asarray, grads))
    c, block, params = _block_case(_ring_graph(), (4, 5, 3), (6, 7, 8), 42)
    cases["bfs"] = c
    want["bfs"] = _stacked(jax.jit(block.apply)(params, _jax_graph(c)))
    c, block, params = _block_case(_community_graph(), (4, 6, 3), (5, 7, 2),
                                   3)
    cases["mincut"] = c
    want["mincut"] = _stacked(jax.jit(block.apply)(params, _jax_graph(c)))
    return cases, want


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    return run_ranks(rc.edge_partition_cases, S,
                     str(tmp_path_factory.mktemp("ranks")), jax_side[0],
                     device="cpu", timeout_s=300)


def _port_pg(c, which="contiguous"):
    kw = dict(ef=c["ef"], gf=c["gf"], edge_pad_multiple=8, device="cpu")
    args = (c["senders"], c["receivers"], c["nf"], S)
    if which == "contiguous":
        return ep.partition_edges(*args, **kw), None
    if which == "locality":
        return ep.partition_edges_locality(*args, **kw)
    return ep.partition_edges_mincut(*args, **kw)


def _check_rows(got, pg, ref, rtol, atol, node_rows=None):
    """Rank ``s``'s rows (``got[s] = (ef, nf, gf)``) against the
    unpartitioned ``ref`` (edges in the input order): nodes through
    ``node_rows`` (new id -> old id; contiguous by default), edges through
    ``pg.edge_index``."""
    npad = pg.nodes_per_shard
    nm = pg.node_mask.numpy().reshape(-1)
    nf = np.concatenate([g[1] for g in got])
    mine, theirs = ((nm, slice(None)) if node_rows is None else node_rows)
    np.testing.assert_allclose(nf[mine], ref[1][theirs], rtol=rtol,
                               atol=atol)
    for s, g in enumerate(got):
        ei = pg.edge_index[s]
        k = int((ei >= 0).sum())
        np.testing.assert_allclose(g[0][:k], ref[0][ei[:k]], rtol=rtol,
                                   atol=atol)
        _check_pooled(g[2], ref[2], rtol, atol)
    assert npad * pg.num_shards == nf.shape[0]


def _as_stacked(got):
    """Every rank's ``(ef, nf, gf)`` as JAX's stacked outputs."""
    return (np.stack([g[0] for g in got]), np.stack([g[1] for g in got]),
            got[0][2])


def _new_of_old(pg, order, N):
    """New (shard-blocked) id of each old node of a relabelled partition
    (``tests/test_parallel.py:455-463``)."""
    npad = pg.nodes_per_shard
    nm = pg.node_mask.numpy()
    new_of_old = np.empty(N, np.int64)
    pos = 0
    for s in range(pg.num_shards):
        k = int(nm[s].sum())
        new_of_old[order[pos:pos + k]] = s * npad + np.arange(k)
        pos += k
    return new_of_old


def _check_pooled(got, want, rtol, atol):
    """``gf``: a function of sums over every edge and node, whose f32
    rounding scales with the pooled magnitudes, not with an element's
    own (an element that cancels to 0.13 among others of 127 differs by a
    few ulps of 127 between two summation orders): the tolerance is rtol
    times the largest magnitude, plus atol."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol + rtol * np.abs(want).max())


def _check_shards(got, want, pg, rtol, atol):
    """Rank ``s``'s rows against JAX's shard ``s`` (real slots)."""
    em = pg.edge_mask.numpy()
    nm = pg.node_mask.numpy()
    for s, g in enumerate(got):
        np.testing.assert_allclose(g[1][nm[s]], want[1][s][nm[s]],
                                   rtol=rtol, atol=atol)
        if want[0] is not None:
            np.testing.assert_allclose(g[0][em[s]], want[0][s][em[s]],
                                       rtol=rtol, atol=atol)
        _check_pooled(g[2], want[2], rtol, atol)


def _port_ref(c):
    """The port's unpartitioned block on the case's graph, edges back in
    the input order."""
    g, order = _port_graph(c)
    with torch.no_grad():
        y = rc._block(c)(g)
    ef = np.empty_like(y.ef.numpy())
    ef[order] = y.ef.numpy()
    return ef, y.nf.numpy(), y.gf.numpy()


# --- host partitioners: bit-equal to JAX's -----------------------------------

def _pairs(jpg, ppg):
    for f in ("senders_global", "receivers_local", "edge_mask", "node_mask",
              "nf", "ef", "gf"):
        a, b = getattr(jpg, f), getattr(ppg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            yield f, np.asarray(a), b.numpy()
    yield "edge_index", jpg.edge_index, ppg.edge_index


def _assert_bit_equal(jpg, ppg):
    for f, a, b in _pairs(jpg, ppg):
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        assert np.array_equal(a, b), f
    jplan, pplan = jep.build_halo_plan(jpg), ep.build_halo_plan(ppg)
    for f in ("send_idx", "send_mask", "sender_pos"):
        a, b = np.asarray(getattr(jplan, f)), getattr(pplan, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert jplan.halo_size == pplan.halo_size


@pytest.mark.parametrize("which", ["contiguous", "locality", "mincut",
                                   "assigned"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("num_shards", [1, 2, 3, 8])
def test_partitioners_bit_equal_jax(which, seed, num_shards):
    """Every array, dtype and pad value of each partitioner, and the halo
    plan built from it, equal JAX's; N = 50 does not divide by 3 or 8."""
    c = _graph(seed, 50, 4, 5, 3, 2)
    args = (c["senders"], c["receivers"], c["nf"], num_shards)
    kw = dict(ef=c["ef"], gf=c["gf"], edge_pad_multiple=8)
    if which == "contiguous":
        jpg = jep.partition_edges(*args, **kw)
        ppg = ep.partition_edges(*args, device="cpu", **kw)
    elif which == "assigned":
        assign = np.random.default_rng(seed + 10).integers(0, num_shards, 50)
        jpg, jo = jep.partition_edges_assigned(
            c["senders"], c["receivers"], c["nf"], assign, num_shards, **kw)
        ppg, po = ep.partition_edges_assigned(
            c["senders"], c["receivers"], c["nf"], assign, num_shards,
            device="cpu", **kw)
        assert np.array_equal(jo, po)
    else:
        jfn = getattr(jep, f"partition_edges_{which}")
        pfn = getattr(ep, f"partition_edges_{which}")
        jpg, jo = jfn(*args, **kw)
        ppg, po = pfn(*args, device="cpu", **kw)
        assert np.array_equal(jo, po) and jo.dtype == po.dtype
    _assert_bit_equal(jpg, ppg)


@pytest.mark.parametrize("start", [0, 17])
def test_bfs_node_order_bit_equal_jax(start):
    c = _community_graph()
    N = c["nf"].shape[0]
    want = jep.bfs_node_order(c["senders"], c["receivers"], N, start)
    got = ep.bfs_node_order(c["senders"], c["receivers"], N, start)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sorted(got.tolist()) == list(range(N))


def test_shard_slices_and_default_device():
    """``shard`` takes one shard (leading axis 1) and ``gf`` whole; the
    entry points run on the card unless the caller asks for the CPU."""
    c = _graph(0, 50, 4, 5, 3, 2)
    pg = ep.partition_edges(c["senders"], c["receivers"], c["nf"], 3,
                            ef=c["ef"], gf=c["gf"], edge_pad_multiple=8,
                            device="cpu")
    one = pg.shard(1, "cpu")
    assert one.num_shards == 1 and torch.equal(one.nf[0], pg.nf[1])
    assert torch.equal(one.gf, pg.gf)
    assert np.array_equal(one.edge_index[0], pg.edge_index[1])
    plan = ep.build_halo_plan(pg)
    assert torch.equal(plan.shard(2, "cpu").sender_pos[0], plan.sender_pos[2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ep.partition_edges(c["senders"], c["receivers"], c["nf"], 3)
        with pytest.raises(RuntimeError, match="CUDA"):
            pg.shard(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            ep.partition_edges_locality(c["senders"], c["receivers"],
                                        c["nf"], 3)


@pytest.mark.parametrize("name", ["edge_partition", "edge_partition_stack"])
def test_module_surface_matches_jax(name):
    """Each module exports JAX's names, plus the halo plan, v2 and the
    four partitioners."""
    jax_mod = importlib.import_module(f"graphnets_tpu.parallel.{name}")
    port = importlib.import_module(f"graphnets_tpu_torch.parallel.{name}")
    assert set(jax_mod.__all__) <= set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)
    if name == "edge_partition":
        assert {"HaloPlan", "build_halo_plan", "gn_block_partitioned_halo",
                "partition_edges_assigned", "partition_edges_mincut",
                "partition_edges_locality", "bfs_node_order"} <= set(
                    port.__all__)


# --- the blocks on 4 ranks ---------------------------------------------------

def test_v1_matches_jax_and_unpartitioned(jax_side, ranks):
    """``tests/test_parallel.py:94``: v1 over 4 shards."""
    cases, want = jax_side
    c = cases["v1"]
    pg, _ = _port_pg(c)
    got = [r["v1"] for r in ranks]
    _check_rows(got, pg, want["v1"]["ref"], 1e-4, 1e-5)
    _check_rows(got, pg, _port_ref(c), 1e-4, 1e-5)
    _check_shards(got, want["v1"]["v1"], pg, 1e-5, 1e-5)
    em = pg.edge_mask.numpy()
    for s in range(S):
        k = int((pg.edge_index[s] >= 0).sum())
        assert em[s, :k].all() and not em[s, k:].any()


def test_v2_matches_v1_and_jax(jax_side, ranks):
    """``tests/test_parallel.py:144``: the boundary all-to-all equals the
    all-gather."""
    cases, want = jax_side
    pg, _ = _port_pg(cases["v2"])
    v1 = [r["v2"]["v1"] for r in ranks]
    v2 = [r["v2"]["v2"] for r in ranks]
    _check_shards(v2, _as_stacked(v1), pg, 1e-5, 1e-5)
    _check_shards(v2, want["v2"]["v2"], pg, 1e-5, 1e-5)
    _check_shards(v1, want["v2"]["v1"], pg, 1e-5, 1e-5)


@pytest.mark.parametrize("i", [0, 1], ids=["wide", "narrowing"])
def test_v3_matches_v1_and_jax(i, jax_side, ranks):
    """``tests/test_parallel.py:352``: transform before exchange equals
    v1, also where the exchanged rows are narrower than the node rows."""
    cases, want = jax_side
    c = cases["v3"][i]
    pg, _ = _port_pg(c)
    v1 = [r["v3"][i]["v1"] for r in ranks]
    v3 = [r["v3"][i]["v3"] for r in ranks]
    _check_shards(v3, _as_stacked(v1), pg, 1e-5, 1e-5)
    _check_shards(v3, want["v3"][i]["v3"], pg, 1e-5, 1e-5)
    _check_rows(v3, pg, _port_ref(c), 1e-4, 1e-5)


def test_v1_gradients_match_jax_and_unpartitioned(jax_side, ranks):
    """``tests/test_parallel.py:181``: gradients through the all-gather
    and the pools' ``psum`` equal the unpartitioned block's, on every
    rank."""
    cases, want = jax_side
    c = cases["grad"]
    g, _ = _port_graph(c)
    block = rc._block(c)
    block(g).nf.square().sum().backward()
    port = {n: np.zeros(p.shape, np.float32) if p.grad is None
            else p.grad.numpy() for n, p in block.named_parameters()}
    for r in ranks:
        for n, ref in want["grad"].items():
            np.testing.assert_allclose(r["grad"][n], ref, rtol=2e-4,
                                       atol=2e-5, err_msg=n)
            np.testing.assert_allclose(r["grad"][n], port[n], rtol=2e-4,
                                       atol=2e-5, err_msg=n)


def test_bfs_layout_shrinks_halo_and_matches(jax_side, ranks):
    """``tests/test_parallel.py:306``: the BFS order shrinks the boundary
    set of a scrambled ring against contiguous blocks, and v2 on it equals
    the unpartitioned block (rows through ``order``)."""
    cases, want = jax_side
    c = cases["bfs"]
    pg_rand, _ = _port_pg(c)
    pg, order = _port_pg(c, "locality")
    assert (ep.build_halo_plan(pg).halo_size
            < ep.build_halo_plan(pg_rand).halo_size)
    got = [r["bfs"] for r in ranks]
    nm = pg.node_mask.numpy().reshape(-1)
    rows = (np.where(nm)[0], order)
    _check_rows(got, pg, want["bfs"], 1e-4, 1e-5, node_rows=rows)
    _check_rows(got, pg, _port_ref(c), 1e-4, 1e-5, node_rows=rows)


def test_mincut_layout_cuts_less_and_matches(jax_side, ranks):
    """``tests/test_parallel.py:399``: the refined assignment cuts fewer
    edges than its BFS-contiguous seed (here and at JAX's 8 shards),
    holds the balance cap, and v2 on it equals the unpartitioned block."""
    cases, want = jax_side
    c = cases["mincut"]
    N = c["nf"].shape[0]
    snd, rcv = c["senders"], c["receivers"]
    for shards in (S, 8):
        order = ep.bfs_node_order(snd, rcv, N)
        inv = np.empty_like(order)
        inv[order] = np.arange(N)
        block_sz = -(-N // shards)
        seed_assign = np.minimum(inv // block_sz, shards - 1)
        cut_seed = int(np.sum(seed_assign[snd] != seed_assign[rcv]))
        pg, order2 = ep.partition_edges_mincut(
            snd, rcv, c["nf"], shards, ef=c["ef"], gf=c["gf"],
            edge_pad_multiple=8, device="cpu")
        assign = _new_of_old(pg, order2, N) // pg.nodes_per_shard
        assert int(np.sum(assign[snd] != assign[rcv])) < cut_seed
        assert np.bincount(assign, minlength=shards).max() <= \
            int(1.05 * block_sz) + 1
    pg, order2 = _port_pg(c, "mincut")
    got = [r["mincut"] for r in ranks]
    rows = (_new_of_old(pg, order2, N), np.arange(N))
    _check_rows(got, pg, want["mincut"], 1e-4, 1e-4, node_rows=rows)
    _check_rows(got, pg, _port_ref(c), 1e-4, 1e-4, node_rows=rows)


@pytest.mark.parametrize("op", ["all_to_all", "all_gather", "psum"])
def test_collective_gradients(op, ranks):
    """The three differentiable collectives, forward and backward, on 4
    ranks: rank ``r`` holds ``x_r = arange + 100 r`` and adds ``sum(w_r *
    op(x)_r)`` to the loss, ``w_r = arange * (r + 1)``."""
    x = [np.arange(24.0).reshape(4, 3, 2) + 100 * r for r in range(S)]
    w = [np.arange(24.0).reshape(4, 3, 2) * (r + 1) for r in range(S)]
    for r, got in enumerate(ranks):
        y, dx = got[op]
        if op == "all_to_all":
            want_y = np.stack([x[s][r] for s in range(S)])
            want_dx = np.stack([w[s][r] for s in range(S)])
        elif op == "all_gather":
            want_y = np.concatenate([x[s][0] for s in range(S)])
            want_dx = np.zeros_like(x[r])
            want_dx[0] = sum(w[s].reshape(12, 2) for s in range(S))[
                3 * r:3 * r + 3]
        else:
            want_y = sum(x)
            want_dx = sum(w)
        np.testing.assert_array_equal(y, want_y)
        np.testing.assert_array_equal(dx, want_dx)


def test_one_process_blocks_match_unpartitioned():
    """Without a mesh (S = 1) every block equals the unpartitioned one, and
    the collectives run nothing."""
    from graphnets_tpu_torch.parallel import _comm
    c, _, _ = _block_case(_graph(5, 40, 4, 6, 5, 3), (5, 6, 3), (7, 8, 9), 1)
    pg = ep.partition_edges(c["senders"], c["receivers"], c["nf"], 1,
                            ef=c["ef"], gf=c["gf"], edge_pad_multiple=8,
                            device="cpu")
    plan = ep.build_halo_plan(pg)
    ref = _port_ref(c)
    block = rc._block(c)
    before = _comm.COLLECTIVES
    with torch.no_grad():
        for out in (ep.gn_block_partitioned(block, pg),
                    ep.gn_block_partitioned_halo(block, pg, plan),
                    ep.gn_block_partitioned_overlap(block, pg, plan)):
            _check_rows([rc._np_out(out)], pg, ref, 1e-4, 1e-5)
    assert _comm.COLLECTIVES == before


@pytest.mark.parametrize("kernels", [False, True])
def test_v3_layout_passes_debug_contracts(kernels):
    """The overflow-segment layout (pads on ``Npad``, receivers ascending)
    is what the sorted-pad-safe and sorted-gather contracts accept: v3 on
    both routes at dims 128 runs with the debug checks on, and equals the
    unpartitioned block."""
    c, _, _ = _block_case(_graph(6, 128, 6, 128, 128, 128), (128, 128, 128),
                          (128, 128, 128), 2)
    pg = ep.partition_edges(c["senders"], c["receivers"], c["nf"], 1,
                            ef=c["ef"], gf=c["gf"], edge_pad_multiple=128,
                            device="cpu")
    plan = ep.build_halo_plan(pg)
    enable_kernels(kernels)
    enable_debug_checks(True)
    try:
        with torch.no_grad():
            out = ep.gn_block_partitioned_overlap(rc._block(c), pg, plan)
    finally:
        enable_debug_checks(False)
        enable_kernels(False)
    _check_rows([rc._np_out(out)], pg, _port_ref(c), 1e-4, 1e-4)
