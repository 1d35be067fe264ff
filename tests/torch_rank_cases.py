"""Rank functions of the port's multi-process tests.

``graphnets_tpu_torch.parallel.launch.run_ranks`` spawns each rank, which
imports the module of its function afresh; this module imports neither
JAX nor the JAX package, so a rank starts with torch and the port alone.
The tests (``tests/test_torch_parallel.py``, ``test_torch_pipeline.py``,
``test_torch_distributed.py``) build the JAX side and pass numpy trees and
arrays in; each function returns numpy results.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

import graphnets_tpu_torch as pt
from graphnets_tpu_torch.parallel import _comm
from graphnets_tpu_torch.parallel.data_parallel import (
    dp_batch_sharding, make_dp_train_step, shard_batch, shard_generator,
    stack_shards)
from graphnets_tpu_torch.parallel.distributed import init_distributed
from graphnets_tpu_torch.parallel.mesh import (make_mesh, replicated,
                                               sharded_leading)
from graphnets_tpu_torch.parallel.pipeline import PipelinedCoreList
from graphnets_tpu_torch.parallel.tensor_parallel import (param_shardings,
                                                          shard_params)

# The sort batches of tests/test_parallel.py (DP) and of
# __graft_entry__.py's DP x TP check.
DP_CFG = dict(vocab_size=6, min_nodes=2, max_nodes=3, batch_size=2)
TP_CFG = dict(vocab_size=16, min_nodes=2, max_nodes=4, batch_size=2)


def sort_shards(cfg_kw, seed, n):
    cfg = pt.SortTaskConfig(**cfg_kw)
    pad, rng = pt.sort_pad_spec(cfg), np.random.default_rng(seed)
    return [pt.get_batch(rng, cfg, pad, device="cpu") for _ in range(n)]


def dp_model(tree=None, dropout=0.0, seed=0):
    """The DP tests' model, ``(0, 6, 0) -> (8,)*3 -> (2, 2, 0)``, one
    core; JAX's parameters when ``tree`` is given."""
    model = pt.EncodeProcessDecode(
        (0, 6, 0), (8, 8, 8), (2, 2, 0), n_cores=1, dropout=dropout,
        device="cpu", generator=torch.Generator().manual_seed(seed))
    return model if tree is None else pt.from_jax_params(tree, model)


def tp_model(tree):
    """``__graft_entry__.py``'s DP x TP model."""
    return pt.from_jax_params(tree, pt.EncodeProcessDecode(
        (0, 16, 0), (32, 32, 32), (2, 2, 0), n_cores=2, device="cpu"))


def _numpy(module):
    return {n: p.detach().numpy().copy()
            for n, p in module.named_parameters()}


def _stacked(shards):
    return (stack_shards([s[0] for s in shards]),
            stack_shards([s[1] for s in shards]))


def parallel_cases(rank, world, dp_tree, tp_tree, dropout_seed):
    """Every multi-rank case of ``tests/test_torch_parallel.py`` on 4
    ranks."""
    out = {}
    # The meshes.
    mesh = make_mesh(device_type="cpu")
    mesh2 = make_mesh((2, 2), ("data", "model"), "cpu")
    out["mesh"] = (mesh.mesh_dim_names, tuple(mesh.shape),
                   mesh2.mesh_dim_names, tuple(mesh2.shape),
                   mesh2.get_local_rank("data"),
                   mesh2.get_local_rank("model"))
    out["placements"] = (repr(replicated(mesh2)),
                         repr(sharded_leading(mesh2, "model")),
                         repr(dp_batch_sharding(mesh2)(None)))
    errors = []
    for sizes in ((3,), (2, 3)):
        try:
            make_mesh(sizes, ("data", "model")[:len(sizes)], "cpu")
        except ValueError as e:
            errors.append(str(e))
    out["mesh_errors"] = errors
    if rank == 0:
        mesh4 = make_mesh((1, 4), ("data", "model"), "cpu")
        specs = lambda model, min_size: {
            n: repr(p) for n, p in param_shardings(model, mesh4,
                                                   min_size=min_size).items()}
        out["specs"] = {
            "gncore128": specs(pt.GNCore((128, 128, 128), device="cpu"),
                               1 << 12),
            "headline": specs(pt.EncodeProcessDecode(
                (0, 100, 0), (384, 384, 384), (2, 2, 0), device="cpu"),
                1 << 14)}
    else:
        make_mesh((1, 4), ("data", "model"), "cpu")

    # DP, SGD(1e-2), no dropout (tests/test_parallel.py:53).
    shards = sort_shards(DP_CFG, 1, 4)
    X, Y = _stacked(shards)
    x, y = shard_batch(X, mesh), shard_batch(Y, mesh)
    out["shard_senders"] = x.senders.numpy().copy()
    model = dp_model(dp_tree)
    step = make_dp_train_step(model, torch.optim.SGD(model.parameters(),
                                                     lr=1e-2), mesh)
    out["dp_loss"] = float(step(x, y)["loss"])
    out["dp_params"] = _numpy(model)

    # DP with dropout 0.5: this rank's masks and the step.
    shards = sort_shards(DP_CFG, 7, 4)
    X, Y = _stacked(shards)
    x, y = shard_batch(X, mesh), shard_batch(Y, mesh)
    model = dp_model(dropout=0.5, seed=5)
    gen = torch.Generator().manual_seed(dropout_seed)
    with torch.no_grad():
        out["dropout_nf"] = model(shards[0][0], training=True,
                                  generator=shard_generator(gen, rank)
                                  ).nf.numpy().copy()
    step = make_dp_train_step(model, torch.optim.SGD(model.parameters(),
                                                     lr=1e-2), mesh,
                              generator=gen)
    out["dropout_loss"] = float(step(x, y)["loss"])
    out["dropout_params"] = _numpy(model)

    # DP x TP over (data, model) = (2, 2), AdamW(1e-3)
    # (__graft_entry__.py:74-113).
    shards = sort_shards(TP_CFG, 0, 2)
    X, Y = _stacked(shards)
    x, y = shard_batch(X, mesh2), shard_batch(Y, mesh2)
    model = tp_model(tp_tree)
    full = {n: p.numel() for n, p in model.named_parameters()}
    shard_params(model, mesh2, axis="model", min_size=1 << 10)
    opt = pt.adamw(model.parameters(), 1e-3)
    step = make_dp_train_step(model, opt, mesh2, param_shardings=True)
    out["tp_loss"] = float(step(x, y)["loss"])
    out["tp_params"] = _numpy(model)
    out["tp_dims"] = dict(model.tensor_parallel.dims)
    out["tp_full"] = full
    out["tp_stored"] = {n: p.numel() for n, p in model.named_parameters()}
    out["tp_moments"] = {n: sum(v.numel() for k, v in opt.state[p].items()
                                if k in ("exp_avg", "exp_avg_sq"))
                         for n, p in model.named_parameters()}
    return out


def _micros(arrays, pad):
    """``pt.batch`` of each microbatch's numpy inputs."""
    return stack_shards([pt.batch(a, pad=pt.PadSpec(*pad), device="cpu")
                         for a in arrays])


def _pipe(tree, n_stages, dims):
    pipe = PipelinedCoreList([pt.GNCore(dims, device="cpu")
                              for _ in range(n_stages)], n_stages)
    for s in range(n_stages):
        pt.params.from_jax_stage_params(tree, pipe, s)
    return pipe


def _sq(out):
    return (out.nf.square().sum() + out.ef.square().sum()
            + out.gf.square().sum())


def pipeline_cases(rank, world, fwd, grad, small):
    """The cases of ``tests/test_torch_pipeline.py`` on 4 ranks: S = 4
    stages over M = 6 microbatches (forward); S = 2 over M = 5, the
    gradients of the sum of squares, and S = 2 over M = 3, the gradients of
    ``sum(nf ** 2)`` (the 2 x 2 mesh runs two pipelines side by side)."""
    out = {}
    mesh = make_mesh((4,), ("pipe",), "cpu")
    pipe = _pipe(fwd["tree"], 4, fwd["dims"])
    with torch.no_grad():
        y = pipe(_micros(fwd["arrays"], fwd["pad"]), mesh)
    out["fwd"] = [t.numpy().copy() for t in (y.ef, y.nf, y.gf)]

    mesh = make_mesh((2, 2), ("data", "pipe"), "cpu")
    sid = mesh.get_local_rank("pipe")
    for name, case, loss in (("grad", grad, _sq),
                             ("small", small,
                              lambda o: o.nf.square().sum())):
        pipe = _pipe(case["tree"], 2, case["dims"])
        value = loss(pipe(_micros(case["arrays"], case["pad"]), mesh))
        value.backward()
        out[name] = {
            "stage": sid, "loss": float(value.detach()),
            "grads": {n: p.grad.numpy().copy()
                      for n, p in pipe.stages[sid].named_parameters()},
            "others": [p.grad is None for s, st in enumerate(pipe.stages)
                       if s != sid for p in st.parameters()]}
    return out


def env_init_case(rank, world, port):
    """``init_distributed()`` from the launcher's environment variables:
    leave the launcher's group, initialise again from ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` and sum the ranks."""
    dist.destroy_process_group()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    ok = init_distributed(device="cpu", timeout_s=60)
    t = torch.tensor([float(rank + 1)])
    _comm.all_reduce_(t, dist.group.WORLD)
    return ok, dist.get_backend(), float(t)


# --- edge-partitioned graph parallelism -------------------------------------

def _np_out(out):
    """A partitioned output slice as numpy: ``(ef, nf, gf)``, ``None`` for
    an absent set."""
    f = lambda t: None if t is None else t.detach().numpy().copy()
    return (f(None if out.ef is None else out.ef[0]), f(out.nf[0]),
            f(out.gf))


def _partition(case, S, which="contiguous"):
    """The port's partition of a case's numpy graph (and its plan)."""
    from graphnets_tpu_torch.parallel import edge_partition as ep
    kw = dict(ef=case.get("ef"), gf=case.get("gf"),
              edge_pad_multiple=case.get("pad", 8), device="cpu")
    args = (case["senders"], case["receivers"], case["nf"], S)
    if which == "contiguous":
        pg = ep.partition_edges(*args, **kw)
    elif which == "locality":
        pg, _ = ep.partition_edges_locality(*args, **kw)
    else:
        pg, _ = ep.partition_edges_mincut(*args, **kw)
    return pg, ep.build_halo_plan(pg)


def _block(case):
    return pt.from_jax_params(case["tree"], pt.GNBlock(
        case["in_dims"], case["out_dims"], device="cpu"))


def _partial_grads(loss, module, mesh, axis="graph"):
    """The gradients of a loss that every rank of ``axis`` holds alike:
    seeded on coordinate 0, the partials summed over the axis."""
    coord = mesh.get_local_rank(axis)
    loss.backward(torch.tensor(1.0 if coord == 0 else 0.0))
    out = {}
    for n, p in module.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        _comm.all_reduce_(g, mesh.get_group(axis))
        out[n] = g.numpy()
    return out


def edge_partition_cases(rank, world, cases):
    """The multi-rank cases of ``tests/test_torch_edge_partition.py`` on 4
    ranks, a ``graph`` axis of 4: the v1 / v2 / v3 blocks, v1's
    gradients, the BFS and min-cut layouts under v2, and the three
    differentiable collectives."""
    from graphnets_tpu_torch.parallel import edge_partition as ep
    mesh = make_mesh((4,), ("graph",), "cpu")
    group = mesh.get_group("graph")
    out = {}
    c = cases["v1"]
    pg, _ = _partition(c, 4)
    with torch.no_grad():
        out["v1"] = _np_out(ep.gn_block_partitioned(_block(c), pg, mesh))
    c = cases["v2"]
    pg, plan = _partition(c, 4)
    with torch.no_grad():
        out["v2"] = {
            "v1": _np_out(ep.gn_block_partitioned(_block(c), pg, mesh)),
            "v2": _np_out(ep.gn_block_partitioned_halo(_block(c), pg, plan,
                                                       mesh))}
    out["v3"] = []
    for c in cases["v3"]:
        pg, plan = _partition(c, 4)
        with torch.no_grad():
            out["v3"].append({
                "v1": _np_out(ep.gn_block_partitioned(_block(c), pg, mesh)),
                "v3": _np_out(ep.gn_block_partitioned_overlap(
                    _block(c), pg, plan, mesh))})
    c = cases["grad"]
    pg, _ = _partition(c, 4)
    block = _block(c)
    y = ep.gn_block_partitioned(block, pg, mesh)
    local = torch.where(y.node_mask[0][:, None], y.nf[0], 0.0).square().sum()
    out["grad"] = _partial_grads(_comm.psum(local, group), block, mesh)
    for key, which in (("bfs", "locality"), ("mincut", "mincut")):
        c = cases[key]
        pg, plan = _partition(c, 4, which)
        with torch.no_grad():
            out[key] = _np_out(ep.gn_block_partitioned_halo(
                _block(c), pg, plan, mesh))
    # The collectives' gradients: y = op(x), loss = sum over ranks of
    # sum(w * y) with w and x known on every rank.
    r = float(rank)
    x = (torch.arange(24.0).reshape(4, 3, 2) + 100 * r).requires_grad_()
    w = torch.arange(24.0).reshape(4, 3, 2) * (r + 1)
    a2a = _comm.all_to_all_grad(x, group)
    (a2a * w).sum().backward()
    out["all_to_all"] = (a2a.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    ag = _comm.all_gather_grad(x[0], 0, group)        # [12, 2]
    (ag * w.reshape(12, 2)).sum().backward()
    out["all_gather"] = (ag.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    ps = _comm.psum(x, group)
    (ps * w).sum().backward()
    out["psum"] = (ps.detach().numpy(), x.grad.numpy().copy())
    return out


class count_routes:
    """Counts the calls of the kernel wrappers the partitioned blocks and
    stacks choose between (on the CPU they run their plain versions, so
    the launch counters stay at 0): a context manager that patches them
    where the partitioned modules look them up."""

    NAMES = (("edge_update_g1", "fused_g1_edge_update_agg"),
             ("gather", "sorted_gather_add"), ("ln_linear", "ln_matmul"))
    STACK = ("ln_ffn_residual", "ln_ffn_residual_reference")

    def __enter__(self):
        import importlib
        from graphnets_tpu_torch.parallel import edge_partition_stack as eps
        self.counts, self.saved = {}, []
        targets = [(importlib.import_module(
            f"graphnets_tpu_torch.ops.kernels.{m}"), n) for m, n in self.NAMES]
        targets += [(eps, n) for n in self.STACK]
        for mod, name in targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._counted(name, fn))
        return self.counts

    def _counted(self, name, fn):
        def run(*args, **kwargs):
            self.counts[name] = self.counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return run

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _epd(case):
    return pt.from_jax_params(case["tree"], pt.EncodeProcessDecode(
        case["x_dims"], case["core_dims"], case["y_dims"],
        n_cores=case["n_cores"], device="cpu"))


def _targets(case, S):
    """The partitioned targets: the partitioner run on them, as the JAX
    tests build ``pg_y``."""
    from graphnets_tpu_torch.parallel import edge_partition as ep
    pg_y = ep.partition_edges(case["senders"], case["receivers"],
                              case["y_nf"], S, ef=case["y_ef"],
                              edge_pad_multiple=case.get("pad", 8),
                              device="cpu")
    return pg_y.nf, pg_y.ef


def _train(case, S, mesh, steps):
    """``steps`` partitioned AdamW steps: the losses and the parameters."""
    from graphnets_tpu_torch.parallel import edge_partition_stack as eps
    model = _epd(case)
    pg, plan = _partition(case, S)
    step = eps.make_partitioned_train_step(
        model, pt.adamw(model.parameters(), case["lr"]), plan, mesh)
    y_nf, y_ef = _targets(case, S)
    losses = [float(step(pg, y_nf, y_ef)["loss"]) for _ in range(steps)]
    return {"losses": losses, "params": _numpy(model)}


def edge_partition_stack_cases(rank, world, cases):
    """The multi-rank cases of ``tests/test_torch_edge_partition_stack.py``
    on 4 ranks: the stack forward and 20 training steps over 4 shards, the
    kernel routes (plain versions) forward and training over 4 shards and
    with the single-graph sum off under training over 2 (a 2 x 2 ``(data,
    graph)`` mesh), and the GNCore / GNCoreList entry points."""
    from graphnets_tpu_torch.parallel import edge_partition_stack as eps
    from graphnets_tpu_torch.utils.config import enable_kernels, get_config
    mesh = make_mesh((4,), ("graph",), "cpu")
    out = {}
    c = cases["fwd"]
    pg, plan = _partition(c, 4)
    with torch.no_grad():
        out["fwd"] = _np_out(eps.encode_process_decode_partitioned(
            _epd(c), pg, plan, mesh))
    out["train"] = _train(cases["train"], 4, mesh, cases["train"]["steps"])

    enable_kernels(True)
    try:
        c = cases["kfwd"]
        pg, plan = _partition(c, 4)
        with count_routes() as routes, torch.no_grad():
            out["kfwd"] = _np_out(eps.encode_process_decode_partitioned(
                _epd(c), pg, plan, mesh))
        out["kfwd_routes"] = dict(routes)
        with count_routes() as routes:
            out["ktrain"] = _train(cases["ktrain"], 4, mesh,
                                   cases["ktrain"]["steps"])
        out["ktrain_routes"] = dict(routes)
        mesh2 = make_mesh((2, 2), ("data", "graph"), "cpu")
        get_config().g1_agg_fusion_training = False
        try:
            with count_routes() as routes:
                out["gate_off"] = _train(cases["gate_off"], 2, mesh2, 1)
            out["gate_off_routes"] = dict(routes)
        finally:
            get_config().g1_agg_fusion_training = True
    finally:
        enable_kernels(False)

    # The GNCore entry points, and a GNCoreList training step.
    c = cases["core"]
    pg, plan = _partition(c, 4)
    core = pt.from_jax_params(c["tree"], pt.GNCore(c["dims"], device="cpu"))
    cores = pt.from_jax_params(c["list_tree"], pt.GNCoreList(
        [pt.GNCore(c["dims"], device="cpu") for _ in range(2)]))
    with torch.no_grad():
        out["core"] = _np_out(eps.gn_core_partitioned(core, pg, plan, mesh))
        out["core_list"] = _np_out(eps.gn_core_list_partitioned(
            cores, pg, plan, mesh))
    step = eps.make_partitioned_core_list_train_step(
        cores, pt.adamw(cores.parameters(), c["lr"]), plan, mesh)
    y_nf, y_ef = _targets(c, 4)
    out["core_list_step"] = {"loss": float(step(pg, y_nf, y_ef)["loss"]),
                             "params": _numpy(cores)}
    return out
