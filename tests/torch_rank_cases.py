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
