"""The port's pipeline (``graphnets_tpu_torch.parallel.pipeline``) against
the JAX package's ``PipelinedCoreList`` and the port's sequential stack,
on 4 gloo ranks of the CPU.

The ranks are spawned once for the file (``tests/torch_rank_cases.py``):
S = 4 stages over M = 6 microbatches (forward,
``tests/test_parallel.py:225``), and on a 2 x 2 ``(data, pipe)`` mesh two
S = 2 pipelines side by side over M = 5 microbatches (the gradients of
the sum of squares of every output, ``:671``) and over M = 3 (the
gradients of ``sum(nf ** 2)``, finite and non-zero, ``:263``).  JAX's
parameters go to each stage through ``params.from_jax_stage_params``.
Tolerances: JAX's tests' (forward rtol 1e-4 / atol 1e-5, gradients rtol
2e-4 / atol 1e-5); against the port's sequential ``GNCoreList`` on the
same inputs, 1e-5 of each tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt
import torch_rank_cases as rc
from graphnets_tpu.parallel.data_parallel import stack_shards
from graphnets_tpu.parallel.mesh import make_mesh
from graphnets_tpu.parallel.pipeline import PipelinedCoreList
from graphnets_tpu_torch.parallel.launch import run_ranks
from graphnets_tpu_torch.parallel.pipeline import \
    PipelinedCoreList as PortPipelinedCoreList


def _arrays(rng, M, dims, sizes):
    """M microbatches' numpy inputs: graphs of ``sizes`` nodes, complete
    adjacency."""
    d = dims[0]
    out = []
    for _ in range(M):
        out.append({
            "graphs": [np.ones((n, n), int) for n in sizes],
            "ef": [rng.normal(size=(n * n, d)).astype(np.float32)
                   for n in sizes],
            "nf": [rng.normal(size=(n, d)).astype(np.float32)
                   for n in sizes],
            "gf": rng.normal(size=(len(sizes), d)).astype(np.float32)})
    return out


def _case(key, seed, S, M, dims, sizes, pad):
    pipe = PipelinedCoreList(tuple(gn.GNCore(dims) for _ in range(S)),
                             num_stages=S)
    params = pipe.init(jax.random.PRNGKey(key))
    arrays = _arrays(np.random.default_rng(seed), M, dims, sizes)
    stacked = stack_shards([gn.batch(a, pad=gn.PadSpec(*pad))
                            for a in arrays])
    return pipe, params, stacked, {
        "tree": jax.tree_util.tree_map(np.asarray, params), "dims": dims,
        "arrays": arrays, "pad": pad}


@pytest.fixture(scope="module")
def cases(cpu_devices, tmp_path_factory):
    """The three cases, JAX's results and the ranks' (4 spawned ranks)."""
    fwd_pipe, fwd_params, fwd_x, fwd = _case(31, 30, 4, 6, (6, 6, 6),
                                             (3, 2), (8, 16, 3))
    mesh4 = make_mesh((4,), ("pipe",), devices=cpu_devices[:4])
    # Under jit: JAX's pipeline runs op by op otherwise (~45 s a gradient).
    out = jax.jit(lambda p: fwd_pipe.apply(p, fwd_x, mesh4))(fwd_params)
    fwd["jax"] = [np.asarray(t) for t in (out.ef, out.nf, out.gf)]

    mesh2 = make_mesh((2,), ("pipe",), devices=cpu_devices[:2])
    grad_pipe, grad_params, grad_x, grad = _case(53, 54, 2, 5, (4, 4, 4),
                                                 (3, 2), (8, 16, 3))

    def loss_sq(p):
        o = grad_pipe.apply(p, grad_x, mesh2)
        return (jnp.sum(o.nf ** 2) + jnp.sum(o.ef ** 2)
                + jnp.sum(o.gf ** 2))
    grad["jax"] = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_sq))(grad_params))

    small_pipe, small_params, small_x, small = _case(33, 34, 2, 3,
                                                     (4, 4, 4), (2,),
                                                     (4, 8, 2))
    small["jax"] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        lambda p: jnp.sum(small_pipe.apply(p, small_x, mesh2).nf ** 2)))(
        small_params))
    strip = lambda c: {k: v for k, v in c.items() if k != "jax"}
    ranks = run_ranks(rc.pipeline_cases, 4,
                      str(tmp_path_factory.mktemp("ranks")),
                      strip(fwd), strip(grad), strip(small), device="cpu",
                      timeout_s=300)
    return {"fwd": fwd, "grad": grad, "small": small, "ranks": ranks}


def _amax(a):
    return np.abs(a).max(initial=1e-30)


def _close(got, ref, what):
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max(initial=0.0) <= 1e-5 * _amax(ref), what


def _port_pipe(case):
    """The port's pipeline module on one process, with JAX's parameters
    (for its ``sequential()`` stack)."""
    S = len(case["tree"]["0"]["block"]["edgefn"]["w"])
    pipe = PortPipelinedCoreList(
        [pt.GNCore(case["dims"], device="cpu") for _ in range(S)], S)
    for s in range(S):
        pt.params.from_jax_stage_params(case["tree"], pipe, s)
    micros = [pt.batch(a, pad=pt.PadSpec(*case["pad"]), device="cpu")
              for a in case["arrays"]]
    return pipe, micros


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_pipeline_forward_matches_jax_and_sequential(cases):
    """S = 4, M = 6: every stage returns the stacked outputs of JAX's
    ``PipelinedCoreList.apply`` and of the sequential ``GNCoreList``."""
    fwd = cases["fwd"]
    pipe, micros = _port_pipe(fwd)
    seq = pipe.sequential()
    with torch.no_grad():
        outs = [seq(g) for g in micros]
    for r, got in enumerate(cases["ranks"]):
        for i, name in enumerate(("ef", "nf", "gf")):
            np.testing.assert_allclose(got["fwd"][i], fwd["jax"][i],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {name}")
            for m, o in enumerate(outs):
                _close(got["fwd"][i][m], getattr(o, name).numpy(),
                       f"rank {r} {name} micro {m}")


def _sequential_grads(case, loss_of):
    """The gradients of the same loss through the port's sequential stack,
    by stage and name."""
    pipe, micros = _port_pipe(case)
    seq = pipe.sequential()
    sum(loss_of(seq(g)) for g in micros).backward()
    # A parameter the loss does not reach has a zero gradient, as in JAX.
    return [{n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
             else p.grad.numpy() for n, p in st.named_parameters()}
            for st in pipe.stages]


def _sq(o):
    return o.nf.square().sum() + o.ef.square().sum() + o.gf.square().sum()


@pytest.mark.parametrize("which", ["grad", "small"])
def test_pipeline_gradients_match_jax_and_sequential(cases, which):
    """S = 2: each rank's stage gradients against ``jax.grad`` of JAX's
    pipeline (M = 5, every output squared, and M = 3, ``sum(nf ** 2)``) and
    against the port's sequential stack; the other stage's parameters get
    no gradient on that rank."""
    case = cases[which]
    loss_of = _sq if which == "grad" else (lambda o: o.nf.square().sum())
    seq = _sequential_grads(case, loss_of)
    for r, got in enumerate(cases["ranks"]):
        got = got[which]
        s = got["stage"]
        assert s == r % 2 and all(got["others"])
        want = _flat(jax.tree_util.tree_map(lambda x: x[s], case["jax"]))
        assert set(got["grads"]) == set(want) == set(seq[s])
        for n, g in got["grads"].items():
            np.testing.assert_allclose(g, want[n], rtol=2e-4, atol=1e-5,
                                       err_msg=f"rank {r} {n}")
            _close(g, seq[s][n], f"rank {r} {n}")


def test_pipeline_gradients_finite_and_nonzero(cases):
    """``tests/test_parallel.py:263``: every gradient finite, some
    non-zero, on both stages."""
    for got in cases["ranks"]:
        grads = list(got["small"]["grads"].values())
        assert all(np.isfinite(g).all() for g in grads)
        assert any(np.abs(g).sum() > 0 for g in grads)


def test_pipeline_stage_layout():
    """Stage ``s`` owns cores ``s*k .. s*k+k-1``; ``sequential()`` runs the
    same core modules in order; a core passed twice is copied; cores that
    do not divide into the stages are refused."""
    cores = [pt.GNCore((4, 4, 4), device="cpu") for _ in range(4)]
    pipe = PortPipelinedCoreList(cores, 2)
    assert pipe.cores_per_stage == 2
    assert list(pipe.stages[1].children()) == cores[2:]
    assert list(pipe.sequential().children()) == cores
    twice = PortPipelinedCoreList([cores[0]] * 2, 2)
    a, b = (next(st.children()) for st in twice.stages)
    assert a is not b and a.block.edgefn.w is not b.block.edgefn.w
    with pytest.raises(ValueError, match="divide"):
        PortPipelinedCoreList(cores[:3], 2)
