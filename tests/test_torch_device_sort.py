"""The sort flagship as the JAX package runs it by default, in the port:
``device_batch`` (draws + layout), ``train_sort_device``, ``evaluate_sort``
and the ``capture_step`` paths they take, against ``graphnets_tpu`` on the
CPU.

torch cannot reproduce ``jax.random``'s bits, so where the two packages
must see the same batches the tests draw ``n`` and ``values`` exactly as
JAX's ``device_batch`` does (``jax.random.split`` of the key, then the two
``randint``s) and hand those draws to the port's layout, by patching
``sort_task.sort_draws``.  Tolerances, each with its reason:

* the layout: every array bit-equal to JAX's ``device_batch(key)``, both
  layouts (integer index arithmetic and one-hots: no rounding at all);
* five f32 steps on the pure route: the chunk's mean loss 1e-5 relative,
  every parameter 1e-5 of its tensor's largest magnitude (the same f32
  sums in another order, through five AdamW updates);
* one bf16 step: the loss 1e-2 relative and each gradient within 5e-2 of
  its largest magnitude (the bf16 rule of the port's training tests: a
  bf16 ulp that flips a relu moves a gradient by far more than f32 noise);
* ``evaluate_sort``: the accuracies equal to 1e-6 (a mean of the same
  per-batch fractions, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu.data import sort_task as j_sort
from graphnets_tpu.models.encode_process_decode import \
    EncodeProcessDecode as JaxEncodeProcessDecode
from graphnets_tpu.training import losses as jl
from graphnets_tpu.training.train import TrainState as JaxTrainState
from graphnets_tpu.training.train import evaluate_sort as j_evaluate_sort
from graphnets_tpu.training.train import make_train_step as j_train_step
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu.utils.debug import validate_graph as j_validate_graph
from graphnets_tpu_torch.data import sort_task as p_sort
from graphnets_tpu_torch.training import train as p_train
from graphnets_tpu_torch.utils import config as pt_config

LR = 3e-4
_ARRAYS = ("nf", "ef", "senders", "receivers", "node_graph", "edge_graph",
           "n_node", "n_edge", "node_mask", "edge_mask", "graph_mask")


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pure_route():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(False)
    pt.enable_kernels(False)
    yield
    enable_pallas(old[0], interpret=old[1])
    pt_config.get_config().use_kernels = old_pt


def _jax_draws(key, cfg):
    """The draws of JAX's ``device_batch(key, cfg)``, as torch tensors."""
    kn, kv = jax.random.split(key)
    n = jax.random.randint(kn, (cfg.batch_size,), cfg.min_nodes,
                           cfg.max_nodes + 1, dtype=jnp.int32)
    v = jax.random.randint(kv, (cfg.batch_size, cfg.max_nodes), 1,
                           cfg.vocab_size + 1, dtype=jnp.int32)
    return torch.from_numpy(np.array(n)), torch.from_numpy(np.array(v))


def _feed_draws(monkeypatch, keys, cfg):
    """Make the port's ``sort_draws`` return JAX's draws for ``keys`` in
    order; returns the list of keys left."""
    left = list(keys)

    def draws(generator, c):
        assert c == cfg
        return _jax_draws(left.pop(0), cfg)

    monkeypatch.setattr(p_sort, "sort_draws", draws)
    return left


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _models(cfg, dims, n_cores, seed):
    """The port's sort model initialised from ``seed``, and JAX's sort
    model with a ``TrainState`` holding the same numbers (an AdamW state
    and the rng ``TrainState.create`` would give; JAX's own init, op by op
    on the CPU, costs seconds)."""
    model_p = pt.EncodeProcessDecode(
        (0, cfg.vocab_size, 0), dims, (2, 2, 0), n_cores=n_cores,
        device="cpu", generator=torch.Generator().manual_seed(seed))
    model_j = JaxEncodeProcessDecode((0, cfg.vocab_size, 0), dims,
                                     (2, 2, 0), n_cores=n_cores)
    flat = _flat(pt.to_numpy_tree(model_p))

    def fill(tree, prefix=""):   # JAX's tree keeps the empty dropout dicts
        return {k: fill(v, f"{prefix}{k}.") if isinstance(v, dict)
                else jnp.asarray(flat[f"{prefix}{k}"])
                for k, v in tree.items()}

    params = fill(jax.eval_shape(model_j.init, jax.random.PRNGKey(0)))
    state = JaxTrainState(
        params=params, opt_state=optax.adamw(LR).init(params),
        step=jnp.zeros((), jnp.int32),
        rng=jax.random.split(jax.random.PRNGKey(seed))[1])
    return model_j, state, model_p


# -- the layout ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_layout_is_bit_equal_to_jax_device_batch(seed, uniform, dtype):
    jdt, pdt = ((None, None) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    cj, cp = j_sort.SortTaskConfig(), p_sort.SortTaskConfig()
    key = jax.random.PRNGKey(seed)
    pair_j = j_sort.device_batch(key, cj, j_sort.sort_pad_spec(cj, uniform),
                                 dtype=jdt)
    pair_p = p_sort.sort_layout(*_jax_draws(key, cj), cp,
                                p_sort.sort_pad_spec(cp, uniform), pdt)
    for gj, gp in zip(pair_j, pair_p):
        assert gp.slot_shape == gj.slot_shape
        assert gp.pad_aliases_real == gj.pad_aliases_real
        assert gp.homogeneous == gj.homogeneous and gp.gf is None
        for name in _ARRAYS:
            a, b = getattr(gj, name), getattr(gp, name)
            assert (a is None) == (b is None), name
            if a is None:
                continue
            a = np.asarray(a)
            if b.dtype == torch.bfloat16:
                assert a.dtype == jnp.bfloat16, name
                a, b = a.astype(np.float32), b.float()
            b = b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _check_host_semantics(x, y, cfg):
    """The invariants of ``tests/test_device_data.py`` on a port batch:
    JAX's ``validate_graph`` and the port's; one-hot inputs; "is minimum"
    node targets; the full graph in canonical column-major order; edge
    targets equal to the host generator's; clean padding."""
    for g in (x, y):
        pt.validate_graph(g)
        j_validate_graph(g)  # reads the index arrays through numpy
    B = cfg.batch_size
    n_node, n_edge = x.n_node.numpy(), x.n_edge.numpy()
    assert (n_node[:B] >= cfg.min_nodes).all()
    assert (n_node[:B] <= cfg.max_nodes).all()
    assert (n_edge[:B] == n_node[:B] ** 2).all()
    nf, ynf, yef = _np(x.nf), _np(y.nf), _np(y.ef)
    s, r = x.senders.numpy(), x.receivers.numpy()
    if x.slot_shape is None:
        noff = np.concatenate([[0], np.cumsum(n_node[:B])])
        eoff = np.concatenate([[0], np.cumsum(n_edge[:B])])
    else:
        noff = np.arange(B + 1) * x.slot_shape[0]
        eoff = np.arange(B + 1) * x.slot_shape[1]
    for b in range(B):
        n = int(n_node[b])
        rows = slice(noff[b], noff[b] + n)
        vals = nf[rows].argmax(-1) + 1
        assert (nf[rows].sum(-1) == 1).all()
        np.testing.assert_array_equal(ynf[rows].argmax(-1),
                                      (vals == vals.min()).astype(int))
        edges = slice(eoff[b], eoff[b] + n * n)
        k = np.arange(n * n)
        np.testing.assert_array_equal(r[edges] - noff[b], k // n)
        np.testing.assert_array_equal(s[edges] - noff[b], k % n)
        np.testing.assert_array_equal(yef[edges].argmax(-1),
                                      p_sort._edge_targets(vals))
    em, nm = x.edge_mask.numpy(), x.node_mask.numpy()
    assert (nf[~nm] == 0).all()
    assert (np.diff(r) >= 0).all()
    if x.slot_shape is None:
        N = int(nm.sum())
        assert (s[~em] == N).all() and (r[~em] == N).all()


@pytest.mark.parametrize("uniform", [False, True])
def test_device_batch_keeps_the_host_generator_semantics(uniform):
    cfg = p_sort.SortTaskConfig()
    gen = torch.Generator().manual_seed(11)
    pad = p_sort.sort_pad_spec(cfg, uniform)
    for _ in range(4):
        _check_host_semantics(*p_sort.device_batch(gen, cfg, pad), cfg)


def test_device_batch_draws_from_its_generator():
    """Sizes cover [min, max] as the reference's rand(2:10); a generator's
    state gives the same batch again, and the next draw another one."""
    cfg = p_sort.SortTaskConfig()
    gen = torch.Generator().manual_seed(0)
    sizes = np.concatenate([p_sort.device_batch(gen, cfg)[0].n_node[
        :cfg.batch_size].numpy() for _ in range(64)])
    assert sizes.min() == cfg.min_nodes and sizes.max() == cfg.max_nodes
    start = gen.get_state()
    a, _ = p_sort.device_batch(gen, cfg)
    b, _ = p_sort.device_batch(gen, cfg)
    gen.set_state(start)
    c, _ = p_sort.device_batch(gen, cfg)
    assert torch.equal(a.nf, c.nf) and torch.equal(a.senders, c.senders)
    assert not torch.equal(a.nf, b.nf)


# -- the trainer --------------------------------------------------------------


def _jax_device_keys(seed, steps):
    """The batch keys of JAX's ``train_sort_device`` body: the state's rng
    splits once for the batch key and once in ``make_train_step``."""
    rng = jax.random.split(jax.random.PRNGKey(seed))[1]
    keys = []
    for _ in range(steps):
        rng, dk = jax.random.split(rng)
        keys.append(dk)
        rng = jax.random.split(rng)[0]
    return keys


def test_five_device_steps_match_jax(pure_route, monkeypatch):
    seed, steps, dims = 3, 5, (32, 32, 32)
    cj, cp = j_sort.SortTaskConfig(), p_sort.SortTaskConfig()
    model_j, state, model_p = _models(cj, dims, 2, seed)
    keys = _jax_device_keys(seed, steps)
    step_j = jax.jit(j_train_step(model_j, optax.adamw(LR)))
    pad = j_sort.sort_pad_spec(cj)
    losses = []
    for k in keys:
        state, m = step_j(state, *j_sort.device_batch(k, cj, pad))
        losses.append(float(m["loss"]))
    left = _feed_draws(monkeypatch, keys, cp)
    res = pt.train_sort_device(steps=steps, cfg=cp, chunk=steps,
                               learning_rate=LR, model=model_p,
                               device="cpu")
    assert not left
    np.testing.assert_allclose(res.metrics["loss"], np.mean(losses),
                               rtol=1e-5)
    new_j, new_p = _flat(state.params), _flat(pt.to_numpy_tree(model_p))
    top = max(np.abs(ref).max(initial=0.0) for ref in new_j.values())
    for name, ref in new_j.items():
        np.testing.assert_allclose(new_p[name], ref, rtol=0, atol=1e-5 * top,
                                   err_msg=name)


def test_bf16_step_casts_at_use_as_jax(pure_route):
    """One bf16 step on the same batch from the same params, with the
    LayerNorm parameters moved off 1 / 0 so that where the cast sits
    shows: the port's device loop keeps the f32 masters and feeds bf16
    features (each ``Linear`` casts its weight at use, ``LayerNorm`` runs
    in f32 with f32 parameters, as in JAX), which matches JAX; casting
    every parameter to bf16 for the forward (``make_train_step``'s
    ``compute_dtype``) rounds the LayerNorm parameters too and lands
    further from JAX's loss."""
    cj, cp = j_sort.SortTaskConfig(), p_sort.SortTaskConfig()
    dims = (32, 32, 32)
    model_j, state, _ = _models(cj, dims, 1, 5)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    flat = _flat(params)

    def perturb(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, f"{path}{k}.")
            elif k in ("scale", "bias") and v.size:
                base = 1.0 if k == "scale" else 0.0
                tree[k] = (base + 0.3 * rng.standard_normal(v.shape)
                           ).astype(np.float32)
    perturb(params)
    assert any(not np.array_equal(a, _flat(params)[n])
               for n, a in flat.items())
    key = jax.random.PRNGKey(7)
    xj, yj = j_sort.device_batch(key, cj, j_sort.sort_pad_spec(cj),
                                 dtype=jnp.bfloat16)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    # Jitted with every bf16 rounding kept, as op-by-op execution and the
    # port's eager ops keep them (XLA's fusions may otherwise drop some).
    grad_fn = jax.jit(jax.value_and_grad(lambda p: jl.graph_loss_nf_ef(
        model_j.apply(p, xj, training=True), yj)))
    loss_j, grads_j = grad_fn.lower(jparams).compile(
        {"xla_allow_excess_precision": False})(jparams)
    grads_j = _flat(grads_j)
    xp, yp = p_sort.sort_layout(*_jax_draws(key, cp), cp, None,
                                torch.bfloat16)

    def port_step(compute_dtype):
        model = pt.EncodeProcessDecode((0, cp.vocab_size, 0), dims,
                                       (2, 2, 0), n_cores=1, device="cpu")
        pt.from_jax_params(params, model)
        step = pt.make_train_step(model, pt.adamw(model.parameters(), LR),
                                  compute_dtype=compute_dtype)
        return float(step(xp, yp)["loss"]), model

    loss_p, model_p = port_step(None)
    loss_all, _ = port_step(torch.bfloat16)
    err = abs(loss_p - float(loss_j))
    assert err <= 1e-2 * abs(float(loss_j)), (loss_p, float(loss_j))
    assert err < abs(loss_all - float(loss_j)), (loss_p, loss_all,
                                                 float(loss_j))
    for name, p in model_p.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        ref = grads_j[name]
        if ref.size:
            np.testing.assert_allclose(_np(p.grad), ref, rtol=0,
                                       atol=5e-2 * np.abs(ref).max() + 1e-12,
                                       err_msg=name)


def test_train_sort_device_chunks_and_throughput(monkeypatch):
    """Whole chunks (7 steps at chunk 3 run 9), one log line a chunk with
    the chunk's mean metrics, the state's step count, a throughput that
    leaves the first chunk out, and the captured step's bookkeeping on the
    CPU (eager: no capture, no replay)."""
    cfg = p_sort.SortTaskConfig(batch_size=2)
    logged, seen = [], []
    real = p_train.make_train_step

    def spy(*a, **k):
        step = real(*a, **k)

        def wrapped(x, y):
            out = step(x, y)
            seen.append({n: float(v) for n, v in out.items()})
            return out
        return wrapped

    monkeypatch.setattr(p_train, "make_train_step", spy)
    res = pt.train_sort_device(steps=7, cfg=cfg, core_dims=(16, 16, 16),
                               n_cores=1, chunk=3, seed=2, device="cpu",
                               log_fn=lambda s, m: logged.append((s, m)))
    assert [s for s, _ in logged] == [3, 6, 9] and len(seen) == 9
    assert res.state.step == 9 and res.metrics == logged[-1][1]
    for i, (_, m) in enumerate(logged):
        for k, v in m.items():
            want = np.mean([s[k] for s in seen[3 * i:3 * i + 3]])
            assert v == pytest.approx(want, rel=1e-6), k
    assert res.steps_per_sec > 0
    assert isinstance(res.step, pt.CapturedStep)
    assert res.step.captures == res.step.replays == 0
    assert isinstance(res.optimizer, torch.optim.AdamW)
    # One chunk in all: nothing left to time.
    one = pt.train_sort_device(steps=2, cfg=cfg, core_dims=(16, 16, 16),
                               n_cores=1, chunk=2, device="cpu")
    assert one.steps_per_sec == 0.0 and one.state.step == 2


def test_train_sort_device_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is honoured there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.train_sort_device(steps=1, chunk=1, core_dims=(8, 8, 8))


def test_evaluate_sort_matches_jax(pure_route, monkeypatch):
    cj, cp = j_sort.SortTaskConfig(), p_sort.SortTaskConfig()
    model_j, state, model_p = _models(cj, (32, 32, 32), 1, 4)
    n_batches, seed = 4, 9
    acc_j = j_evaluate_sort(model_j, state.params, cj, n_batches=n_batches,
                            seed=seed)
    left = _feed_draws(monkeypatch,
                       list(jax.random.split(jax.random.PRNGKey(seed),
                                             n_batches)), cp)
    acc_p = pt.evaluate_sort(model_p, cp, n_batches=n_batches, seed=seed)
    assert not left
    assert set(acc_p) == {"node_acc", "edge_acc", "graph_acc"}
    for k, v in acc_j.items():
        assert acc_p[k] == pytest.approx(v, abs=1e-6), k


def test_sort_learns_on_the_device_loop():
    """A learning floor for the device loop, on the recipe of JAX's
    ``test_sort_graph_acc_floor_device_loop`` (vocab 16, 2-5 nodes, batch
    8, one core, lr 3e-3) cut from 1,500 steps at width 48 to 300 at width
    32 to fit the CPU budget.  So the floor is the one JAX's host-loop
    ``test_sort_learns`` sets after 150 steps (node and edge accuracy above
    0.75), looser than the device-loop test's 0.9 / 0.85 / graph 0.3,
    which needs its 1,500 steps."""
    cfg = p_sort.SortTaskConfig(vocab_size=16, min_nodes=2, max_nodes=5,
                                batch_size=8)
    res = pt.train_sort_device(steps=300, cfg=cfg, core_dims=(32, 32, 32),
                               n_cores=1, learning_rate=3e-3, seed=0,
                               chunk=100, device="cpu")
    ev = pt.evaluate_sort(res.model, cfg, n_batches=8)
    assert ev["node_acc"] > 0.75, ev
    assert ev["edge_acc"] > 0.75, ev
