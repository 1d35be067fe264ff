"""The port's sort task against graphnets_tpu's: the host data generator,
``EncodeProcessDecode``, one ``train_sort`` step, ``sort_accuracy`` and the
example script.

The same ``numpy.random.Generator`` seeds drive both packages' host
generators, so their batches are equal bit for bit; the JAX parameters are
copied into the port's model.  Everything runs in f32 on the CPU at a narrow
width (core dims 128, 2 cores, batch 4: N = 41, E = 512, G = 5, the sort
task's own pad), JAX with Pallas in interpret mode where kernels are on and
the port on its kernels' plain versions.  Tolerances, each with its reason:

* forward outputs: 1e-5 of the largest magnitude of each real feature set
  (the same f32 sums in another order);
* one training step: the loss 1e-5 relative; each gradient at rtol 1e-3
  and an absolute 1e-5 x max |ref grad| of its tensor (f32 sums over ~500
  rows taken in another order, whose rounding exceeds 1e-6 on entries near
  0: the rule of ``tests/test_torch_train.py``); the accuracies equal; the
  updated parameters within 2 lr + 1e-6 (Adam's first step is about
  lr * sign(g), and a gradient near 0 may flip sign).
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu.data import sort_task as j_sort
from graphnets_tpu.models.encode_process_decode import \
    EncodeProcessDecode as JaxEncodeProcessDecode
from graphnets_tpu.training import evaluate as j_eval
from graphnets_tpu.training import losses as jl
from graphnets_tpu.training.train import TrainState, make_train_step
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.data import sort_task as p_sort
from graphnets_tpu_torch.ops.kernels import fused_ffn as pt_ffn
from graphnets_tpu_torch.ops.kernels import gather as pt_ga
from graphnets_tpu_torch.ops.kernels import ln_linear as pt_ll
from graphnets_tpu_torch.utils import config as pt_config

REPO = Path(__file__).resolve().parents[1]
LR = 3e-4
D = 128
_ARRAYS = ("nf", "ef", "gf", "senders", "receivers", "node_graph",
           "edge_graph", "n_node", "n_edge", "node_mask", "edge_mask",
           "graph_mask")


@pytest.fixture(params=[True, False], ids=["kernels", "pure"])
def route(request):
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(request.param, interpret=request.param)
    pt.enable_kernels(request.param)
    yield request.param
    enable_pallas(old[0], interpret=old[1])
    pt_config.get_config().use_kernels = old_pt


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


def _close(out, ref, tol, what=""):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(out).all(), what
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30), \
        (what, np.abs(out - ref).max(), np.abs(ref).max())


def _models(seed, n_cores=2):
    """The JAX sort model at core dims D with its params, and the port's
    model holding the same numbers."""
    cfg = j_sort.SortTaskConfig()
    model_j = JaxEncodeProcessDecode((0, cfg.vocab_size, 0), (D, D, D),
                                     (2, 2, 0), n_cores=n_cores)
    params = model_j.init(jax.random.PRNGKey(seed))
    model_p = pt.EncodeProcessDecode((0, cfg.vocab_size, 0), (D, D, D),
                                     (2, 2, 0), n_cores=n_cores,
                                     device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, params), model_p)
    return model_j, params, model_p


# -- the host generator -------------------------------------------------------


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_get_batch_equals_jax_bit_for_bit(seed, uniform):
    cj, cp = j_sort.SortTaskConfig(), p_sort.SortTaskConfig()
    pad_j = j_sort.sort_pad_spec(cj, uniform=uniform)
    pad_p = p_sort.sort_pad_spec(cp, uniform=uniform)
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        pair_j = j_sort.get_batch(rj, cj, pad_j)
        pair_p = p_sort.get_batch(rp, cp, pad_p, device="cpu")
        for gj, gp in zip(pair_j, pair_p):
            assert gp.slot_shape == gj.slot_shape
            assert gp.pad_aliases_real == gj.pad_aliases_real
            for name in _ARRAYS:
                a, b = getattr(gj, name), getattr(gp, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                                  err_msg=name)
    if not uniform:
        assert (gp.num_node_slots, gp.num_edge_slots, gp.num_graph_slots) \
            == (41, 512, 5) and gp.slot_shape is None


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("cfg", [(100, 2, 10, 4), (50, 3, 7, 6),
                                 (100, 2, 16, 8)])
def test_sort_pad_spec_matches_jax(cfg, uniform):
    pj = j_sort.sort_pad_spec(j_sort.SortTaskConfig(*cfg), uniform=uniform)
    pp = p_sort.sort_pad_spec(p_sort.SortTaskConfig(*cfg), uniform=uniform)
    for name in ("num_nodes", "num_edges", "num_graphs"):
        assert getattr(pj, name) == getattr(pp, name), name
    assert getattr(pj, "uniform_slots", None) == \
        getattr(pp, "uniform_slots", None)


def test_gen_sample_matches_jax():
    rj, rp = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        sj = j_sort.gen_sample(rj, j_sort.SortTaskConfig())
        sp = p_sort.gen_sample(rp, p_sort.SortTaskConfig())
        for a, b in zip(sj, sp):
            np.testing.assert_array_equal(a, b)
    values = np.array([5, 3, 5, 1])
    np.testing.assert_array_equal(j_sort._edge_targets(values),
                                  p_sort._edge_targets(values))


def test_get_batch_runs_on_the_card_unless_asked():
    """No device argument means CUDA: without a card that raises instead of
    running on the CPU."""
    cfg = p_sort.SortTaskConfig()
    if torch.cuda.is_available():
        x, _ = p_sort.get_batch(np.random.default_rng(0), cfg)
        assert x.nf.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            p_sort.get_batch(np.random.default_rng(0), cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.train_sort(steps=1, core_dims=(8, 8, 8))


# -- EncodeProcessDecode ------------------------------------------------------


def test_encode_process_decode_parameter_tree_round_trips():
    """The port's names are the JAX tree's, zero-width slices included (the
    encoder's edge net has no edge input, the decoder no graph output)."""
    _, params, model_p = _models(1)
    flat_j = _flat(jax.tree_util.tree_map(np.asarray, params))
    named = dict(model_p.named_parameters())
    assert set(flat_j) == set(named)
    assert {n.split(".")[0] for n in named} == {"encoder", "core", "decoder"}
    assert {n.split(".")[1] for n in named if n.startswith("core.")} == \
        {"0", "1"}
    assert tuple(named["decoder.graphfn.w"].shape) == (2 + 2 + D, 0)
    assert tuple(named["decoder.graphfn.b"].shape) == (0,)
    assert tuple(named["encoder.edgefn.w"].shape) == (200, D)
    back = _flat(pt.to_numpy_tree(model_p))
    for n, a in flat_j.items():
        assert back[n].shape == a.shape, n
        np.testing.assert_array_equal(back[n], a, err_msg=n)
    assert pt.GNModel is pt.EncodeProcessDecode
    with pytest.raises(ValueError):
        pt.from_jax_params({"encoder": params["encoder"]}, model_p)


def test_encode_process_decode_forward_matches_jax(route, monkeypatch):
    cfg = j_sort.SortTaskConfig()
    model_j, params, model_p = _models(2)
    xj, _ = j_sort.get_batch(np.random.default_rng(5), cfg)
    xp, _ = p_sort.get_batch(np.random.default_rng(5),
                             p_sort.SortTaskConfig(), device="cpu")
    y_j = model_j.apply(params, xj)
    calls = {"ln_matmul_reference": 0, "sorted_gather_add_plain": 0,
             "ln_ffn_residual_plain": 0}
    for mod, name in ((pt_ll, "ln_matmul_reference"),
                      (pt_ga, "sorted_gather_add_plain"),
                      (pt_ffn, "ln_ffn_residual_plain")):
        def spy(*a, _real=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    with torch.no_grad():
        y_p = model_p(xp)
    # With kernels on each core's edge row completes in ln_matmul; 41 node
    # slots are neither a multiple of 32 (no deferred gather) nor of 8 (no
    # fused FFN).  The encoder and decoder have no LN term.
    assert calls == {"ln_matmul_reference": 2 if route else 0,
                     "sorted_gather_add_plain": 0,
                     "ln_ffn_residual_plain": 0}
    assert y_j.gf is None and y_p.gf is None
    assert tuple(y_p.nf.shape) == (41, 2) and tuple(y_p.ef.shape) == (512, 2)
    for key, mask in (("ef", xj.edge_mask), ("nf", xj.node_mask)):
        m = np.asarray(mask)
        _close(_np(getattr(y_p, key))[m], _np(getattr(y_j, key))[m], 1e-5,
               key)


def _assert_update_matches(name, old, new_p, new_j, gref, flip_below):
    """AdamW's first step moves a weight by about LR against the sign of
    its gradient, so the two packages' new parameters agree to f32
    rounding (1e-6) wherever the gradients' signs must agree: where
    ``|gref|`` exceeds ``flip_below``, the most the two gradients may
    differ by.  There the port's parameter must also have moved by at
    least LR / 2.  Entries below may flip sign and are held to 2 LR.
    Returns the number of entries held to 1e-6 and the total."""
    np.testing.assert_allclose(new_p, new_j, rtol=0, atol=2 * LR + 1e-6,
                               err_msg=name)
    firm = np.abs(gref) > flip_below
    assert np.abs(new_p - new_j)[firm].max(initial=0.0) <= 1e-6, name
    assert np.abs(new_p - old)[firm].min(initial=LR) >= 0.5 * LR, name
    return int(firm.sum()), firm.size


# -- the trainer --------------------------------------------------------------


def test_train_sort_step_matches_jax(route, monkeypatch):
    seed = 11
    cfg = j_sort.SortTaskConfig()
    model_j, params, model_p = _models(seed)
    opt = optax.adamw(LR)
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=np.zeros((), np.int32),
                       rng=jax.random.PRNGKey(1))
    xj, yj = j_sort.get_batch(np.random.default_rng(seed), cfg)
    old = _flat(params)
    grads_j = _flat(jax.grad(lambda p: jl.graph_loss_nf_ef(
        model_j.apply(p, xj, training=True), yj))(params))
    state, metrics_j = make_train_step(model_j, opt)(state, xj, yj)
    new_j = _flat(state.params)

    calls = {"ln_matmul_reference": 0, "ln_linear_backward_plain": 0}
    for name in calls:
        def spy(*a, _real=getattr(pt_ll, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(pt_ll, name, spy)
    # train_sort draws its batches from default_rng(seed) as the JAX loop
    # does, so its first step sees the batch above.
    res = pt.train_sort(steps=1, cfg=p_sort.SortTaskConfig(),
                        core_dims=(D, D, D), n_cores=2, learning_rate=LR,
                        seed=seed, model=model_p, device="cpu")
    assert isinstance(res, pt.SortTrainResult) and res.model is model_p
    assert res.steps_per_sec == 0.0  # one step: nothing left to time
    n = 2 if route else 0
    assert calls == {"ln_matmul_reference": n, "ln_linear_backward_plain": n}
    assert set(res.metrics) == {"loss", "node_acc", "edge_acc", "graph_acc"}
    np.testing.assert_allclose(res.metrics["loss"], float(metrics_j["loss"]),
                               rtol=1e-5)
    for k in ("node_acc", "edge_acc", "graph_acc"):
        assert res.metrics[k] == pytest.approx(float(metrics_j[k]), abs=1e-6)
    new_p = _flat(pt.to_numpy_tree(model_p))
    firm = total = 0
    for name, p in model_p.named_parameters():
        gref = grads_j[name]
        assert tuple(p.grad.shape) == gref.shape, name
        if not gref.size:
            continue
        atol = 1e-5 * np.abs(gref).max() + 1e-12
        np.testing.assert_allclose(_np(p.grad), gref, rtol=1e-3, atol=atol,
                                   err_msg=name)
        # A gradient within rtol 1e-3 and this atol keeps its sign above
        # twice the atol.
        n, size = _assert_update_matches(name, old[name], new_p[name],
                                         new_j[name], gref, 2 * atol + 1e-7)
        firm, total = firm + n, total + size
    assert firm >= 0.9 * total, (firm, total)


def test_train_sort_trains_and_reports_throughput():
    """A few steps at a tiny width, on the port's own seeded init: finite
    metrics, a throughput that leaves the first step out, parameters that
    moved, and the same run again gives the same numbers."""
    cfg = p_sort.SortTaskConfig(batch_size=2)
    runs = [pt.train_sort(steps=4, cfg=cfg, core_dims=(16, 16, 16),
                          n_cores=1, seed=3, device="cpu")
            for _ in range(2)]
    res = runs[0]
    assert res.steps_per_sec > 0
    assert all(np.isfinite(v) for v in res.metrics.values())
    assert runs[0].metrics == runs[1].metrics
    fresh = pt.EncodeProcessDecode((0, 100, 0), (16, 16, 16), (2, 2, 0),
                                   n_cores=1, device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    moved = [not torch.equal(a, b) for a, b in zip(
        fresh.parameters(), res.model.parameters()) if a.numel()]
    assert all(moved)
    assert isinstance(res.optimizer, torch.optim.AdamW)
    assert res.optimizer.defaults["weight_decay"] == 1e-4


def test_sort_accuracy_matches_jax(route):
    cfg = j_sort.SortTaskConfig()
    model_j, params, model_p = _models(4)
    acc_j = j_eval.sort_accuracy(model_j, params, cfg, num_batches=3, seed=9)
    acc_p = pt.sort_accuracy(model_p, p_sort.SortTaskConfig(), num_batches=3,
                             seed=9)
    assert set(acc_p) == {"node_acc", "edge_acc", "graph_acc"}
    for k, v in acc_j.items():
        assert acc_p[k] == pytest.approx(float(v), abs=1e-9), k
    assert 0.0 < acc_p["edge_acc"] < 1.0


def test_sort_example_script_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "examples/sort_torch.py", "--steps", "3",
         "--core-dim", "16", "--n-cores", "1", "--log-every", "1",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for piece in ("step 3: loss=", "final metrics:", "throughput:",
                  "values:", "is_min pred:", "edge-matrix match:"):
        assert piece in out.stdout, (piece, out.stdout[-2000:])


def test_train_sort_follows_jax_over_several_steps():
    """Three steps on the pure route from the same parameters and the same
    generator seed: the optimizer state and the batch sequence carry over
    as in the JAX loop.  The third step's loss is held to 1e-3 relative:
    it follows two AdamW updates whose first is about lr * sign(g), so an
    f32 rounding difference in a gradient near 0 moves a weight by up to
    2 lr."""
    old = (get_config().use_pallas, get_config().pallas_interpret)
    old_pt = pt_config.get_config().use_kernels
    enable_pallas(False)
    pt.enable_kernels(False)
    try:
        seed, steps = 5, 3
        cfg = j_sort.SortTaskConfig()
        model_j, params, model_p = _models(seed)
        opt = optax.adamw(LR)
        state = TrainState(params=params, opt_state=opt.init(params),
                           step=np.zeros((), np.int32),
                           rng=jax.random.PRNGKey(1))
        step_j = jax.jit(make_train_step(model_j, opt))
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            state, metrics_j = step_j(state, *j_sort.get_batch(rng, cfg))
        res = pt.train_sort(steps=steps, cfg=p_sort.SortTaskConfig(),
                            core_dims=(D, D, D), n_cores=2,
                            learning_rate=LR, seed=seed, model=model_p,
                            device="cpu")
    finally:
        enable_pallas(old[0], interpret=old[1])
        pt_config.get_config().use_kernels = old_pt
    assert res.steps_per_sec > 0
    np.testing.assert_allclose(res.metrics["loss"], float(metrics_j["loss"]),
                               rtol=1e-3)
    new_j, new_p = _flat(state.params), _flat(pt.to_numpy_tree(model_p))
    for name, ref in new_j.items():
        np.testing.assert_allclose(new_p[name], ref, rtol=0,
                                   atol=2 * steps * LR + 1e-6, err_msg=name)
