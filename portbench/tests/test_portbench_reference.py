"""The plain reference agrees with the port's pure route (kernels off) at
a tiny size of both configurations: the loss, every gradient and one
AdamW step.  This test imports both; the reference imports neither the
port nor JAX."""

import copy

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as port
from graphnets_tpu_torch.utils.config import get_config
from generators import single_graph, sort_host
from harness import spec
from models import gn as gn_model
from reference import gn as ref_gn
from reference.sort_task import sort_graphs

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def pure_route():
    cfg = get_config()
    saved = cfg.use_kernels
    cfg.use_kernels = False
    yield
    cfg.use_kernels = saved


def _models(config, seed=3):
    model = gn_model.build(port, config["model"], CPU)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    w0 = gn_model.make_weights(shapes, seed, CPU)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w0[n])
    return model, w0


def _sort_batch(seed=4):
    config = spec.cell("sort384.host_loop").config
    rng = np.random.default_rng(seed)
    samples = [sort_host.sample(rng, config["task"]) for _ in range(4)]
    pad = port.sort_pad_spec(port.SortTaskConfig())
    adjs = [s[2] for s in samples]
    x = port.batch({"graphs": adjs, "ef": None, "nf": [s[3] for s in samples],
                    "gf": None}, pad=pad, device="cpu")
    y = port.batch({"graphs": adjs, "ef": [s[5] for s in samples],
                    "nf": [s[4] for s in samples], "gf": None}, pad=pad,
                   device="cpu")
    rx, ry = sort_graphs([torch.from_numpy(s[1]) for s in samples],
                         config["task"]["vocab_size"], CPU)
    return config, x, y, rx, ry


def _graph_batch():
    config = copy.deepcopy(spec.cell("lg256.one_graph").config)
    config["feature_dtype"] = "float32"
    f = single_graph.Feed(port, config, {"num_nodes": 64, "num_edges": 512},
                          11, CPU)
    (rx, ry), = f.reference_batches(1)
    return config, f.x, f.y, rx, ry


def _compare(config, x, y, rx, ry, compute_dtype, tol):
    model, w0 = _models(config)
    opt = port.adamw(model.parameters(), 3e-4)
    step = port.make_train_step(model, opt, compute_dtype=compute_dtype)
    params = dict(model.named_parameters())
    loss = float(step(x, y)["loss"])
    grads = {n: p.grad.clone() for n, p in params.items()}

    p = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    ref_loss = ref_gn.loss(ref_gn.forward(p, rx, config["model"]), ry)
    ref_loss.backward()
    assert loss == pytest.approx(float(ref_loss.detach()), rel=tol)
    for n, q in p.items():
        if not q.numel():
            continue
        g = q.grad if q.grad is not None else torch.zeros_like(q)
        # By the 2-norm: one relu input within rounding of 0 takes the
        # other side on one route and moves one row's share of a weight's
        # gradient, which its largest element can show at 1e-2.
        scale = max(float(g.norm()), 1e-12)
        assert float((grads[n] - g).norm()) <= tol * scale, n
        with torch.no_grad():
            w = w0[n].clone()
            ref_gn.adamw_update(w, g, torch.zeros_like(w),
                                torch.zeros_like(w), 1, 3e-4)
        # A gradient element at rounding level may flip its sign, so the
        # parameters after the step agree to the step's size.
        moved = (params[n].detach() - w).abs()
        assert float(moved.max()) <= 2 * 3e-4 * (1 + 1e-4 * float(
            w0[n].abs().max())) + 1e-7, n
        assert float((moved > 1e-6).float().mean()) <= 0.02, n


def test_sort_recipe_agrees_with_the_pure_route():
    _compare(*_sort_batch(), compute_dtype=None, tol=1e-4)


def test_large_graph_agrees_with_the_pure_route():
    """In f32, so the semantics are held tight (bf16 rounding would set
    the tolerance).  The relu flips reach further here: a flipped row's
    input gradient flows to its neighbours through three cores, so the
    gradients of the first core's FFN move by up to ~4e-4 of their norm
    (the split-linear and the concatenated routes of the port itself
    differ so in f32, and agree to 1e-5 in f64)."""
    _compare(*_graph_batch(), compute_dtype=None, tol=2e-3)


@pytest.fixture
def one_thread():
    """One CPU thread: ``index_add`` sums in another order on more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["lg256.one_graph", "sort384.host_loop"])
def test_the_kinds_reference_is_gn_train(name, one_thread):
    """The harness reaches the ``gn`` kind's reference through
    ``cell.reference()``, and its readings (sound, control and planted
    fault) equal ``reference.gn.train``'s called directly, bit for bit."""
    from harness import runner
    cell = spec.cell(name)
    if cell.traffic["generator"] == "single_graph":
        cell.traffic.update(num_nodes=256, num_edges=2048)
    assert cell.reference() is ref_gn
    s = runner.prepare(cell, 2 ** 31 + 77, CPU)
    runner.program_readings(s)
    runner.release(s)
    batches = s.feed.reference_batches(runner.CHECKED_STEPS)
    model = cell.config["model"]
    control = "tf32" if cell.config["compute_dtype"] == "float32" else "fp8"
    for precision, keep in (("f32", None), (control, None),
                            ("f32", ref_gn.half_batch)):
        via = runner.reference_readings(s, batches, precision, keep)
        direct = ref_gn.train(s.w0, batches, model, s.lr, precision, keep)
        assert via == direct, (precision, keep)
