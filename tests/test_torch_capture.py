"""``capture_step`` (the port's ``jax.jit(step, donate_argnums=0)``) on the
CPU, where it runs the step eagerly: the eager step's results exactly; its
warm-up plus restore leaves the parameters, the optimizer's state (step
counts too) and the dropout generator bit-equal to an untouched copy's,
so that no warm-up step counts; the input structures that key its graphs;
the optimizers it can restore.  The captured graphs themselves run on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Also the
``capturable`` optimizer helpers, ``utils/warmup`` and the
node-classification example on an OGB-layout dataset."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu_torch.utils import warmup as pt_warmup
from graphnets_tpu_torch.utils.tree import map_tensors, structure, tensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sort_setup(dropout=0.0, seed=0):
    cfg = pt.SortTaskConfig()
    x, y = pt.get_batch(np.random.default_rng(seed), cfg, device="cpu")
    model = pt.EncodeProcessDecode((0, cfg.vocab_size, 0), (16,) * 3,
                                   (2, 2, 0), dropout=dropout, device="cpu")
    return x, y, model


def _state(opt):
    return [{k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in opt.state[p].items()}
            for g in opt.param_groups for p in g["params"]]


def _equal_models(a, b):
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


def _equal_states(sa, sb):
    assert len(sa) == len(sb)
    for a, b in zip(sa, sb):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_cpu_capture_step_gives_the_eager_results(dropout):
    x, y, model = _sort_setup(dropout)
    twin = copy.deepcopy(model)
    cap = pt.capture_step(pt.make_train_step(
        model, pt.adamw(model.parameters()),
        generator=torch.Generator().manual_seed(3)))
    eager = pt.make_train_step(twin, pt.adamw(twin.parameters()),
                               generator=torch.Generator().manual_seed(3))
    for _ in range(3):
        a, b = cap(x, y), eager(x, y)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        _equal_models(model, twin)
    _equal_states(_state(cap.optimizer), _state(eager.optimizer))
    assert cap.captures == cap.replays == cap.traced_calls == 0


def test_capture_key_resolves_the_auto_switch():
    """A fresh process's first call keys its graph as every later call
    does: the "auto" kernel switch is resolved before the key is read, so
    a step is captured once."""
    from graphnets_tpu_torch.utils import config
    x, y, model = _sort_setup()
    cap = pt.capture_step(pt.make_train_step(model,
                                             pt.adamw(model.parameters())))
    was = config.get_config().use_kernels
    try:
        pt.enable_kernels(None)
        first = cap._key((x, y))
        assert config.get_config().use_kernels is not None
        cap(x, y)
        assert cap._key((x, y)) == first
    finally:
        pt.enable_kernels(was)


def test_clear_drops_the_graphs():
    """``clear()`` drops every graph and the pool; the next call captures
    anew (on the CPU: runs eagerly, as before)."""
    x, y, model = _sort_setup()
    twin = copy.deepcopy(model)
    cap = pt.capture_step(pt.make_train_step(model,
                                             pt.adamw(model.parameters())))
    eager = pt.make_train_step(twin, pt.adamw(twin.parameters()))
    cap._graphs[("stale",)], cap._pool = object(), object()
    cap.clear()
    assert cap._graphs == {} and cap._pool is None
    assert torch.equal(cap(x, y)["loss"], eager(x, y)["loss"])
    _equal_models(model, twin)


@pytest.mark.parametrize("steps_before", [0, 2])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_warm_up_restores_the_state(dropout, steps_before):
    """Warm-up calls change nothing that a step would see: parameters,
    Adam's moments and step count (zeros, a fresh state, when no step ran
    before), and the dropout generator; the next step equals an untouched
    copy's bit for bit."""
    x, y, model = _sort_setup(dropout, seed=1)
    twin = copy.deepcopy(model)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    step = pt.make_train_step(model, pt.adamw(model.parameters()),
                              generator=gens[0])
    ref = pt.make_train_step(twin, pt.adamw(twin.parameters()),
                             generator=gens[1])
    for _ in range(steps_before):
        step(x, y)
        ref(x, y)
    cap = pt.capture_step(step)
    before = _state(step.optimizer)
    cap.warm_up(x, y)
    assert cap.traced_calls == pt.CapturedStep.WARMUP_CALLS
    _equal_models(model, twin)
    after = _state(step.optimizer)
    if steps_before:
        _equal_states(after, before)
    else:
        assert all(not before_p for before_p in before)
        assert all(not bool(v.any()) for st in after for v in st.values())
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    a, b = step(x, y), ref(x, y)
    assert torch.equal(a["loss"], b["loss"])
    _equal_models(model, twin)
    _equal_states(_state(step.optimizer), _state(ref.optimizer))


def test_capture_step_node_classification_on_the_cpu():
    rng = np.random.default_rng(2)
    n = 200
    g = pt.LargeGraph.from_coo(rng.integers(0, n, 1200),
                               rng.integers(0, n, 1200),
                               rng.normal(size=(n, 8)).astype(np.float32),
                               rng.integers(0, 3, n))
    b = pt.NeighborSampler(g, (3, 2), 8, seed=1, emit_node_ids=True,
                           device="cpu").sample(np.arange(8))
    feat = pt.device_feature_table(g, device="cpu")
    models = [pt.EncodeProcessDecode((0, 8, 0), (16,) * 3, (1, 3, 0),
                                     device="cpu") for _ in range(2)]
    steps = [pt.make_node_classification_step(m, pt.adam(m.parameters()), 3)
             for m in models]
    cap = pt.capture_step(steps[0])
    cap.warm_up(b.graph, b.node_ids, b.labels, b.label_mask,
                b.seed_local_idx, feat)
    for _ in range(2):
        args = (b.graph, b.node_ids, b.labels, b.label_mask,
                b.seed_local_idx, feat)
        assert torch.equal(cap(*args), steps[1](*args))
    _equal_models(*models)


def test_unlabelled_seeds_are_zero_one_hot_rows():
    """A label of -1 (an OGB dataset's unlabelled node) is a row of zeros,
    as in ``jax.nn.one_hot``, not an error."""
    rng = np.random.default_rng(3)
    n = 100
    labels = rng.integers(0, 3, n)
    labels[:50] = -1
    g = pt.LargeGraph.from_coo(rng.integers(0, n, 600),
                               rng.integers(0, n, 600),
                               rng.normal(size=(n, 8)).astype(np.float32),
                               labels)
    b = pt.NeighborSampler(g, (3,), 8, seed=1, emit_node_ids=True,
                           device="cpu").sample(np.arange(8))
    m = pt.EncodeProcessDecode((0, 8, 0), (16,) * 3, (1, 3, 0), device="cpu")
    loss = pt.make_node_classification_step(m, pt.adam(m.parameters()), 3)(
        b.graph, b.node_ids, b.labels, b.label_mask, b.seed_local_idx,
        pt.device_feature_table(g, device="cpu"))
    assert torch.isfinite(loss)


def test_capture_step_needs_adam_state_it_can_restore():
    x, y, model = _sort_setup()
    step = pt.make_train_step(model, torch.optim.SGD(model.parameters(),
                                                     lr=0.1, momentum=0.9))
    with pytest.raises(TypeError, match="Adam"):
        pt.capture_step(step)


def test_optimizer_helpers_are_capturable_only_on_the_card():
    model = torch.nn.Linear(2, 2)
    assert not pt.adamw(model.parameters()).defaults["capturable"]
    opt = pt.adam(model.parameters(), 1e-3)
    assert not opt.defaults["capturable"]
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] \
        == 1e-8 and opt.defaults["weight_decay"] == 0


def test_structure_keys_shapes_dtypes_and_host_metadata():
    """One graph per structure: tensor shapes, dtypes and devices, and the
    GraphsTuple's host metadata; not the tensors' contents."""
    cfg = pt.SortTaskConfig()
    x0, y0 = pt.get_batch(np.random.default_rng(0), cfg, device="cpu")
    x1, y1 = pt.get_batch(np.random.default_rng(1), cfg, device="cpu")
    assert structure((x0, y0)) == structure((x1, y1))
    assert structure((x0, y0)) != structure(
        (x0.with_features(nf=x0.nf.double()), y0))
    assert structure(x0) != structure(x0.replace(pad_aliases_real=True))
    assert structure(x0) != structure(x0.replace(slot_shape=(41, 512)))
    x2, _ = pt.get_batch(np.random.default_rng(0),
                         pt.SortTaskConfig(batch_size=2), device="cpu")
    assert structure(x0) != structure(x2)
    assert hash(structure({"a": x0, "b": [1, (2, None)]}))
    twice = map_tensors(lambda t: t * 2, {"a": x0.nf, "b": (x0.ef, 3)})
    assert torch.equal(twice["a"], x0.nf * 2) and twice["b"][1] == 3
    assert len(tensors(x0)) == sum(
        isinstance(v, torch.Tensor) for v in vars(x0).values())


def test_warmup_and_build_dir_on_the_cpu(tmp_path):
    assert pt_warmup.enable_compilation_cache() == os.path.join(REPO,
                                                                "build")
    pt_warmup.warmup((16, 16, 16), n_cores=2, device="cpu")


def test_node_classification_example_on_an_ogb_dataset(tmp_path):
    """``--ogb-root`` / ``--ogb-name``: the example loads a dataset in the
    OGB raw layout and trains on it through ``capture_step`` (eager on
    the CPU)."""
    rng = np.random.default_rng(4)
    n, d, n_classes = 300, 8, 3
    labels = rng.integers(0, n_classes, n)
    feat = rng.normal(size=(n, d)).astype(np.float32)
    feat[:, :n_classes] += 3.0 * np.eye(n_classes, dtype=np.float32)[labels]
    ids = rng.permutation(n)
    pt.save_ogb_node_dataset(str(tmp_path), "ogbn-mini",
                             rng.integers(0, n, 1500),
                             rng.integers(0, n, 1500), feat, labels,
                             {"train": ids[:200], "valid": ids[200:]})
    # One thread: the test workers already keep every core busy.
    out = subprocess.run(
        [sys.executable, "examples/node_classification_torch.py",
         "--steps", "20", "--batch", "16", "--hidden", "16", "--device",
         "cpu", "--ogb-root", str(tmp_path), "--ogb-name", "ogbn-mini",
         "--log-every", "10"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert "loaded ogbn-mini: 300 nodes" in out.stdout, out.stderr
    acc = float(out.stdout.split("validation accuracy: ")[1].split()[0])
    # It exits 0 iff the validation accuracy clears 0.5.
    assert out.returncode == (0 if acc > 0.5 else 1), out.stderr
