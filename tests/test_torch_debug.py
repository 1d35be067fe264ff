"""The port's debug checks (``GRAPHNETS_TPU_TORCH_DEBUG``, ``utils/debug``)
against the JAX package's (``GRAPHNETS_TPU_DEBUG``): the guards of the
sorted segment sum and the sorted gather trip where JAX's do (unsorted ids,
padding that aliases a real segment, out-of-range gather ids) and stay
quiet on canonical batches, through a whole training step; ``batch``
validates what it builds; ``validate_graph`` refuses the broken layouts
JAX's refuses; ``checked`` and ``assert_finite``; and ``capture_step``
refuses to capture while the checks are on (they read tensors on the
host), which the step itself, uncaptured, does not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu.ops import scatter as j_scatter
from graphnets_tpu.ops.pallas import gather as j_gather
from graphnets_tpu.utils import config as j_config
from graphnets_tpu.utils.debug import validate_graph as j_validate_graph
from graphnets_tpu_torch import graph as p_graph
from graphnets_tpu_torch.ops import scatter as p_scatter
from graphnets_tpu_torch.ops.kernels import gather as p_gather
from graphnets_tpu_torch.utils import config as p_config
from graphnets_tpu_torch.utils import debug as p_debug


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def debug_on():
    old_j, old_p = j_config.debug_checks(), p_config.debug_checks()
    j_config.enable_debug_checks(True)
    pt.enable_debug_checks(True)
    yield
    j_config.enable_debug_checks(old_j)
    pt.enable_debug_checks(old_p)


def _both_raise(fn_j, fn_p, match):
    with pytest.raises(ValueError, match=match):
        fn_j()
    with pytest.raises(ValueError, match=match):
        fn_p()


def test_switch_defaults_off_and_toggles():
    assert not p_config.Config().debug_checks
    was = pt.debug_checks()
    pt.enable_debug_checks(True)
    assert pt.debug_checks()
    pt.enable_debug_checks(False)
    assert not pt.debug_checks()
    pt.enable_debug_checks(was)


CASES = {
    # ids descending at 3 -> 2
    "unsorted": (np.array([0, 1, 3, 2, 4, 4]), None, "not sorted"),
    # the padded row (mask False) targets segment 1, which a real row uses
    "aliased padding": (np.array([0, 1, 1, 2, 3, 4]),
                        np.array([1, 1, 0, 1, 1, 1], bool), "leak"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_segment_sum_guard_trips_as_jax(debug_on, case):
    seg, mask, match = CASES[case]
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    _both_raise(
        lambda: j_scatter.segment_sum(
            jnp.asarray(x), jnp.asarray(seg, jnp.int32), 5,
            None if mask is None else jnp.asarray(mask),
            sorted_pad_safe=True),
        lambda: p_scatter.segment_sum(
            torch.from_numpy(x), torch.from_numpy(seg.astype(np.int32)), 5,
            None if mask is None else torch.from_numpy(mask),
            sorted_pad_safe=True),
        match)
    # Off, or without the sorted_pad_safe declaration, nothing is checked.
    pt.enable_debug_checks(False)
    p_scatter.segment_sum(torch.from_numpy(x),
                          torch.from_numpy(seg.astype(np.int32)), 5,
                          sorted_pad_safe=True)


@pytest.mark.parametrize("idx,match", [([0, 2, 1, 3], "not ascending"),
                                       ([0, 1, 2, 9], "out of range"),
                                       ([-1, 0, 1, 2], "out of range")])
def test_sorted_gather_guard_trips_as_jax(debug_on, idx, match):
    table = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    idx = np.asarray(idx, np.int32)
    _both_raise(lambda: j_gather._debug_check_sorted_in_range(
                    jnp.asarray(idx), 8),
                lambda: p_gather.sorted_gather(torch.from_numpy(table),
                                               torch.from_numpy(idx)),
                match)
    with pytest.raises(ValueError, match=match):
        p_gather.sorted_gather_add(torch.from_numpy(table),
                                   torch.from_numpy(idx), torch.zeros(4, 4))


def test_canonical_batches_pass_through_a_training_step(debug_on,
                                                        monkeypatch):
    """A sort-task step with the kernel routes on (their plain versions on
    the CPU) runs every guard on canonical data and raises nothing; batch()
    validated what it built."""
    seen = []
    real = p_debug.validate_graph
    monkeypatch.setattr(p_debug, "validate_graph",
                        lambda g: (seen.append(g), real(g)))
    old = p_config.get_config().use_kernels
    pt.enable_kernels(True)
    try:
        cfg = pt.SortTaskConfig()
        for uniform in (False, True):
            x, y = pt.get_batch(np.random.default_rng(0), cfg,
                                pt.sort_pad_spec(cfg, uniform),
                                device="cpu")
            model = pt.EncodeProcessDecode((0, 100, 0), (128,) * 3,
                                           (2, 2, 0), n_cores=1,
                                           device="cpu")
            out = pt.make_train_step(model, pt.adamw(model.parameters()))(
                x, y)
            pt.assert_finite(out, "metrics")
            gx, gy = pt.device_batch(torch.Generator().manual_seed(1), cfg,
                                     pt.sort_pad_spec(cfg, uniform))
            pt.validate_graph(gx)
            pt.validate_graph(gy)
    finally:
        p_config.get_config().use_kernels = old
    assert len(seen) >= 4      # x and y of both layouts, inside batch()


def _sort_batch(uniform=False):
    cfg = pt.SortTaskConfig(batch_size=2)
    return pt.get_batch(np.random.default_rng(3), cfg,
                        pt.sort_pad_spec(cfg, uniform), device="cpu")[0]


BREAKS = {
    "unsorted receivers": lambda g: g.replace(
        receivers=g.receivers.flip(0).contiguous()),
    "n_node off": lambda g: g.replace(n_node=g.n_node + 1),
    "edge to a padded node": lambda g: g.replace(
        senders=torch.where(g.edge_mask, g.num_node_slots - 1, g.senders)),
    "sender out of range": lambda g: g.replace(
        senders=g.senders + g.num_node_slots),
    "features short": lambda g: g.replace(nf=g.nf[:-1]),
}


@pytest.mark.parametrize("name", list(BREAKS))
@pytest.mark.parametrize("uniform", [False, True])
def test_validate_graph_refuses_what_jax_refuses(name, uniform):
    g = _sort_batch(uniform)
    pt.validate_graph(g)
    j_validate_graph(g)
    bad = BREAKS[name](g)
    with pytest.raises(AssertionError):
        j_validate_graph(bad)
    with pytest.raises(ValueError, match="validate_graph"):
        pt.validate_graph(bad)


def test_validate_graph_checks_the_uniform_padding_target():
    g = _sort_batch(uniform=True)
    pad = ~g.edge_mask
    bad = g.replace(senders=torch.where(pad, 0, g.senders))
    with pytest.raises(AssertionError):
        j_validate_graph(bad)
    with pytest.raises(ValueError, match="padding"):
        pt.validate_graph(bad)


def test_checked_and_assert_finite():
    def f(x):
        return {"y": x * 2, "n": torch.tensor(3)}

    out = pt.checked(f)(torch.ones(2))
    assert torch.equal(out["y"], torch.full((2,), 2.0))
    with pytest.raises(FloatingPointError, match=r"output\['y'\]"):
        pt.checked(f)(torch.tensor([1.0, float("nan")]))
    # The guards are on inside the call, and the switch is put back.
    assert not pt.debug_checks()
    with pytest.raises(ValueError, match="not sorted"):
        pt.checked(p_scatter.segment_sum)(
            torch.ones(3, 2), torch.tensor([1, 0, 2]), 3,
            sorted_pad_safe=True)
    assert not pt.debug_checks()
    g = _sort_batch()
    pt.assert_finite(g)
    with pytest.raises(FloatingPointError, match=r"graph\.nf"):
        pt.assert_finite(g.replace(nf=g.nf / 0.0), "graph")
    pt.assert_finite([np.ones(2), np.arange(3)])


def test_capture_refuses_while_debug_checks_are_on(debug_on):
    """The choice for the host checks under a CUDA-graph capture: refuse
    with a clear error, before anything touches the card (so it shows on
    the CPU too), and leave the uncaptured step to run with them."""
    model = pt.EncodeProcessDecode((0, 100, 0), (16,) * 3, (2, 2, 0),
                                   n_cores=1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = pt.TrainState(model, pt.adamw(model.parameters()), 0, (gen,))
    step = pt.make_sort_device_step(state, pt.SortTaskConfig())
    cap = pt.capture_step(step)
    with pytest.raises(RuntimeError, match="debug checks are on"):
        cap._capture(())
    assert cap.captures == cap.traced_calls == 0
    cap()          # on the CPU the step runs eagerly, checks and all
    assert all(torch.isfinite(v) for v in step.sums.values())


def test_flat_unpadded_refuses_a_capture(monkeypatch):
    g = _sort_batch()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    for fn in (p_graph.flat_unpadded_nf, p_graph.flat_unpadded_ef):
        with pytest.raises(TypeError, match="CUDA-graph capture"):
            fn(g if fn is p_graph.flat_unpadded_nf
               else g.replace(ef=torch.zeros(g.num_edge_slots, 2)))
