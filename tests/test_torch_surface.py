"""The rest of the port's public surface against ``graphnets_tpu`` on the
CPU: the views, ``flat_unpadded_*``, the ``collapse_ef`` family and
``util``'s per-graph features (equal to JAX's exactly, on the same
batches), ``segment_mean`` / ``segment_max`` (f32 means within 1e-6 of the
largest magnitude, the same f32 sums in another order; maxima exact,
empty and masked segments included), the precision policy, the SVG
renderings (the same strings), the metrics and profiling helpers, the
top-level exports and the two examples."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphnets_tpu as gj
import graphnets_tpu_torch as pt
from graphnets_tpu import util as j_util
from graphnets_tpu.nn import precision as j_prec
from graphnets_tpu.ops import scatter as j_scatter
from graphnets_tpu.utils import viz as j_viz
from graphnets_tpu_torch import util as p_util

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed):
    """A heterogeneous batch of three graphs (one asymmetric, one with a
    self-loop-free row) with edge, node and graph features."""
    rng = np.random.default_rng(seed)
    adjs = [np.array([[1, 0, 1], [1, 1, 0], [0, 1, 1]]),
            np.array([[1, 1, 0, 1], [1, 0, 1, 0], [0, 1, 1, 1],
                      [1, 0, 1, 0]]),
            np.ones((2, 2), int)]
    d = {"graphs": adjs,
         "ef": [rng.standard_normal((int(a.sum()), 3)).astype(np.float32)
                for a in adjs],
         "nf": [rng.standard_normal((a.shape[0], 4)).astype(np.float32)
                for a in adjs],
         "gf": [rng.standard_normal(2).astype(np.float32) for _ in adjs]}
    return d


PADS = {
    "exact": (None, None),
    "bucketed": (gj.PadSpec.bucketed(9, 20, 3), pt.PadSpec.bucketed(9, 20, 3)),
    "uniform": (gj.PadSpec.uniform(5, 16, num_graphs=4),
                pt.PadSpec.uniform(5, 16, num_graphs=4)),
}


def _pair(pad_name, seed=0):
    pj, pp = PADS[pad_name]
    d = _data(seed)
    return gj.batch(d, pad=pj), pt.batch(d, pad=pp, device="cpu")


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("pad", list(PADS))
def test_views_and_util_equal_jax(pad):
    g_j, g_p = _pair(pad)
    for b in range(3):
        _eq(gj.efview(g_j, slice(None), 1, b), pt.efview(g_p, slice(None),
                                                         1, b), "efview")
        _eq(gj.nfview(g_j, 2, slice(None), b), pt.nfview(g_p, 2,
                                                         slice(None), b))
        _eq(gj.gfview(g_j, slice(None), b), pt.gfview(g_p, slice(None), b))
        _eq(j_util.get_edge_features(g_j, b),
            p_util.get_edge_features(g_p, b), "edges")
        _eq(j_util.get_node_features(g_j, b),
            p_util.get_node_features(g_p, b), "nodes")
        _eq(j_util.get_graph_features(g_j, b),
            p_util.get_graph_features(g_p, b), "graph")
    _eq(gj.flat_unpadded_nf(g_j), pt.flat_unpadded_nf(g_p).numpy())
    _eq(gj.flat_unpadded_ef(g_j), pt.flat_unpadded_ef(g_p).numpy())
    _eq(gj.collapse_ef_padded(g_j), pt.collapse_ef_padded(g_p))
    _eq(gj.flat_unpadded_collapsed_ef(g_j), pt.flat_unpadded_collapsed_ef(g_p))
    for a, b in zip(gj.collapse_ef(g_j), pt.collapse_ef(g_p)):
        _eq(a, b, "collapse_ef")
    for a, b in zip(gj.unpaddedcollapsedef(g_j), pt.unpaddedcollapsedef(g_p)):
        _eq(a, b)
    assert pt.flatunpaddednf is pt.flat_unpadded_nf
    assert pt.flatunpaddedef is pt.flat_unpadded_ef
    assert pt.collapsef is pt.collapse_ef
    assert pt.flatunpaddedcollapsedef is pt.flat_unpadded_collapsed_ef
    assert pt.GNGraphBatch is pt.GraphsTuple


def test_flat_unpadded_is_differentiable():
    for pad in ("bucketed", "uniform"):
        _, g = _pair(pad)
        nf = g.nf.clone().requires_grad_(True)
        out = pt.flat_unpadded_nf(g.with_features(nf=nf))
        (out * torch.arange(out.numel()).reshape(out.shape)).sum().backward()
        want = torch.zeros_like(nf)
        want[g.node_mask] = torch.arange(out.numel(),
                                         dtype=nf.dtype).reshape(out.shape)
        assert torch.equal(nf.grad, want), pad


@pytest.mark.parametrize("masked", [False, True])
def test_segment_mean_and_max_equal_jax(masked):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    # Segment 4 empty; with the mask, segment 1 fully masked.
    seg = np.sort(rng.choice([0, 1, 2, 3, 5, 6], size=40)).astype(np.int32)
    mask = None
    if masked:
        mask = (rng.random(40) < 0.7) & (seg != 1)
    args_j = (jnp.asarray(x), jnp.asarray(seg), 8,
              None if mask is None else jnp.asarray(mask))
    args_p = (torch.from_numpy(x), torch.from_numpy(seg), 8,
              None if mask is None else torch.from_numpy(mask))
    mean_j = np.asarray(j_scatter.segment_mean(*args_j))
    mean_p = pt.segment_mean(*args_p).numpy()
    np.testing.assert_allclose(mean_p, mean_j, rtol=0,
                               atol=1e-6 * np.abs(mean_j).max())
    max_j = np.asarray(j_scatter.segment_max(*args_j))
    max_p = pt.segment_max(*args_p).numpy()
    _eq(max_j, max_p, "segment_max")
    assert (max_p[4] == 0).all() and (mean_p[4] == 0).all()
    if masked:
        assert (max_p[1] == 0).all() and (mean_p[1] == 0).all()
    # bf16 rows: the maximum is exact in any type.
    xb = torch.from_numpy(x).bfloat16()
    _eq(np.asarray(j_scatter.segment_max(jnp.asarray(xb.float().numpy(),
                                                     jnp.bfloat16),
                                         *args_j[1:]).astype(jnp.float32)),
        pt.segment_max(xb, *args_p[1:]).float().numpy(), "bf16 max")


def test_few_segment_sums_take_the_one_hot_product_as_jax():
    """At most 64 segments over at least four rows a segment, the sum is
    JAX's one-hot f32 product (a fixed order; on the card ``index_add_``'s
    float atomics made the graph pools differ run to run): the same values
    within 1e-6 of the largest magnitude, the mask folded in, and a row
    whose id lies outside the segments dropped, as JAX drops it."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 5)).astype(np.float32)
    seg = np.sort(rng.integers(0, 6, 64)).astype(np.int32)
    seg[-3:] = 9                      # out of range for 6 segments
    mask = rng.random(64) < 0.8
    for m in (None, mask):
        want = np.asarray(j_scatter.segment_sum(
            jnp.asarray(x), jnp.asarray(seg), 6,
            None if m is None else jnp.asarray(m)))
        got = pt.segment_sum(torch.from_numpy(x), torch.from_numpy(seg), 6,
                             None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("switch", ["legacy", "new"])
def test_few_segment_sums_ignore_the_tf32_switch(switch):
    """The one-hot product and its backward run in IEEE f32 (JAX pins
    ``HIGHEST``) whatever the caller set, and the caller's switch is as it
    was afterwards: the values and gradients bit-equal to those under the
    default switch."""
    from graphnets_tpu_torch.ops.scatter import _ieee_f32_matmul
    m = torch.backends.cuda.matmul
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((64, 5)).astype(np.float32))
    seg = torch.from_numpy(np.sort(rng.integers(0, 6, 64)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))

    def run():
        xr = x.clone().requires_grad_()
        out = pt.segment_sum(xr, seg, 6)
        (out * w).sum().backward()
        return out.detach(), xr.grad

    want = run()
    prev = m.fp32_precision
    try:
        if switch == "legacy":
            torch.set_float32_matmul_precision("high")
        else:
            m.fp32_precision = "tf32"
        with _ieee_f32_matmul():
            assert m.fp32_precision == "ieee"
        assert m.fp32_precision == "tf32"
        if switch == "legacy":
            assert torch.get_float32_matmul_precision() == "high"
        got = run()
        assert m.fp32_precision == "tf32"
    finally:
        m.fp32_precision = prev
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_precision_policy_matches_jax():
    assert pt.DEFAULT == pt.Policy()
    assert pt.BF16_COMPUTE.param_dtype == torch.float32
    assert pt.BF16_COMPUTE.compute_dtype == torch.bfloat16
    assert j_prec.BF16_COMPUTE.compute_dtype == jnp.bfloat16
    g_j, g_p = _pair("bucketed")
    cj = j_prec.BF16_COMPUTE.cast_graph(g_j)
    cp = pt.BF16_COMPUTE.cast_graph(g_p)
    for name in ("ef", "nf", "gf"):
        a, b = getattr(cj, name), getattr(cp, name)
        assert b.dtype == torch.bfloat16
        _eq(np.asarray(a.astype(jnp.float32)), b.float().numpy(), name)
    assert torch.equal(cp.senders, g_p.senders)
    sd = {"a": {"w": torch.ones(2, 3)}, "i": torch.arange(3),
          "l": [torch.zeros(2)]}
    out = pt.cast_params(sd, torch.bfloat16)
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["i"].dtype == torch.int64 and out["l"][0].dtype == \
        torch.bfloat16
    assert sd["a"]["w"].dtype == torch.float32     # a new dict
    tree = j_prec.cast_params({"w": jnp.ones((2, 3)),
                               "i": jnp.arange(3)}, jnp.bfloat16)
    assert tree["w"].dtype == jnp.bfloat16 and tree["i"].dtype != \
        jnp.bfloat16
    m = pt.Linear(3, 2, device="cpu")
    assert pt.Policy(param_dtype=torch.bfloat16).cast_params(m) is m
    assert m.w.dtype == torch.bfloat16


def test_svgs_equal_jax():
    rng = np.random.default_rng(1)
    for n in (2, 5, 7):
        nf = np.eye(100, dtype=np.float32)[rng.integers(0, 100, n)]
        assert pt.sort_input_svg(nf) == j_viz.sort_input_svg(nf)
        nodes = rng.integers(0, 2, n)
        edges = rng.integers(0, 2, n * n)
        assert pt.sort_target_svg(nodes, edges) == \
            j_viz.sort_target_svg(nodes, edges)
    edges = [(0, 1), (1, 1), (2, 0)]
    kw = dict(node_value=lambda i: f"v{i}", node_fill=lambda i: "#abc",
              edge_stroke=lambda k: "red", size=300, node_radius=10)
    assert pt.render_graph_svg(3, edges, **kw) == \
        j_viz.render_graph_svg(3, edges, **kw)
    with pytest.raises(ValueError):
        pt.sort_target_svg(np.zeros(3), np.zeros(8))


def test_metrics_and_profiling(tmp_path):
    path = tmp_path / "m.jsonl"
    log = pt.MetricLogger(jsonl_path=str(path), log_every=0)
    log.write(1, {"loss": torch.tensor(2.0)})
    log.write(3, {"loss": 1.5}, edges_per_batch=100)
    log.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows[0] == {"step": 1, "loss": 2.0}
    assert rows[1]["step"] == 3 and rows[1]["loss"] == 1.5
    assert rows[1]["edges_per_s"] == pytest.approx(
        100 / rows[1]["step_time_s"])
    assert pt.is_host0() and pt.host0_logger().level == 20
    timer = pt.StepTimer(warmup=1)
    for _ in range(3):
        with timer:
            pass
    assert timer.count == 2 and timer.mean >= 0.0
    with pt.trace(str(tmp_path / "trace")) as prof:
        with pt.annotate("graphnets_span"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "graphnets_span" in names
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((tmp_path / "trace" / files[0]).read_text())
    assert any(e.get("name") == "graphnets_span"
               for e in trace["traceEvents"])


def test_exports_cover_the_jax_package():
    assert set(gj.__all__) <= set(pt.__all__)
    for name in pt.__all__:
        assert getattr(pt, name) is not None, name
    for name in ("device_batch", "train_sort_device", "evaluate_sort",
                 "CheckpointManager", "segment_mean", "segment_max",
                 "Policy", "validate_graph", "MetricLogger", "trace",
                 "annotate", "StepTimer", "TrainState"):
        assert name in pt.__all__, name


def test_examples_run_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "examples/simple_torch.py", "--device", "cpu"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "example 3 ok" in out.stdout
    ckpt, svg = tmp_path / "ckpt", tmp_path / "svg"
    out = subprocess.run(
        [sys.executable, "examples/sort_torch.py", "--steps", "4",
         "--core-dim", "16", "--n-cores", "1", "--log-every", "2",
         "--device", "cpu", "--ckpt", str(ckpt), "--svg-dir", str(svg)],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for piece in ("step 2: loss=", "step 4: loss=", "throughput:",
                  "is_min pred:", "SVGs written", "checkpoint saved"):
        assert piece in out.stdout, (piece, out.stdout[-2000:])
    assert sorted(os.listdir(svg)) == ["input.svg", "pred.svg", "target.svg"]
    assert pt.CheckpointManager(str(ckpt)).latest_step() == 4
    out = subprocess.run(
        [sys.executable, "examples/sort_torch.py", "--steps", "2",
         "--core-dim", "16", "--n-cores", "1", "--log-every", "1",
         "--device", "cpu", "--host-loop"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step 2: loss=" in out.stdout
