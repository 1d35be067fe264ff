"""The GraphCast kind (``models/graphcast.py``, ``reference/graphcast.py``,
``generators/graphcast_batches.py``, the cell ``gc1deg.batch4``) on the
CPU, with the cell cut so a run fits a test (a 10 degree grid, the mesh to
level 2, width 32, 2 processor layers, 2 samples a step, f32 compute so
the sound run's gaps are rounding alone): a sound run is correct against
the plain reference; with the optimizer's state left unchanged, or half
of the samples left out of the loss's mean, it is not.  The step's FLOPs
against a hand count, the traffic by seed, and the new readers on a
trace without the program's stage markers."""

import io
import json
import time
from types import SimpleNamespace

import pytest
import torch

import graphnets_tpu_torch as port
from generators import graphcast_batches
from harness import runner, spec
from metrics import gc_grid_mesh_ms_per_step, gc_processor_ms_per_step
from models import graphcast

CELL = "gc1deg.batch4"
SMALL = dict(resolution=10.0, mesh_size=2, latent_size=32, hidden_size=32,
             gnn_msg_steps=2)


def _cell():
    cell = spec.cell(CELL)
    cell.config["model"].update(SMALL)
    cell.config["compute_dtype"] = "float32"
    cell.traffic.update(samples=2, batches=3)
    return cell


def _run():
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run(_cell(), 2 ** 33 + 9, 0.05, False, "cpu",
                    time.perf_counter(), out, err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"] is True, result["checks"]
    assert {"train_edges_per_s", "setup_s"} <= set(result["metrics"])


def test_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    result = _run()
    assert result["correct"] is False
    assert result["checks"]["grad_gap"]["value"] > 0.9


def test_half_the_samples_left_out(monkeypatch):
    full = port.latitude_weighted_mse

    def half(pred, target, node_weights, channel_weights):
        return full(pred, target, node_weights[:node_weights.shape[0] // 2],
                    channel_weights)
    monkeypatch.setattr(port, "latitude_weighted_mse", half)
    result = _run()
    assert result["correct"] is False
    limits = spec.cell(CELL).checks["limits"]
    assert any(result["checks"][k]["value"] > limits[k] for k in limits)


def test_output_layer_drawn_small():
    """``make_weights``: ``models/gn``'s draw, the output layer's weight
    and bias times ``OUTPUT_SCALE``, every other leaf as drawn."""
    from models import gn
    shapes = {"grid_embed.l0.w": (5, 4), "output.l0.b": (4,),
              "output.l1.w": (4, 2), "output.l1.b": (2,)}
    got = graphcast.make_weights(shapes, 7, torch.device("cpu"))
    want = gn.make_weights(shapes, 7, torch.device("cpu"))
    for k in shapes:
        scale = graphcast.OUTPUT_SCALE if k.startswith("output.l1") else 1.0
        assert torch.equal(got[k], want[k] * scale), k


def test_step_flops_by_hand():
    # A 90 degree grid (3 x 4 nodes), the bare icosahedron (12 nodes, 60
    # directed edges), d = 2, hidden 3, 1 layer, 5 in, 1 out, 3 mesh and
    # 4 edge features; 7 g2m edges a sample, 2 samples.
    m = {"resolution": 90.0, "mesh_size": 0, "latent_size": 2,
         "hidden_size": 3, "gnn_msg_steps": 1, "input_channels": 5,
         "output_channels": 1, "mesh_node_features": 3, "edge_features": 4}
    ng, nm, em, e2g, g2m = 12, 12, 60, 36, 7
    d, h = 2, 3

    def mlp(rows, din, dout):
        return rows * (din * h + h * dout)

    def inet(edges, senders, receivers):
        return (edges * d * h + senders * d * h + receivers * d * h
                + edges * h * d + mlp(receivers, 2 * d, d))

    fwd = (mlp(ng, 5, d) + mlp(nm, 3, d) + mlp(g2m + em + e2g, 4, d)
           + inet(g2m, ng, nm) + mlp(ng, d, d) + inet(em, nm, nm)
           + inet(e2g, nm, ng) + mlp(ng, d, 1))
    rows = (2 * (g2m + em + e2g), 2 * (ng + nm), 2)
    assert graphcast.step_flops(m, rows) == 3 * 2 * 2 * fwd


def test_full_size_counts():
    cfg = spec.cell(CELL).config["model"]
    c = graphcast.counts(cfg)
    assert c == {"grid": 65_160, "mesh": 10_242, "mesh_edges": 81_900,
                 "m2g": 195_480}
    flops = graphcast.step_flops(cfg, (4 * (101_892 + 81_900 + 195_480),
                                       4 * (65_160 + 10_242), 4))
    assert 3.1e13 < flops < 3.3e13


def test_traffic_by_seed():
    cell = _cell()

    def draw(seed):
        f = graphcast_batches.Feed(port, cell.config, cell.traffic, seed,
                                   torch.device("cpu"))
        return f, [t for x, y in f.batches for t in (x.nodes["grid"], y)]
    (fa, a), (_, b), (_, c) = draw(5), draw(5), draw(6)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not any(torch.equal(u, v) for u, v in zip(a, c))
    x, y = fa.batches[0]
    ng = x.num_real_nodes["grid"]
    assert bool((x.nodes["grid"][ng:] == 0).all()) and bool(
        (y[ng:] == 0).all())
    assert torch.equal(x.nodes["grid"][:ng, -3:],
                       fa.typed.nodes["grid"][:ng])
    assert fa.rows == (sum(e.num_real for e in x.edges.values()),
                       sum(x.num_real_nodes.values()), 2)
    w = graphcast_batches.channel_weights(spec.cell(CELL).config["model"])
    assert w.shape == (83,) and w[-5] == 1.0 and w[-1] == pytest.approx(0.1)
    assert w[:13].mean() == pytest.approx(1.0)


def test_readers_need_the_stage_markers():
    ctx = SimpleNamespace(program=None, steps=3, timeline=None)
    assert gc_processor_ms_per_step.read(ctx) is None
    assert gc_grid_mesh_ms_per_step.read(ctx) is None


def test_readers_on_a_hand_written_trace(tmp_path):
    """``test_portbench_spans``'s two steps with GraphCast's six stage
    markers inside the forward kernel [204, 240) and the backward kernel
    [252, 300): per step the processor holds [215, 230) and [265, 290),
    40 us; the encoder [202, 215) (its marker 2 and kernel 11), the
    decoder [230, 250) (kernel 10), the backward's decoder [255, 265) and
    encoder [290, 310) (10 each), 43 us."""
    import test_portbench_spans as sp

    def stages(o):
        return [sp._x("kernel", f"gn_phase_{s}()", o + a, o + a + 2)
                for s, a in (("encoder", 202), ("processor", 215),
                             ("decoder", 230), ("decoder_bwd", 255),
                             ("processor_bwd", 265), ("encoder_bwd", 290))]
    ctx = sp._ctx(tmp_path, extra=stages)
    assert len(ctx.program.steps()) == 2
    assert gc_processor_ms_per_step.read(ctx) == pytest.approx(0.040)
    assert gc_grid_mesh_ms_per_step.read(ctx) == pytest.approx(0.043)
    plain = sp._ctx(tmp_path)
    assert gc_processor_ms_per_step.read(plain) is None


def test_feed_drops_the_graphs_when_the_tracing_switch_changes(
        monkeypatch):
    """A traced run's second stretch switches the program's tracing on:
    the feed drops the step's graphs once, before its first step with the
    switch on, and not again."""
    cell = _cell()
    f = graphcast_batches.Feed(port, cell.config, cell.traffic, 3,
                               torch.device("cpu"))
    model = graphcast.build(port, cell.config["model"], "cpu")
    f.build_step(model, port.adamw(model.parameters(), 1e-3))
    cleared = []
    monkeypatch.setattr(type(f.step), "clear",
                        lambda self: cleared.append(port.tracing()))
    was = port.tracing()
    try:
        f.unit(lambda: None)
        port.enable_tracing(not was)
        f.unit(lambda: None)
        f.unit(lambda: None)
    finally:
        port.enable_tracing(was)
    assert cleared == [not was]
