"""The readers of the program's own tracing (``harness/spans.py`` and the
metrics that use it) on a hand-written Chrome trace: two host-loop steps
with the harness's ranges, the program's nested ``gn.*`` spans, its phase
markers, kernels and copies.  Each metric reads its value worked out by
hand, and each idle gap takes the innermost range open at its midpoint.
The same trace without the program's spans and markers reads ``None``
for every such metric and labels the gaps as ``Timeline.breakdown()``
does."""

import importlib
import json
import re
from types import SimpleNamespace

import pytest

from graphnets_tpu_torch.utils import profiling
from harness import spans, spec, trace

METRICS = ("fwd_ms_per_step", "bwd_ms_per_step", "opt_ms_per_step",
           "graph_gap_ms_per_step", "step_host_ms", "copy_in_mb_per_step",
           "batch_to_device_ms")


def _x(cat, name, a, b, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}
    if args:
        e["args"] = args
    return e


def _step(o, program=True):
    """One step at offset ``o`` (microseconds): the harness's batch and
    step ranges, the program's spans inside them, and on the device a
    pageable batch copy, the copy-in, the five markers around the
    phases' kernels and an output clone."""
    host = [_x("user_annotation", "portbench.batch", o, o + 100),
            _x("user_annotation", "portbench.step", o + 100, o + 400)]
    dev = [_x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", o + 60,
              o + 70, bytes=16),
           _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", o + 126,
              o + 136, bytes=1024),
           _x("kernel", "forward_kernel", o + 204, o + 240),
           _x("kernel", "backward_kernel", o + 252, o + 300),
           _x("kernel", "multi_tensor_apply_kernel", o + 312, o + 330),
           _x("kernel", "accuracy_kernel", o + 344, o + 350),
           _x("kernel", "direct_copy_kernel", o + 370, o + 380)]
    if not program:
        return host + dev
    host += [_x("user_annotation", n, o + a, o + b) for n, a, b in (
        ("gn.batch", 5, 95), ("gn.batch.pack", 10, 50),
        ("gn.batch.to_device", 50, 90), ("gn.step", 105, 395),
        ("gn.step.lookup", 110, 120), ("gn.step.copy_in", 120, 150),
        ("gn.step.replay", 150, 250), ("gn.step.outputs", 250, 390))]
    dev += [_x("kernel", f"gn_phase_{p}()", o + a, o + a + 2)
            for p, a in (("forward", 200), ("backward", 250),
                         ("optimizer", 310), ("metrics", 340), ("end", 360))]
    return host + dev


def _ctx(tmp_path, program=True, extra=None):
    events = [_x("user_annotation", "portbench.window", 0, 1000)]
    for o in (0, 500):
        events += _step(o, program) + (extra(o) if extra else [])
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tl = trace.read(path)
    return SimpleNamespace(steps=2, timeline=tl,
                           program=spans.read(path, tl),
                           counters={"copy_in_bytes": 2_000_000}
                           if program else {})


def test_markers_are_the_programs():
    assert spans.PHASES == profiling.PHASES
    src = (spec.ROOT / "graphnets_tpu_torch" / "csrc" / "phase_marker.cu"
           ).read_text()
    assert re.findall(r"__global__ void (gn_phase_\w+)\(\)", src) == [
        spans.MARKER + p for p in spans.PHASES]


def test_metrics_read_the_hand_computed_values(tmp_path):
    ctx = _ctx(tmp_path)
    got = {m: importlib.import_module("metrics." + m).read(ctx)
           for m in METRICS}
    # Per step: forward [200, 250) holds its marker 2 + kernel 36;
    # backward [250, 310) 2 + 48; optimizer [310, 340) 2 + 18; from the
    # forward marker to the end marker, 160 of which 116 busy; gn.step
    # 290 us, gn.batch.to_device 40 us; 1 MB copied in a step.
    assert got == pytest.approx({
        "fwd_ms_per_step": 0.038, "bwd_ms_per_step": 0.050,
        "opt_ms_per_step": 0.020, "graph_gap_ms_per_step": 0.044,
        "step_host_ms": 0.290, "copy_in_mb_per_step": 1.0,
        "batch_to_device_ms": 0.040})
    tl, p = ctx.timeline, ctx.program
    phases = spans.phase_seconds(tl, p)
    assert phases == pytest.approx({"forward": 76e-6, "backward": 100e-6,
                                    "optimizer": 40e-6, "metrics": 16e-6})
    # The phases plus the work outside the steps (batch copy, copy-in,
    # end marker, clone: 32 us a step) are the busy time; the gaps inside
    # the steps plus those between them are the idle time.
    assert sum(phases.values()) + 64e-6 == pytest.approx(tl.busy_s)
    assert tl.busy_s == pytest.approx(296e-6)
    assert tl.window_s - tl.busy_s == pytest.approx(
        spans.graph_gap_seconds(tl, p) + 616e-6)


def test_idle_gaps_take_the_innermost_range(tmp_path):
    ctx = _ctx(tmp_path)
    got = dict(spans.idle_gaps(ctx.timeline, ctx.program))
    # [0, 60) in the first pack; [70, 126) and [570, 626) in the batch
    # ranges after gn.batch ends; the replays' 64 + 2 + 10; the outputs'
    # 10 + 10 + 2 + 10 + 8; [380, 560) and [880, 1000) outside any range.
    assert got == pytest.approx({
        "gn.batch.pack": 60e-6, "portbench.batch": 112e-6,
        "gn.step.replay": 152e-6, "gn.step.outputs": 80e-6,
        "host other": 300e-6})


def test_without_the_programs_tracing(tmp_path):
    ctx = _ctx(tmp_path, program=False)
    assert ctx.program.spans == [] and ctx.program.markers == []
    for m in METRICS:
        assert importlib.import_module("metrics." + m).read(ctx) is None, m
    want = ctx.timeline.breakdown()["idle_gaps"]
    assert spans.idle_gaps(ctx.timeline, ctx.program) == want
    assert spans.idle_gaps(ctx.timeline, None) == want
    assert dict(want) == pytest.approx({
        "portbench.batch": 172e-6, "portbench.step": 252e-6,
        "host other": 300e-6})


def test_steps_cut_by_the_window_are_left_out():
    def p(*phases):
        return spans.Program([], [(float(i), ph)
                                  for i, ph in enumerate(phases)])
    whole = ["batch", "forward", "backward", "optimizer", "metrics", "end"]
    assert len(p("metrics", "end", *whole, "batch", "forward").steps()) == 1
    assert [ph for _, ph in p("optimizer", "metrics", "end", *whole[1:])
            .steps()[0]] == whole[1:]
    assert p().steps() == [] and p("forward", "backward").steps() == []


def test_a_sub_phase_marker_reads_its_own_time(tmp_path):
    """A marker of another name (``gn_phase_encoder`` inside the forward)
    is a sub-phase: it runs to the next marker of any name and leaves the
    six phases, the steps and the launch count as they were."""
    def sub(o):
        return [_x("kernel", "gn_phase_encoder()", o + 202, o + 204)]
    plain = _ctx(tmp_path)
    ctx = _ctx(tmp_path, extra=sub)
    assert len(ctx.program.steps()) == 2
    assert ctx.program.sub_intervals() == [(202.0, 250.0, "encoder"),
                                           (702.0, 750.0, "encoder")]
    got = spans.phase_seconds(ctx.timeline, ctx.program)
    want = spans.phase_seconds(plain.timeline, plain.program)
    # [202, 250) holds its own marker 2 and the forward kernel 36 us.
    assert got == pytest.approx({**want, "encoder": 76e-6,
                                 "forward": want["forward"] + 4e-6})
    for m in ("fwd_ms_per_step", "bwd_ms_per_step", "opt_ms_per_step"):
        read = importlib.import_module("metrics." + m).read
        assert read(ctx) == pytest.approx(read(plain) + (
            0.002 if m == "fwd_ms_per_step" else 0.0)), m
    assert spans.phase_ms(ctx, "encoder") == pytest.approx(0.038)
    assert spans.phase_ms(plain, "encoder") is None
    launches = importlib.import_module("metrics.launches_per_step").read
    assert launches(ctx) == launches(plain)


def test_launches_leave_the_markers_out(tmp_path):
    """Five kernels a step: the five markers are not counted."""
    launches = importlib.import_module("metrics.launches_per_step").read
    assert launches(_ctx(tmp_path)) == 5
    assert launches(_ctx(tmp_path, program=False)) == 5


def test_device_and_span_readers_take_their_own_stretch(tmp_path):
    """A traced run reads the device from a stretch with the program's
    tracing off (``ctx.timeline``) and the program's spans and markers
    from one with it on (``ctx.program``, on its own timeline): each
    reader reads its own stretch."""
    (tmp_path / "off").mkdir()
    (tmp_path / "on").mkdir()
    off = _ctx(tmp_path / "off", program=False)
    on = _ctx(tmp_path / "on")
    ctx = SimpleNamespace(steps=2, timeline=off.timeline, program=on.program,
                          counters=on.counters)
    assert ctx.program.timeline is on.timeline
    for m in METRICS:
        read = importlib.import_module("metrics." + m).read
        assert read(ctx) == pytest.approx(read(on)), m
    for m in ("device_idle_share", "launches_per_step", "cast_ms_per_step"):
        read = importlib.import_module("metrics." + m).read
        assert read(ctx) == pytest.approx(read(off)), m
    # The markers are device operations of the stretch with the switch on.
    idle = importlib.import_module("metrics.device_idle_share").read
    assert idle(off) > idle(on)


def test_a_traced_run_switches_the_tracing_on_for_its_second_stretch(
        tmp_path, monkeypatch):
    """``measure_traced`` on the CPU, the host loop cut to a few steps:
    the first stretch's trace holds none of the program's spans, the
    second's does, the window's readings are the first's, and the switch
    is off again afterwards."""
    from harness import runner
    import graphnets_tpu_torch as port
    monkeypatch.setattr(runner, "TRACE_DIR", tmp_path)
    cell = spec.cell("sort384.host_loop")
    cell.traffic.update(trace_warm_units=1, trace_units=3)
    s = runner.prepare(cell, 2 ** 33 + 11, "cpu")
    runner.program_readings(s)
    assert not port.tracing()
    w = runner.measure_traced(s)
    assert not port.tracing()
    assert w.steps == 3 and len(w.rows) == 3 and w.recaptures == 0
    assert len(w.host_batch_s) == 3 and len(w.losses) == 6

    def names(tag):
        path = tmp_path / f"trace-{cell.name}-{tag}.json"
        return {e.get("name") for e in json.loads(path.read_text())[
            "traceEvents"] if e.get("cat") == "user_annotation"}
    assert not {n for n in names("device") if n.startswith(spans.PREFIX)}
    assert {"gn.step", "gn.batch.to_device"} <= names("program")
    assert w.program.timeline is not w.timeline
    assert {n for _, _, n in w.program.spans} >= {"gn.step",
                                                   "gn.batch.to_device"}
    ctx = SimpleNamespace(steps=w.steps, program=w.program)
    assert spans.span_ms(ctx, "gn.step") > 0
