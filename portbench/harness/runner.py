"""One run of one cell: set-up (the model, its weights from the seed, the
traffic, the captured step and its first three steps, which the checks
compare), then the measured window or, with tracing, a profiled stretch,
then the comparison with the plain reference of the configuration's model
kind (``reference/<kind>.py``) and the result line."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from reference.training import Readings

from . import checks, spans, spec
from . import trace as trace_mod
from .peaks import peaks

FORBIDDEN = ("jax", "jaxlib", "flax", "graphnets_tpu")
CHECKED_STEPS = 3
TRACE_DIR = spec.ROOT / "build" / "portbench"


def derive_seeds(seed: int, n: int = 2) -> List[int]:
    """``n`` independent 63-bit seeds from the run's ``--seed`` (any whole
    number): the weights', then the traffic's."""
    ss = np.random.SeedSequence(seed & (2 ** 64 - 1))
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s in ss.spawn(n)]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """A CUDA event recorded after every step on the training stream; a
    step's time is the interval from the previous step's event (the
    window's start for the first), so it holds whatever the stream waited
    for.  With ``in_flight`` the host waits for the event that many steps
    back before it goes on.  On the CPU (the tests) the host clock stands
    in."""

    def __init__(self, device: torch.device, in_flight: int = 0):
        self.cuda = device.type == "cuda"
        self.in_flight = in_flight
        self.marks: list = []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        self.first = self._now()

    def mark(self) -> None:
        self.marks.append(self._now())
        if self.cuda and self.in_flight and len(self.marks) > self.in_flight:
            self.marks[-1 - self.in_flight].synchronize()

    def step_ms(self) -> List[float]:
        ticks = [self.first] + self.marks
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(ticks, ticks[1:])]
        return [a.elapsed_time(b) for a, b in zip(ticks, ticks[1:])]


@dataclasses.dataclass
class Session:
    cell: spec.Cell
    port: object
    device: torch.device
    model: Optional[torch.nn.Module]
    optimizer: Optional[torch.optim.Optimizer]
    feed: object
    w0: Dict[str, torch.Tensor]
    lr: float
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)


def prepare(cell: spec.Cell, seed: int, device) -> Session:
    """Build the cell's model, weights, traffic and captured step."""
    t0 = time.perf_counter()
    import graphnets_tpu_torch as port
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
    phases = {"import_and_init": time.perf_counter() - t0}
    cfg = cell.config
    if cfg.get("tf32") is False and device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    w_seed, t_seed = derive_seeds(seed)
    model = cell.model().build(port, cfg["model"], device)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    w0 = cell.model().make_weights(shapes, w_seed, device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w0[n])
    sync(device)
    phases["model_and_weights"] = time.perf_counter() - t0 - sum(
        phases.values())
    opt = cfg["optimizer"]
    if opt["kind"] != "adamw":
        raise ValueError(f"optimizer {opt['kind']!r} is not AdamW")
    optimizer = port.adamw(model.parameters(), opt["lr"])
    feed = cell.generator().Feed(port, cfg, cell.traffic, t_seed, device)
    feed.build_step(model, optimizer)
    sync(device)
    phases["traffic"] = time.perf_counter() - t0 - sum(phases.values())
    return Session(cell, port, device, model, optimizer, feed, w0,
                   opt["lr"], phases)


def program_readings(s: Session, k: int = CHECKED_STEPS) -> Readings:
    """The program's first ``k`` steps through the window's own call:
    each loss, the first gradient as the optimizer got it (its first
    moment after one step over ``1 - beta1``) and each parameter's change
    after the ``k`` steps, by leaf."""
    params = {n: p for n, p in s.model.named_parameters() if p.numel()}
    beta1 = s.cell.config["optimizer"]["betas"][0]
    losses, grads = [], None
    for i in range(k):
        losses.append(s.feed.prefix_step().float().reshape(()))
        if i == 0:
            # A step that never reached the optimizer left it no state:
            # the gradient it got is nought.
            grads = torch.stack([
                (s.optimizer.state[p]["exp_avg"] / (1 - beta1)).norm()
                if "exp_avg" in s.optimizer.state.get(p, {})
                else torch.zeros((), device=p.device)
                for p in params.values()])
    with torch.no_grad():
        change = torch.stack([(p - s.w0[n]).norm()
                              for n, p in params.items()])
    vals = torch.cat([torch.stack(losses), grads, change]).tolist()
    names, m = list(params), len(params)
    return Readings(vals[:k], dict(zip(names, vals[k:k + m])),
                    dict(zip(names, vals[k + m:])))


def release(s: Session) -> None:
    """Drop the program's state (model, optimizer, captured graphs and
    their pool) so the reference has the card to itself."""
    s.feed.release()
    s.model = s.optimizer = None
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(s: Session, batches, precision: str = "f32",
                       keep=None) -> Readings:
    """The plain reference of the cell's model kind over ``batches`` from
    the program's initial weights; ``keep`` plants a fault (the kind's
    ``half_batch``)."""
    return s.cell.reference().train(s.w0, batches, s.cell.config["model"],
                                    s.lr, precision, keep)


COPY_IN = ("copy_in_bytes", "copy_in_tensors")


def counters(feed) -> Dict[str, Optional[float]]:
    """The program's counters as they stand: the feed's ``counters()``
    where it has one, otherwise the captured step's copy-in counters
    (``None`` where the program has no such counter)."""
    if hasattr(feed, "counters"):
        return dict(feed.counters())
    return {k: getattr(feed.step, k, None) for k in COPY_IN}


def _change(before: dict, after: dict) -> Dict[str, Optional[float]]:
    return {k: None if after[k] is None or before.get(k) is None
            else after[k] - before[k] for k in after}


@dataclasses.dataclass
class Window:
    seconds: float
    steps: int
    step_ms: List[float]
    losses: list
    rows: list
    host_batch_s: Optional[List[float]]
    peak_bytes: int
    recaptures: int
    timeline: Optional[trace_mod.Timeline] = None
    program: Optional[spans.Program] = None
    counters: Dict[str, Optional[float]] = dataclasses.field(
        default_factory=dict)


def _units(s: Session, clock: Clock, n: Optional[int], seconds: float
           ) -> tuple:
    out, steps = [], 0
    t0 = time.perf_counter()
    with s.port.annotate("portbench.window"):
        while True:
            out += s.feed.unit(clock.mark)
            steps += s.feed.steps_per_unit
            if (n is not None and steps >= n * s.feed.steps_per_unit) or (
                    n is None and time.perf_counter() - t0 >= seconds):
                break
        sync(s.device)
    return out, steps, time.perf_counter() - t0


def _close(s: Session, steps: int) -> tuple:
    """What the window's readers take from the feed and the card once it
    has closed: each step's rows, the host's batching times, the peak."""
    return (s.feed.window_rows(steps),
            s.feed.window_batch_s(steps)
            if hasattr(s.feed, "window_batch_s") else None,
            torch.cuda.max_memory_allocated(s.device)
            if s.device.type == "cuda" else 0)


def measure(s: Session, seconds: float) -> Window:
    """The measured window: whole units until ``seconds`` have passed on
    the host clock, ended by a device sync."""
    clock = Clock(s.device, s.cell.traffic.get("in_flight", 0))
    captures = s.feed.step.captures
    sync(s.device)
    s.feed.begin_window()
    clock.start()
    losses, steps, wall = _units(s, clock, None, seconds)
    return Window(wall, steps, clock.step_ms(), losses, *_close(s, steps),
                  s.feed.step.captures - captures)


def _stretch(s: Session, clock: Clock, tracing: bool, tag: str) -> tuple:
    """``trace_warm_units`` units with the program's tracing switch set to
    ``tracing``, then ``trace_units`` units under ``torch.profiler``, its
    Chrome trace written inside the checkout.  Returns the stretch's
    losses, steps, wall time, timeline, trace path, program counters'
    change and the captures it made beyond the one that switching the
    tracing asks for."""
    from torch.profiler import ProfilerActivity, profile
    t = s.cell.traffic
    switched = int(s.port.tracing() != tracing)
    s.port.enable_tracing(tracing)
    c0 = s.feed.step.captures
    for _ in range(t["trace_warm_units"]):
        s.feed.unit(clock.mark)
    sync(s.device)
    c1 = s.feed.step.captures
    s.feed.begin_window()
    before = counters(s.feed)
    activities = [ProfilerActivity.CPU]
    if s.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        losses, steps, wall = _units(s, clock, t["trace_units"], 0.0)
    change = _change(before, counters(s.feed))
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"trace-{s.cell.name}-{tag}.json"
    prof.export_chrome_trace(str(path))
    extra = max(0, c1 - c0 - switched) + s.feed.step.captures - c1
    return losses, steps, wall, trace_mod.read(path), path, change, extra


def measure_traced(s: Session) -> Window:
    """Two traced stretches of the same number of steady units.  The
    first runs with the program's tracing switch off, as an untraced run
    does: the device's timeline, the program counters' change, the rows, the
    host's batching times and the peak are read from it, so no reading of
    the device pays for the program's host spans.  The second runs with
    the switch on (``enable_tracing``: captured anew with the phase
    markers): the program's spans and markers are read from it, with its
    own timeline (``Program.timeline``)."""
    clock = Clock(s.device, s.cell.traffic.get("in_flight", 0))
    clock.start()
    losses, steps, wall, tl, _, change, extra = _stretch(
        s, clock, False, "device")
    closed = _close(s, steps)
    more, _, _, tl_p, path, _, extra_p = _stretch(s, clock, True, "program")
    s.port.enable_tracing(False)
    return Window(wall, steps, [], losses + more, *closed, extra + extra_p,
                  tl, spans.read(path, tl_p), change)


def _failed(losses) -> int:
    bad = 0
    for value, steps in losses:
        if not math.isfinite(float(value)):
            bad += steps
    return bad


def _power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _number(x: float):
    return x if math.isfinite(x) else str(x)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, out=None, err=None) -> int:
    """One run of ``cell``; prints the result line on ``out`` and the
    compared numbers as the last lines of ``err``.  Returns the exit
    code."""
    out, err = out or sys.stdout, err or sys.stderr
    t_prepare = time.perf_counter()
    s = prepare(cell, seed, device)
    s.phases = {"interpreter_and_torch": t_prepare - t_start, **s.phases}
    t_steps = time.perf_counter()
    prog = program_readings(s)
    t_window = time.perf_counter()
    s.phases["capture_and_checked_steps"] = t_window - t_steps
    w = measure_traced(s) if traced else measure(s, seconds)
    cuda = s.device.type == "cuda"
    kind = torch.cuda.get_device_name(s.device) if cuda else "cpu"
    ctx = SimpleNamespace(
        config=cell.config, traffic=cell.traffic, peaks=peaks(kind),
        steps=w.steps, window_s=w.seconds, step_ms=w.step_ms, rows=w.rows,
        step_flops=[cell.model().step_flops(cell.config["model"], r)
                    for r in w.rows],
        setup_s=t_window - t_start, peak_bytes=w.peak_bytes,
        timeline=w.timeline, program=w.program, counters=w.counters,
        host_batch_s=w.host_batch_s)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = importlib.import_module("metrics." + m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = _failed(w.losses)

    release(s)
    t_ref = time.perf_counter()
    batches = s.feed.reference_batches(CHECKED_STEPS)
    ref = reference_readings(s, batches)
    found = checks.gaps(prog, ref)
    ok, compared = checks.judge(found, cell.checks["limits"])
    compared["recaptures"] = {"value": w.recaptures, "limit": 0}
    compared["failed_steps"] = {"value": failed, "limit": 0}
    correct = ok and w.recaptures == 0 and failed == 0 and w.steps > 0

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"refusing to report: the process holds {loaded}", file=err)
        return 4
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(w.peak_bytes)}
    result = {"correct": correct, "attempted": w.steps, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and w.timeline is not None:
        dev["busy_s"] = w.timeline.busy_s
        dev["window_s"] = w.timeline.window_s
        # The device's operations from the stretch with the switch off;
        # the idle gaps from the one with it on, labelled by its spans.
        result["breakdown"] = {
            "device_ops": w.timeline.breakdown()["device_ops"],
            "idle_gaps": spans.idle_gaps(w.program.timeline, w.program)}
        limit = _power_limit() if cuda else None
        if limit:
            dev["power_limit"] = limit
    result["checks"] = {k: {"value": _number(float(v["value"])),
                            "limit": v["limit"]}
                        for k, v in compared.items()}
    where = {k: v[1] for k, v in found.items()}
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in s.phases.items())
        + f"; the reference {time.perf_counter() - t_ref:.3f}", file=err)
    for k, v in compared.items():
        print(f"check {k} {v['value']} limit {v['limit']}"
              + (f" ({where[k]})" if k in where else ""), file=err)
    print(json.dumps(result), file=out, flush=True)
    return 0
