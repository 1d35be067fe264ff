"""Reading the program's own tracing from a ``torch.profiler`` Chrome
trace: the ``gn.*`` host ranges that ``graphnets_tpu_torch`` opens while
its tracing switch is on (``GRAPHNETS_TPU_TORCH_TRACE=1``), and the device
phase markers of its step bodies.

A marker is the empty kernel ``gn_phase_<name>`` (the port's
``csrc/phase_marker.cu``).  The six ``PHASES`` are the step's phases: a
phase runs from its marker to the next phase's, and a step from its first
marker to its ``end``.  Any other name is a sub-phase (a stage of a model,
say): it runs from its marker to the next marker of any name, inside the
phase it falls in, which it neither ends nor splits.  A reader of a new
marker is a ``metrics/<name>.py`` that calls ``phase_ms(ctx, name)``.
A trace without them (the switch off, or a program that has none) reads
as empty: every reading is ``None`` and the idle gaps keep the harness's
labels."""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

if TYPE_CHECKING:
    from .trace import Timeline

PREFIX = "gn."
PHASES = ("batch", "forward", "backward", "optimizer", "metrics", "end")
MARKER = "gn_phase_"


def _marker(e: dict) -> Optional[str]:
    """The phase or sub-phase ``e`` marks, or ``None`` where it is no
    marker."""
    name = e.get("name", "")
    if e.get("cat") != "kernel" or not name.startswith(MARKER):
        return None
    return name[len(MARKER):].split("(")[0] or None


def _covered(merged: List[Tuple[float, float]], starts: List[float],
             a: float, b: float) -> float:
    """The length of ``[a, b)`` that the sorted, disjoint ``merged``
    intervals cover."""
    t = 0.0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(merged) and merged[i][0] < b:
        t += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return t


@dataclasses.dataclass
class Program:
    """The program's host ranges (``(start, end, name)``, host clock) and
    markers of phases and sub-phases (``(device start, name)``) that start
    inside the traced window, in time order, and the timeline of that
    window (its device operations, markers included)."""
    spans: List[Tuple[float, float, str]]
    markers: List[Tuple[float, str]]
    timeline: Optional[Timeline] = None

    def steps(self) -> List[List[Tuple[float, str]]]:
        """The phase markers of each whole step, from its first phase (the
        earliest phase any marker names: ``batch`` where the step draws
        its own batch) to its ``end``; a step the window's edges cut is
        left out."""
        marks = [(t, ph) for t, ph in self.markers if ph in PHASES]
        if not marks:
            return []
        first = min(PHASES.index(ph) for _, ph in marks)
        out, cur = [], []
        for t, phase in marks:
            i = PHASES.index(phase)
            if i == first:
                cur = [(t, phase)]
            elif cur and i > PHASES.index(cur[-1][1]):
                cur.append((t, phase))
                if phase == "end":
                    out.append(cur)
                    cur = []
            else:
                cur = []
        return out

    def intervals(self) -> List[Tuple[float, float, str]]:
        """Each phase of each whole step: ``(start, end, phase)``."""
        return [(a, b, p) for step in self.steps()
                for (a, p), (b, _) in zip(step, step[1:])]

    def sub_intervals(self) -> List[Tuple[float, float, str]]:
        """Each sub-phase inside a whole step, from its marker to the next
        marker of any name: ``(start, end, name)``."""
        bounds = [(s[0][0], s[-1][0]) for s in self.steps()]
        firsts = [a for a, _ in bounds]
        out = []
        for (t, name), (t2, _) in zip(self.markers, self.markers[1:]):
            i = bisect.bisect_right(firsts, t) - 1
            if name not in PHASES and i >= 0 and t < bounds[i][1]:
                out.append((t, t2, name))
        return out

    def span_seconds(self, name: str) -> float:
        return sum(b - a for a, b, n in self.spans if n == name) * 1e-6


def read(path, tl: Timeline) -> Program:
    """The program's spans and markers in the Chrome trace at ``path``,
    within ``tl``'s window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, markers = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        if not tl.start <= a < tl.end:
            continue
        if e.get("cat") == "user_annotation" and e.get(
                "name", "").startswith(PREFIX):
            spans.append((a, a + float(e["dur"]), e["name"]))
        elif _marker(e) is not None:
            markers.append((a, _marker(e)))
    return Program(sorted(spans), sorted(markers), tl)


def of(ctx) -> Optional[Program]:
    """The run's ``Program``, where the run read one and it holds any of
    the program's spans or markers."""
    p = getattr(ctx, "program", None)
    return p if p is not None and (p.spans or p.markers) else None


def phase_seconds(tl: Timeline, p: Program) -> Dict[str, float]:
    """Busy device seconds in each phase and each sub-phase, summed over
    the whole steps: the union of the device's operations clipped to each
    (a sub-phase's time is also its phase's)."""
    merged = tl.busy_intervals()
    starts = [a for a, _ in merged]
    out: Dict[str, float] = defaultdict(float)
    for a, b, phase in p.intervals() + p.sub_intervals():
        out[phase] += _covered(merged, starts, a, b) * 1e-6
    return dict(out)


def graph_gap_seconds(tl: Timeline, p: Program) -> float:
    """Device idle seconds inside the whole steps, from each step's first
    marker to its ``end``: the gaps between a replayed graph's nodes."""
    merged = tl.busy_intervals()
    starts = [a for a, _ in merged]
    return sum((s[-1][0] - s[0][0]) - _covered(merged, starts, s[0][0],
                                               s[-1][0])
               for s in p.steps()) * 1e-6


def phase_ms(ctx, phase: str) -> Optional[float]:
    """Busy device milliseconds a whole step in ``phase``, a phase or a
    sub-phase, on the timeline the markers were read from."""
    p = of(ctx)
    tl = p.timeline if p is not None else None
    if tl is None or not p.steps():
        return None
    busy = phase_seconds(tl, p)
    if phase not in busy:       # no whole step holds its marker
        return None
    return busy[phase] * 1e3 / len(p.steps())


def span_ms(ctx, name: str) -> Optional[float]:
    """Host milliseconds a step in the program's span ``name``."""
    p = of(ctx)
    if p is None or not ctx.steps or name not in {n for _, _, n in p.spans}:
        return None
    return p.span_seconds(name) * 1e3 / ctx.steps


def idle_gaps(tl: Timeline, p: Optional[Program], top: int = 10) -> list:
    """The traced window's idle device seconds by the innermost host range
    (the program's or the harness's) open at each gap's midpoint, ranked:
    ``Timeline.breakdown()``'s ``idle_gaps`` where the program has no
    ranges."""
    # By start, an outer range before the inner one that starts with it.
    ranges = sorted(tl.phases + (p.spans if p is not None else []),
                    key=lambda r: (r[0], -r[1]))
    starts = [a for a, _, _ in ranges]
    by: Dict[str, float] = defaultdict(float)
    for a, b in tl.idle_gaps():
        t = (a + b) / 2
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ranges[i][1] < t:
            i -= 1
        by[ranges[i][2] if i >= 0 else "host other"] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]

