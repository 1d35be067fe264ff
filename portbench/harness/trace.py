"""Reading a ``torch.profiler`` Chrome trace: the device's operations in
the traced window, their union on the timeline, and the breakdown the
result line carries, its idle gaps labelled by what the host was doing
(``spans.idle_gaps``)."""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Dict, List, Tuple

from . import spans

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"
PHASES = ("portbench.batch", "portbench.step", "portbench.sync")
NAME_CHARS = 160


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float     # microseconds
    end: float


@dataclasses.dataclass
class Timeline:
    """The traced window (host clock, microseconds), the device operations
    that started inside it, and the host phases."""
    start: float
    end: float
    ops: List[DeviceOp]
    phases: List[Tuple[float, float, str]]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def kernels(self) -> List[DeviceOp]:
        return [o for o in self.ops if o.cat == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations, clipped to the window."""
        merged: List[List[float]] = []
        for o in sorted(self.ops, key=lambda o: o.start):
            a, b = max(o.start, self.start), min(o.end, self.end)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def device_seconds(self, match) -> float:
        return sum(o.end - o.start for o in self.ops if match(o)) * 1e-6

    def breakdown(self, program=None, top: int = 10) -> Dict[str, list]:
        """The ``top`` device operations by their time, and the ``top``
        idle gaps by the innermost host range open at each: the
        program's own (``program``, a ``spans.Program``) or the
        harness's."""
        by_name: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            by_name[o.name[:NAME_CHARS]] += (o.end - o.start) * 1e-6
        ops = [[k, v] for k, v in sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ops,
                "idle_gaps": spans.idle_gaps(self, program, top)}


def read(path) -> Timeline:
    """The timeline of the Chrome trace at ``path``, cut to the
    harness's ``portbench.window`` range."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"{path}: no {WINDOW} range in the trace")
    w = windows[0]
    start, end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    ops, phases = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS and start <= a < end:
            ops.append(DeviceOp(e["name"], e["cat"], a, b))
        elif e.get("cat") == "user_annotation" and e.get("name") in PHASES:
            phases.append((a, b, e["name"]))
    return Timeline(start, end, ops, phases)
