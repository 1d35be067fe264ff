"""One cell's traced stretch with the program's tracing switch on
(``enable_tracing``), read through the program's own spans,
phase markers and counters (``harness/spans.py``): the per-layer metrics
that read them, the device's busy and idle time split by phase and by
step, the idle gaps labelled by the innermost host range, and each
phase's device operations.

    python3 portbench/tools/spans.py --workload <cell> --seed <n>

Prints one JSON line.  The run makes the cell's set-up, checked steps and
two traced stretches as ``run.py --trace 1`` does (the switch off, then
on), reads the second, and leaves out the reference:
``python3 portbench/run.py ... --trace 1`` runs the same and checks it.
"""

import argparse
import bisect
import importlib
import json
import sys
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE)]
sys.path.append(str(HERE.parent))

METRICS = ("fwd_ms_per_step", "bwd_ms_per_step", "opt_ms_per_step",
           "graph_gap_ms_per_step", "step_host_ms", "copy_in_mb_per_step",
           "batch_to_device_ms")


def ops_by_phase(tl, program, steps: int, top: int = 8) -> dict:
    """Device ms a step of each phase's operations (by the phase their
    start falls in; "outside" between steps): the total, the casts and
    copies (as ``cast_ms_per_step`` counts them) and the ``top`` names."""
    phases = sorted(program.intervals())
    starts = [a for a, _, _ in phases]
    total, cast = defaultdict(float), defaultdict(float)
    names = defaultdict(lambda: defaultdict(float))
    for o in tl.ops:
        i = bisect.bisect_right(starts, o.start) - 1
        phase = phases[i][2] if i >= 0 and o.start < phases[i][1] \
            else "outside"
        ms = (o.end - o.start) * 1e-3 / steps
        total[phase] += ms
        names[phase][o.name[:80]] += ms
        if o.cat == "gpu_memcpy" or "copy_kernel" in o.name:
            cast[phase] += ms
    return {p: {"ms": total[p], "cast_and_copy_ms": cast[p],
                "top": sorted(names[p].items(), key=lambda kv: -kv[1])[:top]}
            for p in total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from harness import runner, spans, spec
    cell = spec.cell(args.workload)
    s = runner.prepare(cell, args.seed, args.device)
    runner.program_readings(s)
    w = runner.measure_traced(s)
    program = w.program
    tl = program.timeline
    ctx = SimpleNamespace(steps=w.steps, timeline=tl, program=program,
                          counters=w.counters)
    whole = len(program.steps())
    phase_s = spans.phase_seconds(tl, program)
    in_steps = sum(v for k, v in phase_s.items() if k in spans.PHASES)
    gap_s = spans.graph_gap_seconds(tl, program)
    idle_s = tl.window_s - tl.busy_s
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "steps": w.steps,
        "whole_steps": whole, "window_s": tl.window_s, "busy_s": tl.busy_s,
        "metrics": {m: importlib.import_module("metrics." + m).read(ctx)
                    for m in METRICS},
        "counters_per_step": {k: None if v is None else v / w.steps
                              for k, v in w.counters.items()},
        "phases_busy_s": phase_s,
        "busy_outside_steps_s": tl.busy_s - in_steps,
        "graph_gap_s": gap_s, "idle_between_steps_s": idle_s - gap_s,
        "idle_gaps": spans.idle_gaps(tl, program),
        "ops_by_phase": ops_by_phase(tl, program, max(whole, 1)),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
