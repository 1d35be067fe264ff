"""Readings that set a cell's limits: for each seed, the program's first
three steps against the plain reference of the configuration's model
kind (the lower readings), the control (the reference itself in the next
precision below the configuration's: TF32 for f32, fp8 for bf16) and the
kind's planted fault (its ``half_batch``) against the same reference (the
upper readings).  One process for all the seeds, so the kernels build
once.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1 2 3 ...

Prints one JSON line a seed and, last, the largest program reading and
the smallest control and fault readings of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE)]
sys.path.append(str(HERE.parent))

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from harness import checks, runner, spec
    cell = spec.cell(args.workload)
    control = CONTROL[cell.config["compute_dtype"]]
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        s = runner.prepare(cell, seed, args.device)
        prog = runner.program_readings(s)
        runner.release(s)
        t1 = time.perf_counter()
        batches = s.feed.reference_batches(runner.CHECKED_STEPS)
        ref = runner.reference_readings(s, batches)
        t2 = time.perf_counter()
        ctrl = runner.reference_readings(s, batches, control)
        half = runner.reference_readings(s, batches,
                                         keep=cell.reference().half_batch)
        row = {"seed": seed, "setup_s": t1 - t0, "reference_s": t2 - t1,
               "program": checks.gaps(prog, ref),
               "control": checks.gaps(ctrl, ref),
               "half_batch": checks.gaps(half, ref),
               "losses": {"program": prog.losses, "reference": ref.losses,
                          "scales": ref.loss_scales}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del s, batches
    summary = {"workload": args.workload, "control": control}
    for k in checks.NAMES:
        summary[k] = {
            "program_max": max(r["program"][k][0] for r in rows),
            "control_min": min(r["control"][k][0] for r in rows),
            "half_batch_min": min(r["half_batch"][k][0] for r in rows)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
