"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  With
``--trace 0`` the result line holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from two profiled stretches:
one with the program's own tracing switch off, for the device's readings,
and one with it on (``enable_tracing``: its spans and phase markers), for
the readers of those (``harness/runner.py`` ``measure_traced``).  A run
with no card, or with fewer cards than the cell asks for, exits with
code 3 and prints no result: it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Every cache the program or torch may write, at fixed paths inside the
# checkout, so only a checkout's first run builds.
CACHE = ROOT / "build" / "portbench-cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# The harness's packages first (the script's directory), the program
# (``graphnets_tpu_torch`` at the root of the checkout) after them.
sys.path[:0] = [str(HERE)]
sys.path.append(str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from harness import runner, spec
    cell = next((w for w in spec.benchmark(ROOT)["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    return runner.run(spec.cell(args.workload), args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)


if __name__ == "__main__":
    sys.exit(main())
