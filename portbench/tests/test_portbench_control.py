"""The control comes out as not correct: the plain reference in the next
precision below the configuration's (TF32 for the f32 recipe, fp8 for the
bf16 large graph and mini-batches), put in the program's place, reads over
at least one of the cell's limits on three seeds.  On the CPU at sizes a
test run can hold (the recipe at its own size; the large graph cut to
2,048 nodes and 32,768 edges; the mini-batches at their own size, 4 of
them made); marked ``cuda``, at every cell's own size on the card."""

import pytest
import torch

from harness import checks, runner, spec

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def _control_fails(name, seed, device, small=False):
    cell = spec.cell(name)
    if small and cell.traffic["generator"] == "single_graph":
        cell.traffic.update(num_nodes=2048, num_edges=32768)
    if small and cell.traffic["generator"] == "uniform_batches":
        cell.traffic.update(batches=4)
    s = runner.prepare(cell, seed, device)
    runner.program_readings(s)        # draws the checked steps' batches
    runner.release(s)
    batches = s.feed.reference_batches(runner.CHECKED_STEPS)
    ref = runner.reference_readings(s, batches)
    ctrl = runner.reference_readings(
        s, batches, CONTROL[cell.config["compute_dtype"]])
    ok, compared = checks.judge(checks.gaps(ctrl, ref),
                                cell.checks["limits"])
    return not ok, compared


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["sort384.device_loop", "sort384.host_loop",
                                  "lg256.one_graph", "lg256.batch8x128"])
def test_control_fails_on_the_cpu(name, seed):
    failed, compared = _control_fails(name, seed, "cpu", small=True)
    assert failed, compared


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", [w["name"]
                                  for w in spec.benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control at the cell's size")
    failed, compared = _control_fails(name, seed, "cuda")
    assert failed, compared
