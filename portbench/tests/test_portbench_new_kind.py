"""A new model kind needs new files only.  Into a copy of ``portbench/``
the test writes a toy kind (one linear map of rows to class logits under
a soft-target cross-entropy) as new files: ``models/toy.py``,
``reference/toy.py`` (its own forward pass, loss and planted fault),
``generators/toy_rows.py``, a configuration, a traffic mix, a cell's
limits and the entries of ``BENCHMARK.json``; no file of the copy is
edited.  The copy's own harness then runs the cell on the CPU: a sound run
is correct against the toy's reference and the plain ``gn`` reference is
never loaded; with the optimizer's step broken (the state left unchanged)
it is not; and ``tools/calibrate.py`` reads the toy's planted fault
(``half_batch``) and control (TF32) over its limits."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

FILES = {
    "models/toy.py": '''
"""The toy kind: one linear map of rows to class logits."""
import math
import torch


def build(port, model, device):
    return torch.nn.Sequential(torch.nn.Linear(model["d_in"],
                                               model["d_out"],
                                               device=device))


def make_weights(shapes, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return {n: torch.randn(s, generator=gen, device=device)
            / math.sqrt(s[-1]) for n, s in shapes.items()}


def step_flops(model, rows):
    return 6.0 * rows[0] * model["d_in"] * model["d_out"]
''',
    "reference/toy.py": '''
"""The toy kind's plain reference: logits ``x @ w.T + b``, the mean
soft-target cross-entropy over rows."""
import torch

from . import training


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF).view(
        torch.float32)


def train(params, batches, model, lr, precision="f32", keep=None):
    r = _tf32 if precision == "tf32" else (lambda t: t)

    def step_loss(p, x, y, keep_t):
        logits = r(x) @ r(p["0.weight"]).t() + p["0.bias"]
        per_row = -(y * torch.log_softmax(logits, -1)).sum(-1)
        scale = float(per_row.detach().abs().mean())
        if keep_t is not None:
            per_row = per_row[keep_t]
        return per_row.mean(), scale
    return training.train(params, batches, step_loss, lr, keep)


def half_batch(x):
    return torch.arange(x.shape[0], device=x.device) < x.shape[0] // 2
''',
    "generators/toy_rows.py": '''
"""``batches`` batches of ``rows`` standard normal rows and soft targets,
drawn from the seed and cycled; each step is the port's optimizer on the
toy model."""
import torch


class Feed:
    steps_per_unit = 1
    host_batch_s = None

    def __init__(self, port, config, traffic, seed, device):
        self.port = port
        m, n = config["model"], traffic["rows"]
        gen = torch.Generator(device=device).manual_seed(seed)
        self.batches = [
            (torch.randn(n, m["d_in"], generator=gen, device=device),
             torch.softmax(torch.randn(n, m["d_out"], generator=gen,
                                       device=device), -1))
            for _ in range(traffic["batches"])]
        self.rows, self.next = (n, n, 1), 0

    def build_step(self, model, optimizer):
        def step(x, y):
            optimizer.zero_grad()
            per_row = -(y * torch.log_softmax(model(x), -1)).sum(-1)
            loss = per_row.mean()
            loss.backward()
            optimizer.step()
            return {"loss": loss.detach()}
        self.step = self.port.capture_step(step)
        return self.step

    def _step(self):
        x, y = self.batches[self.next % len(self.batches)]
        self.next += 1
        return self.step(x, y)["loss"]

    def prefix_step(self):
        return self._step()

    def begin_window(self):
        pass

    def unit(self, mark):
        loss = self._step()
        mark()
        return [(loss, 1)]

    def window_rows(self, steps):
        return [self.rows] * steps

    def release(self):
        del self.step

    def reference_batches(self, k):
        return self.batches[:k]
''',
    "configs/toy-linear.json": {
        "name": "toy-linear", "model": {"kind": "toy", "d_in": 64,
                                        "d_out": 8},
        "optimizer": {"kind": "adamw", "lr": 0.001, "betas": [0.9, 0.999],
                      "eps": 1e-08, "weight_decay": 0.0001},
        "compute_dtype": "float32", "feature_dtype": "float32",
        "tf32": False, "reduced": []},
    "traffic/toy_rows.json": {"generator": "toy_rows", "rows": 256,
                              "batches": 4, "in_flight": 0,
                              "trace_warm_units": 1, "trace_units": 2},
    "cells/toy.rows.json": {"limits": {"loss_gap_first": 1e-5,
                                       "grad_gap": 1e-4,
                                       "change_gap": 0.05}},
}

DRIVE = '''
import io, json, sys, time
import torch
sys.path[:0] = [sys.argv[1]]
sys.path.append(sys.argv[2])
from harness import runner, spec
if sys.argv[3] == "unchanged":
    torch.optim.AdamW.step = lambda self, closure=None: None
out, err = io.StringIO(), io.StringIO()
rc = runner.run(spec.cell("toy.rows"), 2 ** 33 + 5, 0.05, False, "cpu",
                time.perf_counter(), out, err)
print(json.dumps({"rc": rc, "err": err.getvalue()[-2000:],
                  "result": json.loads(out.getvalue().splitlines()[-1]),
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith("reference"))}))
'''


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A copy of ``portbench/`` and ``BENCHMARK.json`` with the toy kind
    added as new files, and the repository's files it left unchanged."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    for rel, body in FILES.items():
        path = root / "portbench" / rel
        assert not path.exists(), rel
        path.write_text(body if isinstance(body, str)
                        else json.dumps(body))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy-linear", "source": "https://arxiv.org/abs/1806.01261",
        "file": "portbench/configs/toy-linear.json", "reduced": [],
        "why": "a toy kind"})
    bench["workloads"].append({"name": "toy.rows", "config": "toy-linear",
                               "traffic": "toy_rows", "chips": 1,
                               "why": "a toy kind"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    return root


def _python(root, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, *args], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return [json.loads(line) for line in r.stdout.splitlines()]


def _run(root, fault):
    (root / "drive.py").write_text(DRIVE)
    got, = _python(root, "drive.py", str(root / "portbench"), str(ROOT),
                   fault)
    assert got["rc"] == 0, got["err"]
    return got


def test_sound_run_is_correct_against_its_own_reference(copy):
    got = _run(copy, "none")
    assert got["result"]["correct"] is True, got["result"]["checks"]
    assert "reference.toy" in got["modules"]
    assert "reference.gn" not in got["modules"]
    assert {"train_edges_per_s", "setup_s"} <= set(got["result"]["metrics"])


def test_state_left_unchanged_is_not_correct(copy):
    got = _run(copy, "unchanged")
    assert got["result"]["correct"] is False
    assert got["result"]["checks"]["change_gap"]["value"] > 0.9


def test_calibrate_reads_its_own_fault_and_control(copy):
    *rows, summary = _python(copy, "portbench/tools/calibrate.py",
                             "--workload", "toy.rows", "--device", "cpu",
                             "--seeds", "1", "2", "3")
    assert summary["control"] == "tf32" and len(rows) == 3
    limits = FILES["cells/toy.rows.json"]["limits"]
    for k, limit in limits.items():
        assert summary[k]["program_max"] < limit, k
    assert any(summary[k]["half_batch_min"] > limit
               for k, limit in limits.items())
    assert any(summary[k]["control_min"] > limit
               for k, limit in limits.items())
