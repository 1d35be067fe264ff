"""The port's tracing switch (``GRAPHNETS_TPU_TORCH_TRACE``,
``pt.enable_tracing``): the ``gn.*`` host spans of the step, capture and
batch paths, nested as documented, and none with the switch off; the
switch's place in ``CapturedStep``'s key; on the card, the device phase
markers of a replayed step in order, the step's kernels unchanged by
them, and the copy-in counters.

The file imports neither JAX nor the JAX package, so its card tests run
where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_tracing.py -q -m cuda
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu_torch.utils.profiling import PHASES
from graphnets_tpu_torch.utils.tree import tensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ("gn.train.forward", "gn.train.backward", "gn.train.optimizer",
         "gn.train.metrics")


@pytest.fixture
def switch():
    """Sets the tracing switch for one test and puts it back after."""
    was = pt.tracing()
    yield pt.enable_tracing
    pt.enable_tracing(was)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (device phase markers and CUDA "
                    "graphs exist only on the card)")
    return torch.device("cuda")


def _spans(log_dir):
    """``(name, start, end)`` of every ``gn.*`` host range in the one
    Chrome trace under ``log_dir``, in start order."""
    (f,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, f)) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("gn.")),
                  key=lambda s: s[1])


def _sort_model(cfg, device, dims=16):
    return pt.EncodeProcessDecode((0, cfg.vocab_size, 0), (dims,) * 3,
                                  (2, 2, 0), device=device,
                                  generator=torch.Generator().manual_seed(0))


def _node_classification_args():
    rng = np.random.default_rng(2)
    n = 120
    g = pt.LargeGraph.from_coo(rng.integers(0, n, 600),
                               rng.integers(0, n, 600),
                               rng.normal(size=(n, 8)).astype(np.float32),
                               rng.integers(0, 3, n))
    b = pt.NeighborSampler(g, (3,), 8, seed=1, emit_node_ids=True,
                           device="cpu").sample(np.arange(8))
    return (b.graph, b.node_ids, b.labels, b.label_mask, b.seed_local_idx,
            pt.device_feature_table(g, device="cpu"))


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_spans_of_the_step_and_batch_paths(tmp_path, switch, on):
    """With the switch on, the batch paths (bucketed and uniform), a
    ``CapturedStep`` call (eager on the CPU), its warm-up, the sort device
    step and the node-classification step open every ``gn.*`` span a CPU
    run reaches, each child inside its parent and the step's phases in
    order; with it off, none."""
    switch(on)
    cfg = pt.SortTaskConfig()
    rng = np.random.default_rng(0)
    model = _sort_model(cfg, "cpu")
    step = pt.capture_step(pt.make_train_step(model,
                                              pt.adamw(model.parameters())))
    state = pt.TrainState(model, pt.adamw(model.parameters()), 0,
                          (torch.Generator().manual_seed(1),))
    device_step = pt.make_sort_device_step(state, cfg, pt.sort_pad_spec(cfg))
    nc_model = pt.EncodeProcessDecode((0, 8, 0), (16,) * 3, (1, 3, 0),
                                      device="cpu")
    nc_step = pt.make_node_classification_step(
        nc_model, pt.adam(nc_model.parameters()), 3)
    nc_args = _node_classification_args()
    with pt.trace(str(tmp_path / "trace")):
        x, y = pt.get_batch(rng, cfg, pt.sort_pad_spec(cfg), device="cpu")
        pt.get_batch(rng, cfg, pt.sort_pad_spec(cfg, uniform=True),
                     device="cpu")
        step.warm_up(x, y)
        step(x, y)
        device_step()
        nc_step(*nc_args)
    spans = _spans(tmp_path / "trace")
    if not on:
        assert spans == []
        return
    names = {n for n, _, _ in spans}
    assert names == {"gn.batch", "gn.batch.pack", "gn.batch.to_device",
                     "gn.step", "gn.step.lookup", "gn.step.warm_up",
                     "gn.train.batch", *TRAIN}
    # Four batch() calls, pack then to_device inside each; the warm-up's
    # two steps; the CapturedStep call's lookup, then the four phases.
    for parent, count, children in (
            ("gn.batch", 4, ["gn.batch.pack", "gn.batch.to_device"]),
            ("gn.step.warm_up", 1, [*TRAIN, *TRAIN]),
            ("gn.step", 1, ["gn.step.lookup", *TRAIN])):
        calls = [(a, b) for n, a, b in spans if n == parent]
        assert len(calls) == count, parent
        for a, b in calls:
            assert [n for n, s, e in spans if a <= s and e <= b
                    and n != parent] == children, parent
    # The device step: its batch first, then the phases (its sums are a
    # second metrics span); the node-classification step's phases last.
    order = [n for n, _, _ in spans if n.startswith("gn.train.")]
    assert order[-10:] == ["gn.train.batch", *TRAIN, "gn.train.metrics",
                           *TRAIN]


def test_tracing_switch_is_in_the_capture_key(switch):
    """A graph captured with the switch on holds the markers, so toggling
    it has to key another graph."""
    cfg = pt.SortTaskConfig()
    x, y = pt.get_batch(np.random.default_rng(0), cfg, device="cpu")
    model = _sort_model(cfg, "cpu")
    step = pt.capture_step(pt.make_train_step(model,
                                              pt.adamw(model.parameters())))
    switch(False)
    off = step._key((x, y))
    switch(True)
    on = step._key((x, y))
    assert on != off and on[0] == off[0]
    switch(False)
    assert step._key((x, y)) == off


@pytest.mark.parametrize("value,want", [("1", True), ("0", False),
                                        (None, False)])
def test_tracing_switch_from_the_environment(value, want):
    env = {k: v for k, v in os.environ.items()
           if k != "GRAPHNETS_TPU_TORCH_TRACE"}
    if value is not None:
        env["GRAPHNETS_TPU_TORCH_TRACE"] = value
    out = subprocess.run(
        [sys.executable, "-c",
         "import graphnets_tpu_torch as pt; print(pt.tracing())"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(want)


def _captured_sort_step(where):
    """A captured sort step at the recipe's width on the card and its
    arguments: fed host batches, or drawing its own (``first`` is its
    first phase)."""
    pt.use_kernels()    # resolves "auto", which the capture key holds
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = pt.SortTaskConfig()
    model = _sort_model(cfg, "cuda", dims=384)
    opt = pt.adamw(model.parameters())
    if where == "host_batches":
        x, y = pt.get_batch(np.random.default_rng(0), cfg,
                            pt.sort_pad_spec(cfg), device="cuda")
        return pt.capture_step(pt.make_train_step(model, opt)), (x, y)
    gen = torch.Generator(device="cuda").manual_seed(1)
    return pt.capture_step(pt.make_sort_device_step(
        pt.TrainState(model, opt, 0, (gen,)), cfg, pt.sort_pad_spec(cfg))), ()


def replay_kernels(where, path):
    """Run in a process of its own (the tracing switch from the
    environment): capture the step, then print, as JSON, the kernels of
    one replay in device order, the phase markers (``gn_phase_*``) apart,
    and what three more calls copied in against the inputs' bytes."""
    from torch.profiler import ProfilerActivity, profile
    step, args = _captured_sort_step(where)
    step(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in sorted(
            (e for e in json.load(f)["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "kernel"),
            key=lambda e: e["ts"])]
    before = step.copy_in_bytes, step.copy_in_tensors
    for _ in range(3):
        step(*args)
    flat = tensors(args)
    print(json.dumps({
        "captures": step.captures,
        "kernels": [n for n in names if not n.startswith("gn_phase_")],
        "markers": [n.split("(")[0] for n in names
                    if n.startswith("gn_phase_")],
        "copied": [step.copy_in_bytes - before[0],
                   step.copy_in_tensors - before[1]],
        "inputs": [3 * sum(t.numel() * t.element_size() for t in flat),
                   3 * len(flat)]}))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["host_batches", "device_batches"])
def test_markers_of_a_replayed_step(cuda, tmp_path, where):
    """A replay of a step captured with the switch on carries one marker a
    phase, in order, and besides them the kernels, by name and count, of
    a replay of the step captured with it off.  Each side runs in a fresh
    process, as a benchmark run does (a second capture in one process
    can differ from the first by a few copies and fills).
    ``copy_in_bytes`` / ``copy_in_tensors`` count the copies of the host
    batches into the captured inputs, and none where the step draws its
    own batch."""
    read = {}
    for on in ("0", "1"):
        out = subprocess.run(
            [sys.executable, "-c",
             "import sys, test_torch_tracing as t; "
             "t.replay_kernels(sys.argv[1], sys.argv[2])",
             where, str(tmp_path / f"{on}.json")],
            cwd=os.path.join(REPO, "tests"), capture_output=True, text=True,
            timeout=600, env={**os.environ, "GRAPHNETS_TPU_TORCH_TRACE": on,
                              "PYTHONPATH": REPO})
        assert out.returncode == 0, out.stderr[-3000:]
        read[on] = json.loads(out.stdout.strip().splitlines()[-1])
    first = "forward" if where == "host_batches" else "batch"
    assert read["0"]["captures"] == read["1"]["captures"] == 1
    assert collections.Counter(read["1"]["kernels"]) == \
        collections.Counter(read["0"]["kernels"]) and read["0"]["kernels"]
    assert read["0"]["markers"] == []
    assert read["1"]["markers"] == [f"gn_phase_{p}"
                                    for p in PHASES[PHASES.index(first):]]
    for r in read.values():
        assert r["copied"] == (r["inputs"] if where == "host_batches"
                               else [0, 0])
