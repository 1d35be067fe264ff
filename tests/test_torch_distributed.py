"""The port's multi-process runtime (``graphnets_tpu_torch.parallel
.distributed``) against the JAX package's: restart from a checkpoint
after an injected fault (``tests/test_fault_tolerance.py:38``), the fault
injector in both modes, and ``init_distributed`` with and without the
launcher's environment (2 gloo ranks spawned through
``tests/torch_rank_cases.py``)."""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as pt
import torch_rank_cases as rc
from graphnets_tpu_torch.parallel.distributed import (FaultInjector,
                                                      RestartableLoop,
                                                      init_distributed)
from graphnets_tpu_torch.parallel.launch import run_ranks

ROOT = Path(__file__).resolve().parents[1]


def _setup():
    model = rc.dp_model(seed=0)
    opt = pt.adamw(model.parameters(), 1e-2)
    step = pt.make_train_step(model, opt)

    def wrapped(state, batch):
        metrics = step(*batch)
        state.step += 1
        return state, metrics

    return pt.TrainState(model, opt, 0), wrapped


def test_restart_recovers_and_matches(tmp_path):
    """Crash at step 7, restart, resume from the checkpoint at 5 (restored
    into the live model and optimizer in place), finish: the final state
    equals an uninterrupted run over the same batches, indexed by step."""
    all_batches = rc.sort_shards(rc.DP_CFG, 1, 12)
    stream = lambda start: iter(all_batches[start:])
    state0, wrapped = _setup()
    ckpt = str(tmp_path / "ckpt")
    loop = RestartableLoop(ckpt_dir=ckpt, ckpt_every=5,
                           fault=FaultInjector(fail_at_step=7))
    with pytest.raises(RuntimeError, match="injected fault"):
        loop.run(state0, wrapped, stream(0), num_steps=12)
    assert state0.step == 7
    seen = []
    final = RestartableLoop(ckpt_dir=ckpt, ckpt_every=5).run(
        state0, wrapped, stream(5), num_steps=12,
        on_metrics=lambda i, m: seen.append(i))
    assert seen == list(range(5, 12)) and final.step == 12
    assert final.model is state0.model

    ref, ref_step = _setup()
    for b in all_batches:
        ref, _ = ref_step(ref, b)
    for (n, a), b in zip(final.model.named_parameters(),
                         ref.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_fault_injector_raises_once():
    f = FaultInjector(fail_at_step=3)
    for i in range(3):
        f.maybe_fail(i)
    with pytest.raises(RuntimeError, match="injected fault at step 3"):
        f.maybe_fail(3)
    f.maybe_fail(3)     # fires once
    FaultInjector().maybe_fail(0)


def test_fault_injector_exit_kills_the_process():
    """``mode="exit"``: the process dies with code 42 at the step."""
    code = ("from graphnets_tpu_torch.parallel.distributed import "
            "FaultInjector\n"
            "f = FaultInjector(fail_at_step=2, mode='exit')\n"
            "for i in range(5):\n"
            "    f.maybe_fail(i)\n"
            "    print(i, flush=True)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 42, out.stderr
    assert out.stdout.split() == ["0", "1"]


def test_init_distributed_without_environment(monkeypatch):
    """No rendezvous named: a single process, nothing initialised."""
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_from_environment(tmp_path):
    """2 ranks initialise from ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` on the CPU (gloo) and sum their ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = run_ranks(rc.env_init_case, 2, str(tmp_path), port,
                    device="cpu", timeout_s=120)
    assert got == [(True, "gloo", 3.0)] * 2


def test_init_distributed_runs_on_the_card_unless_asked(monkeypatch):
    """Without ``device`` the backend is NCCL on the card; without a card
    that raises instead of running on the CPU."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_distributed(num_processes=1, process_id=0)
        assert not torch.distributed.is_initialized()


def test_run_ranks_runs_on_the_card_unless_asked(tmp_path):
    """Without ``device`` the ranks take the card; without a card that
    raises before any rank starts, instead of running on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_ranks(rc.env_init_case, 2, str(tmp_path / "ranks"), 1)
        assert not (tmp_path / "ranks").exists()
