"""Multi-process runtime: initialisation, restartable training and
test-only fault injection (counterpart of
``graphnets_tpu/parallel/distributed.py``).

``init_distributed`` initialises ``torch.distributed`` from the launcher's
environment (``torchrun``'s ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``) or from explicit arguments.
The recovery model is JAX's: restart from a checkpoint.  The launcher
restarts the job and ``RestartableLoop`` resumes from the latest
checkpoint, restored into the live state in place (so a step captured as
a CUDA graph goes on without a recapture).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from ..training.checkpoint import CheckpointManager
from ..utils.config import resolve_device
from ..utils.metrics import host0_logger

__all__ = ["init_distributed", "RestartableLoop", "FaultInjector"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None, backend: Optional[str] = None,
                     local_rank: Optional[int] = None,
                     timeout_s: float = 600.0) -> bool:
    """Initialise ``torch.distributed``; returns whether it did.

    ``coordinator_address`` is ``host:port`` or an ``init_method`` URL
    (``tcp://``, ``file://``); without it the environment's
    ``MASTER_ADDR`` and ``MASTER_PORT`` name the rendezvous, and without
    those this is a single process: nothing is initialised and the result
    is False (as JAX's without ``JAX_COORDINATOR_ADDRESS``).  The world
    size and the rank default to ``WORLD_SIZE`` and ``RANK``.

    The backend follows ``device`` (``cuda`` unless the caller asks for
    the CPU): NCCL on the card, after ``torch.cuda.set_device(local_rank)``
    (default ``LOCAL_RANK``, else 0), gloo on the CPU.  ``backend`` names
    another one explicitly (gloo for several ranks on one card, which NCCL
    refuses).  Collectives time out after ``timeout_s``."""
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    world = int(env["WORLD_SIZE"] if num_processes is None
                else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0))
                              if local_rank is None else local_rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


class FaultInjector:
    """Test-only fault hook: kills (or raises in) this process between
    steps, to exercise restart-from-checkpoint recovery."""

    def __init__(self, fail_at_step: Optional[int] = None,
                 mode: str = "raise"):
        self.fail_at_step = fail_at_step
        self.mode = mode

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            self.fail_at_step = None
            if self.mode == "raise":
                raise RuntimeError(f"injected fault at step {step}")
            os._exit(42)  # simulated host death


@dataclasses.dataclass
class RestartableLoop:
    """Checkpoint-resumable training loop.

    ``run`` resumes from the latest checkpoint in ``ckpt_dir`` (if any),
    written into ``init_state`` in place, executes ``step_fn(state, batch)
    -> (state, metrics)`` over ``batches``, and checkpoints every
    ``ckpt_every`` steps.  A crash (or injected fault) loses at most
    ``ckpt_every`` steps of work.
    """

    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    fault: Optional[FaultInjector] = None

    def run(self, init_state: Any,
            step_fn: Callable[[Any, Any], Tuple[Any, dict]],
            batches: Iterable[Any],
            num_steps: int,
            on_metrics: Optional[Callable[[int, dict], None]] = None) -> Any:
        log = host0_logger()
        mgr = CheckpointManager(self.ckpt_dir, keep=self.keep)
        start = 0
        state = init_state
        if mgr.latest_step() is not None:
            start = int(mgr.latest_step())
            state = mgr.restore(init_state)
            log.info("resumed from checkpoint step %d", start)

        it = iter(batches)
        step = start
        for step in range(start, num_steps):
            batch = next(it)
            if self.fault is not None:
                self.fault.maybe_fail(step)
            state, metrics = step_fn(state, batch)
            if on_metrics is not None:
                on_metrics(step, metrics)
            if (step + 1) % self.ckpt_every == 0 or step + 1 == num_steps:
                mgr.save(step + 1, state, wait=True)
        mgr.wait()
        mgr.close()
        return state
