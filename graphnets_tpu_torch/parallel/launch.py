"""Run a function on several ranks of one host: a small ``torchrun`` for
tests and smoke runs.

:func:`run_ranks` starts ``world`` processes with the ``spawn`` method
(each imports the module of ``fn`` afresh), initialises
``torch.distributed`` in each through a ``FileStore`` in ``workdir`` (no
TCP port to collide on), runs ``fn(rank, world, *args)`` and returns the
ranks' results in rank order (``torch.save``d into ``workdir``).  Every
wait has a deadline: a rank that hangs or fails fails the call, and no
process outlives it.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ..utils.config import resolve_device
from .distributed import init_distributed

__all__ = ["run_ranks"]


def _rank_main(fn, rank: int, world: int, workdir: str, device: str,
               backend: Optional[str], timeout_s: float, threads: int,
               args) -> None:
    torch.set_num_threads(threads)
    out = os.path.join(workdir, f"rank{rank}.pt")
    try:
        init_distributed(f"file://{os.path.join(workdir, 'store')}", world,
                         rank, device=device, backend=backend,
                         local_rank=(0 if torch.device(device).type == "cuda"
                                     else None),
                         timeout_s=timeout_s)
        torch.save({"result": fn(rank, world, *args)}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, workdir: str, *args,
              device: Optional[str] = None, backend: Optional[str] = None,
              timeout_s: float = 300.0, threads: int = 1) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    on its own rank.  ``device`` (the card unless the caller asks for the
    CPU, as ``utils.config.resolve_device`` resolves it) and ``backend``
    go to ``init_distributed`` (every rank takes ``cuda:0`` on the card,
    so several ranks share one card over ``backend="gloo"``).  ``fn`` and
    ``args`` must pickle; ``workdir`` must be empty of a previous run's
    store.  Raises ``RuntimeError`` with a rank's traceback if one fails,
    ``TimeoutError`` if the ranks have not all ended after ``timeout_s``
    seconds."""
    device = str(resolve_device(device))
    os.makedirs(workdir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, workdir, device, backend,
                               timeout_s, threads, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if hung:
        raise TimeoutError(f"run_ranks: ranks {hung} of {world} still ran "
                           f"after {timeout_s} s")
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.pt")
        got = (torch.load(path, weights_only=False)
               if os.path.exists(path) else {})
        if p.exitcode != 0 or "result" not in got:
            raise RuntimeError(f"run_ranks: rank {r} exited with "
                               f"{p.exitcode}:\n{got.get('error', '')}")
        results.append(got["result"])
    return results
