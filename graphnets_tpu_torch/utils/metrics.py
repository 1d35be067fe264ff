"""Structured metrics and logging (counterpart of
``graphnets_tpu/utils/metrics.py``): per-step scalars, step time and
edges/s, logging from process 0 only, optional JSONL and TensorBoard."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Dict, Optional

import torch.distributed as dist

__all__ = ["MetricLogger", "host0_logger", "is_host0"]


def is_host0() -> bool:
    """Rank 0 of ``torch.distributed`` when it is initialised, else True
    (a single process)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def host0_logger(name: str = "graphnets_tpu_torch",
                 level: int = logging.INFO) -> logging.Logger:
    """A logger that emits only on process 0."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level if is_host0() else logging.CRITICAL)
    return logger


class MetricLogger:
    """Collects per-step scalars; reports the step time (wall clock between
    two ``write`` calls, over the steps between them) and edges/s;
    optionally appends JSON lines and writes TensorBoard summaries.  Only
    process 0 writes."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 log_every: int = 100):
        self.log = host0_logger()
        self.log_every = log_every
        self._jsonl = (open(jsonl_path, "a")
                       if jsonl_path and is_host0() else None)
        self._tb = None
        if tensorboard_dir and is_host0():
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                self.log.warning("tensorboard writer unavailable")
        self._t_last = None
        self._step_last = 0

    def write(self, step: int, metrics: Dict[str, float],
              edges_per_batch: Optional[int] = None) -> None:
        now = time.perf_counter()
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self._t_last is not None and step > self._step_last:
            dt = (now - self._t_last) / (step - self._step_last)
            row["step_time_s"] = dt
            if edges_per_batch:
                row["edges_per_s"] = edges_per_batch / dt
        self._t_last, self._step_last = now, step
        if self._jsonl:
            self._jsonl.write(json.dumps(row) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in row.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
        if self.log_every and step % self.log_every == 0:
            self.log.info(" ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()))

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None
