"""Learning-rate schedules, as optax takes them (the port's counterparts of
``optax.constant_schedule`` and ``optax.warmup_cosine_decay_schedule``,
the one schedule the repository's recipes use:
``benchmarks/run_flagship.py:125-129``).

A schedule is a function of the optimizer's step count, a 0-d tensor, and
returns the rate for that step as a 0-d f32 tensor on the count's device:
no host sync, so it runs inside a captured step (``training/train``).
:func:`follow_schedule` makes an Adam / AdamW optimizer write
``schedule(count)`` into its tensor learning rate before each update, at
the count before the update's increment, as optax evaluates it; the count
is the optimizer's own per-parameter ``step`` state, so a checkpoint
resumes the schedule with no state of its own.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

__all__ = ["Schedule", "LearningRate", "constant_schedule",
           "warmup_cosine_decay_schedule", "follow_schedule"]

Schedule = Callable[[torch.Tensor], torch.Tensor]
LearningRate = Union[float, Schedule]


def constant_schedule(value: float) -> Schedule:
    """``value`` at every step."""
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=count.device)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax's schedule of the same name, in f32: a linear warm-up from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay over ``decay_steps - warmup_steps`` steps to ``end_value``
    (optax's ``cosine_decay_schedule`` with ``alpha = end_value /
    peak_value``), held there after."""
    cos_steps = float(decay_steps - warmup_steps)
    if not cos_steps > 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def warmup(count):
        if warmup_steps <= 0:
            return torch.full_like(count, init_value)
        frac = 1 - count.clamp(0, warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count):
        count = count.clamp(max=cos_steps)
        decay = 0.5 * (1 + torch.cos(math.pi * count / cos_steps))
        return peak_value * ((1 - alpha) * decay + alpha)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = count.to(torch.float32)
        return torch.where(count < warmup_steps, warmup(count),
                           cosine(count - warmup_steps))

    return schedule


def initial_lr(lr: LearningRate, device) -> Union[float, torch.Tensor]:
    """The ``lr`` an optimizer is built with: a float as it is, for a
    schedule a 0-d f32 tensor on ``device`` that :func:`follow_schedule`
    writes each step."""
    if callable(lr):
        return torch.zeros((), dtype=torch.float32, device=device)
    return lr


def follow_schedule(optimizer: torch.optim.Optimizer, lr: LearningRate
                    ) -> torch.optim.Optimizer:
    """With a schedule ``lr``, make ``optimizer`` (built with
    :func:`initial_lr`) write ``lr(count)`` into each group's tensor rate
    before each ``step()``; ``count`` is the group's first parameter's
    ``step`` state before its increment (0 before the first step).  A float
    ``lr`` leaves the optimizer as it is.  Returns ``optimizer``."""
    if not callable(lr):
        return optimizer

    def write_lr(opt, args, kwargs):
        for group in opt.param_groups:
            rate = group["lr"]
            state = opt.state.get(group["params"][0])
            count = state["step"] if state else torch.zeros(
                (), dtype=torch.float32, device=rate.device)
            rate.copy_(lr(count))

    optimizer.register_step_pre_hook(write_lr)
    return optimizer
