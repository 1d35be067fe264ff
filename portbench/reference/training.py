"""What every model kind's plain reference shares: optax's AdamW, the
readings the checks compare, and the training loop that takes them.  A
kind's ``reference/<kind>.py`` gives the loop its forward pass and loss
(``train``) and its planted fault (``half_batch``).  It imports nothing
of the program.

AdamW is optax's: b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay
1e-4 (``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

BETA1, BETA2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def adamw_update(p, g, m, v, t: int, lr: float) -> None:
    """One AdamW update of ``p`` in place from its gradient ``g``, its
    moments ``m`` and ``v`` (updated in place) at step ``t`` (from 1)."""
    m.mul_(BETA1).add_(g, alpha=1 - BETA1)
    v.mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
    m_hat = m / (1 - BETA1 ** t)
    v_hat = v / (1 - BETA2 ** t)
    p.sub_(lr * (m_hat / (v_hat.sqrt() + ADAM_EPS) + WEIGHT_DECAY * p))


@dataclasses.dataclass
class Readings:
    """What the checks compare: each step's loss, each leaf's first
    gradient norm and each leaf's change after the steps (by name); the
    reference also gives each step's ``loss_scale``."""
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    loss_scales: Optional[List[float]] = None
    sizes: Optional[Dict[str, int]] = None


# ``(params, x, y, keep) -> (loss, loss_scale)``: the loss of one step on
# the batch ``(x, y)`` (a scalar tensor to differentiate), restricted to
# the rows ``keep`` names where it is not ``None``, and the magnitude of
# its per-row terms (the scale of its rounding).
StepLoss = Callable[[Dict[str, torch.Tensor], object, object, object],
                    Tuple[torch.Tensor, float]]


def train(params: Dict[str, torch.Tensor], batches: Sequence,
          step_loss: StepLoss, lr: float, keep=None) -> Readings:
    """AdamW steps from ``params`` (left untouched), one per ``(x, y)`` of
    ``batches``; the loss of each step, the norms of the first step's
    gradients and of each parameter's change after the last step.
    ``keep`` is passed to ``step_loss`` as it is, or called on each
    step's ``x`` where it is a function (a fault planted for the
    checks)."""
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, scales, grad_norms = [], [], {}
    for t, (x, y) in enumerate(batches, start=1):
        for q in p.values():
            q.grad = None
        lo, scale = step_loss(p, x, y, keep(x) if callable(keep) else keep)
        scales.append(scale)
        lo.backward()
        losses.append(float(lo.detach()))
        with torch.no_grad():
            for k, q in p.items():
                g = q.grad if q.grad is not None else torch.zeros_like(q)
                if t == 1:
                    grad_norms[k] = float(g.norm())
                adamw_update(q, g, m[k], v2[k], t, lr)
    with torch.no_grad():
        change = {k: float((q - params[k].float()).norm())
                  for k, q in p.items()}
    return Readings(losses, grad_norms, change, scales,
                    {k: q.numel() for k, q in p.items()})
