"""The training step (counterpart of ``make_train_step`` in
``graphnets_tpu/training/train.py``).

The model's parameters are the f32 master copy.  Each step runs the
forward on ``{name: p.to(compute_dtype)}`` through
``torch.func.functional_call``, so activations and the kernels run in the
compute dtype while the gradients come back through the cast in f32 (the
JAX headline step, ``benchmarks/bench_train_step.py:47-55``).  The
optimizer updates the masters in place, which JAX's functional step does
by returning new arrays.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn
from torch.func import functional_call

from ..graph import GraphsTuple
from .losses import graph_accuracy, graph_loss_nf_ef, masked_accuracy

__all__ = ["adamw", "make_train_step"]


def adamw(params: Iterable[torch.Tensor], lr: float = 3e-4
          ) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` in torch: betas (0.9, 0.999), eps 1e-8 and
    weight decay 1e-4 (torch's default decay is 1e-2)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[GraphsTuple, GraphsTuple], torch.Tensor]
        = graph_loss_nf_ef,
    training: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
) -> Callable[[GraphsTuple, GraphsTuple], Dict[str, torch.Tensor]]:
    """Build ``step(x, y) -> metrics``: the loss of ``model`` on ``x``
    against ``y``, its backward, and one ``optimizer`` step on the
    model's parameters.

    ``compute_dtype`` (for example ``torch.bfloat16``) casts the
    parameters for the forward; ``None`` runs them as they are.
    ``generator`` draws the dropout masks.  The metrics are 0-d tensors on
    the model's device (no host sync): ``loss``, ``node_acc``, ``edge_acc``
    and ``graph_acc``.
    """
    params = dict(model.named_parameters())

    def step(x: GraphsTuple, y: GraphsTuple) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        run = params if compute_dtype is None else {
            n: p.to(compute_dtype) for n, p in params.items()}
        pred = functional_call(model, run, (x,),
                               {"training": training, "generator": generator})
        loss = loss_fn(pred, y)
        loss.backward()
        for p in params.values():
            # A parameter the loss does not reach (the last core's graph
            # update) has a zero gradient in JAX, and optax still decays
            # it and advances its moments; torch would skip it.
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        with torch.no_grad():
            return {
                "loss": loss.detach(),
                "node_acc": masked_accuracy(pred.nf, y.nf, x.node_mask),
                "edge_acc": masked_accuracy(pred.ef, y.ef, x.edge_mask),
                "graph_acc": graph_accuracy(pred, y),
            }

    return step
