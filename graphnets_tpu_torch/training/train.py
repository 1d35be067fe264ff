"""The training step and the sort-task trainer (counterparts of
``make_train_step`` and ``train_sort`` in
``graphnets_tpu/training/train.py``).

The model's parameters are the f32 master copy.  Each step runs the
forward on ``{name: p.to(compute_dtype)}`` through
``torch.func.functional_call``, so activations and the kernels run in the
compute dtype while the gradients come back through the cast in f32 (the
JAX headline step, ``benchmarks/bench_train_step.py:47-55``).  The
optimizer updates the masters in place, which JAX's functional step does
by returning new arrays.

:func:`train_sort` is the host loop of the sort example: batches from the
numpy generator, one step each.  The JAX package's loops that generate the
data inside the compiled step (``train_sort_device``, ``evaluate_sort``)
are not ported.

:func:`make_node_classification_step` is the step of sampled training on a
large graph (``data/large_graph``): a device gather of the node features,
the seed nodes' masked cross-entropy, and the optimizer step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..data.sort_task import SortTaskConfig, get_batch, sort_pad_spec
from ..graph import GraphsTuple
from ..models.encode_process_decode import EncodeProcessDecode
from ..utils.config import resolve_device
from .losses import (graph_accuracy, graph_loss_nf_ef, masked_accuracy,
                     masked_logit_crossentropy)

__all__ = ["adamw", "make_train_step", "make_node_classification_step",
           "train_sort", "SortTrainResult"]


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


def make_node_classification_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    n_classes: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[..., torch.Tensor]:
    """Build ``step(graph, node_ids, labels, label_mask, seed_idx, feat) ->
    loss`` for sampled mini-batches of a large graph (the step of
    ``examples/node_classification.py`` and ``benchmarks/bench_arxiv.py``
    in the JAX package): the node features are gathered on the device from
    the resident table ``feat [N + 1, D]`` by the batch's ``node_ids``, the
    model runs under training, the logits of the seed nodes go through the
    masked cross-entropy against the one-hot ``labels``, and ``optimizer``
    takes one step on the model's parameters.

    ``compute_dtype`` casts the (f32 master) parameters for the forward,
    as in :func:`make_train_step`; ``feat`` is used in the type it has.
    The loss is a 0-d tensor on the model's device (no host sync)."""
    params = dict(model.named_parameters())

    def step(graph: GraphsTuple, node_ids: torch.Tensor,
             labels: torch.Tensor, label_mask: torch.Tensor,
             seed_idx: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        graph = graph.with_features(nf=feat.index_select(0, node_ids))
        run = params if compute_dtype is None else {
            n: p.to(compute_dtype) for n, p in params.items()}
        pred = functional_call(model, run, (graph,), {"training": True})
        logits = pred.nf.index_select(0, seed_idx)
        onehot = torch.nn.functional.one_hot(labels.long(), n_classes)
        loss = masked_logit_crossentropy(logits, onehot, label_mask)
        loss.backward()
        for p in params.values():
            if p.grad is None:  # as in make_train_step
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    return step


@dataclasses.dataclass
class SortTrainResult:
    """The trained ``model`` (it holds the parameters), its ``optimizer``
    (the AdamW moments), the last step's ``metrics`` as floats, and the
    throughput without the first step."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    metrics: dict
    steps_per_sec: float


def train_sort(
    steps: int = 1000,
    cfg: SortTaskConfig = SortTaskConfig(),
    core_dims: Tuple[int, int, int] = (384, 384, 384),
    n_cores: int = 2,
    learning_rate: float = 3e-4,
    seed: int = 0,
    log_every: int = 0,
    model: Optional[nn.Module] = None,
    device=None,
) -> SortTrainResult:
    """Train the sort model in f32: encoder ``(0, vocab, 0) -> core_dims``,
    ``n_cores`` GNCores, decoder to ``(2, 2, 0)``, AdamW, on batches from
    the host generator seeded with ``seed``.  Runs on ``device`` (``cuda``
    unless the caller passes another); a ``model`` passed in must already
    live there.  The first step (kernel builds, allocator warm-up) is left
    out of ``steps_per_sec``."""
    device = resolve_device(device)
    if model is None:
        model = EncodeProcessDecode(
            x_dims=(0, cfg.vocab_size, 0), core_dims=core_dims,
            y_dims=(2, 2, 0), n_cores=n_cores, device=device,
            generator=torch.Generator().manual_seed(seed))
    optimizer = adamw(model.parameters(), learning_rate)
    step_fn = make_train_step(model, optimizer)

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(seed)
    pad = sort_pad_spec(cfg)
    metrics: Dict[str, torch.Tensor] = {}
    t0 = None
    for i in range(steps):
        x, y = get_batch(rng, cfg, pad, device=device)
        metrics = step_fn(x, y)
        if i == 0:
            wait()
            t0 = time.perf_counter()
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: " + ", ".join(
                f"{k}={float(v):.4f}" for k, v in metrics.items()))
    wait()
    dt = (time.perf_counter() - t0) if steps > 1 else float("inf")
    return SortTrainResult(
        model=model, optimizer=optimizer,
        metrics={k: float(v) for k, v in metrics.items()},
        steps_per_sec=(steps - 1) / dt if steps > 1 else 0.0)
