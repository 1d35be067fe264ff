"""Masked losses and accuracies over padded graph batches (counterpart of
``graphnets_tpu/training/losses.py``).

Padded slots are weighted out by the masks, so the mean runs over real
slots only: Flux's ``logitcrossentropy`` restricted to them.
"""

from __future__ import annotations

import torch

from ..graph import GraphsTuple

__all__ = ["masked_logit_crossentropy", "graph_loss_nf_ef",
           "masked_accuracy", "per_graph_correct", "graph_accuracy"]


def masked_logit_crossentropy(logits: torch.Tensor, targets: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the rows where ``mask`` is True;
    ``logits, targets [T, C]``, in f32."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    per_row = -(targets.float() * logz).sum(-1)
    m = mask.float()
    return (per_row * m).sum() / m.sum().clamp(min=1.0)


def graph_loss_nf_ef(pred: GraphsTuple, target: GraphsTuple) -> torch.Tensor:
    """Node cross-entropy plus edge cross-entropy over real slots (the
    sort-task loss)."""
    loss = masked_logit_crossentropy(pred.nf, target.nf, pred.node_mask)
    return loss + masked_logit_crossentropy(pred.ef, target.ef,
                                            pred.edge_mask)


def masked_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Fraction of real slots where ``argmax(logits) == argmax(targets)``."""
    correct = (logits.argmax(-1) == targets.argmax(-1)).float()
    m = mask.float()
    return (correct * m).sum() / m.sum().clamp(min=1.0)


def _all_correct(logits, targets, mask, seg, num_graphs: int):
    """``[G]`` int32 segment minimum of "correct or padded"; a graph with no
    slots keeps the int32 maximum, as ``jax.ops.segment_min`` gives."""
    ok = ((logits.argmax(-1) == targets.argmax(-1)) | ~mask).to(torch.int32)
    init = torch.full((num_graphs,), torch.iinfo(torch.int32).max,
                      dtype=torch.int32, device=ok.device)
    return init.scatter_reduce(0, seg.long(), ok, "amin")


def per_graph_correct(pred: GraphsTuple, target: GraphsTuple
                      ) -> torch.Tensor:
    """``[G]`` int32: 1 where every real node and edge prediction of the
    graph is correct (garbage on padding graph slots: mask with
    ``graph_mask``)."""
    G = pred.num_graph_slots
    g_ok = _all_correct(pred.nf, target.nf, pred.node_mask, pred.node_graph,
                        G)
    return g_ok * _all_correct(pred.ef, target.ef, pred.edge_mask,
                               pred.edge_graph, G)


def graph_accuracy(pred: GraphsTuple, target: GraphsTuple) -> torch.Tensor:
    """Fraction of real graphs whose every real node and edge prediction is
    correct."""
    gm = pred.graph_mask.float()
    return ((per_graph_correct(pred, target).float() * gm).sum()
            / gm.sum().clamp(min=1.0))
