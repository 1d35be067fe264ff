"""Evaluation of the sort task (counterpart of ``sort_accuracy`` in
``graphnets_tpu/training/evaluate.py``): slot-level and whole-graph
accuracies on fresh samples."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..data.sort_task import SortTaskConfig, get_batch, sort_pad_spec

__all__ = ["sort_accuracy"]


def sort_accuracy(model: nn.Module, cfg: SortTaskConfig,
                  num_batches: int = 25, seed: int = 1234
                  ) -> Dict[str, float]:
    """Slot-level and whole-graph accuracy on fresh sort-task samples,
    generated on the host and run on the model's device.

    ``graph_acc`` counts a graph correct only if every node AND every edge
    slot is predicted correctly: the strict task-solved metric.
    """
    rng = np.random.default_rng(seed)
    pad = sort_pad_spec(cfg)
    device = next(model.parameters()).device
    node_ok = node_tot = edge_ok = edge_tot = 0
    graph_ok = graph_tot = 0
    for _ in range(num_batches):
        x, y = get_batch(rng, cfg, pad, device=device)
        with torch.no_grad():
            pred = model(x)
        pn = pred.nf.argmax(-1).cpu().numpy()
        pe = pred.ef.argmax(-1).cpu().numpy()
        tn = y.nf.argmax(-1).cpu().numpy()
        te = y.ef.argmax(-1).cpu().numpy()
        n_node = x.n_node.cpu().numpy()
        n_edge = x.n_edge.cpu().numpy()
        node_off = np.concatenate([[0], np.cumsum(n_node)])
        edge_off = np.concatenate([[0], np.cumsum(n_edge)])
        for b in range(int(x.graph_mask.sum())):
            ns = slice(node_off[b], node_off[b + 1])
            es = slice(edge_off[b], edge_off[b + 1])
            nok = int((pn[ns] == tn[ns]).sum())
            eok = int((pe[es] == te[es]).sum())
            node_ok += nok
            node_tot += int(n_node[b])
            edge_ok += eok
            edge_tot += int(n_edge[b])
            graph_ok += int(nok == n_node[b] and eok == n_edge[b])
            graph_tot += 1
    return {
        "node_acc": node_ok / max(node_tot, 1),
        "edge_acc": edge_ok / max(edge_tot, 1),
        "graph_acc": graph_ok / max(graph_tot, 1),
    }
