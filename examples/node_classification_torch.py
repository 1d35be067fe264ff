#!/usr/bin/env python
"""Large-graph node classification on the PyTorch port
(``graphnets_tpu_torch``): the GraphSAGE-style workflow.

``LargeGraph`` CSC store -> fixed-fanout ``NeighborSampler`` (static
shapes, the native host sampler) -> feature table resident on the device ->
``EncodeProcessDecode`` -> masked cross-entropy on the seed nodes -> Adam,
with held-out validation accuracy.  It trains on a synthetic
citation-shaped graph (power-law in-degree, features weakly correlated with
the labels), in f32, or on an OGB node-property dataset in its raw on-disk
layout (``--ogb-root``).  On the card the step is captured as a CUDA graph
and replayed (``capture_step``, the counterpart of the JAX example's
``jax.jit``).  It runs on a CUDA device unless ``--device cpu`` is given,
and exits 0 iff the validation accuracy clears 0.5.

Usage:
    python examples/node_classification_torch.py --steps 200
    python examples/node_classification_torch.py --steps 200 --device cpu
    python examples/node_classification_torch.py --ogb-root DIR \
        --ogb-name ogbn-arxiv
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import torch

from graphnets_tpu_torch.data.large_graph import (LargeGraph,
                                                  NeighborSampler,
                                                  device_feature_table)
from graphnets_tpu_torch.models.encode_process_decode import \
    EncodeProcessDecode
from graphnets_tpu_torch.training.train import (adam, capture_step,
                                                make_node_classification_step)
from graphnets_tpu_torch.utils.config import resolve_device


def synthetic_citation_graph(n=2000, avg_deg=8, d=32, n_classes=8, seed=0):
    """Citation-shaped synthetic data: power-law in-degree, features weakly
    correlated with the labels so that learning is measurable."""
    rng = np.random.default_rng(seed)
    e = n * avg_deg
    p = 1.0 / (np.arange(n) + 10.0)
    cdf = np.cumsum(p / p.sum())
    ranks = rng.permutation(n).astype(np.int64)
    receivers = ranks[np.searchsorted(cdf, rng.random(e),
                                      side="right").clip(0, n - 1)]
    senders = rng.integers(0, n, e)
    labels = rng.integers(0, n_classes, n)
    feat = rng.normal(size=(n, d)).astype(np.float32)
    feat[:, :n_classes] += 3.0 * np.eye(n_classes, dtype=np.float32)[labels]
    g = LargeGraph.from_coo(senders, receivers, feat, labels)
    ids = rng.permutation(n)
    splits = {"train": ids[: int(0.8 * n)], "valid": ids[int(0.8 * n):]}
    return g, splits, n_classes


def accuracy(model, sampler, feat, node_set) -> float:
    """Share of ``node_set`` whose predicted class is its label."""
    correct = total = 0
    with torch.no_grad():
        for b in sampler.epoch(node_set, shuffle=False):
            graph = b.graph.with_features(
                nf=feat.index_select(0, b.node_ids))
            yhat = model(graph).nf.index_select(0, b.seed_local_idx) \
                .argmax(-1)
            correct += int(((yhat == b.labels) & b.label_mask).sum())
            total += int(b.label_mask.sum())
    return correct / max(total, 1)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[8, 4])
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--cores", type=int, default=2)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ogb-root", default=None,
                    help="on-disk OGB root dir (raw csv layout)")
    ap.add_argument("--ogb-name", default="ogbn-arxiv")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.ogb_root:
        from graphnets_tpu_torch.data.ogb import load_ogb_node_dataset
        ds = load_ogb_node_dataset(args.ogb_root, args.ogb_name)
        g, splits, n_classes = ds.graph, ds.splits, ds.num_classes
        print(f"loaded {ds.name}: {g.num_nodes} nodes, {g.num_edges} "
              f"edges, {n_classes} classes; device {device}")
    else:
        g, splits, n_classes = synthetic_citation_graph()
        print(f"synthetic citation graph: {g.num_nodes} nodes, "
              f"{g.num_edges} edges, {n_classes} classes; device {device}")
    sampler = NeighborSampler(g, fanouts=tuple(args.fanouts),
                              batch_size=args.batch, seed=1,
                              emit_node_ids=True, device=device)
    feat = device_feature_table(g, device=device)
    model = EncodeProcessDecode(
        (0, g.node_feat.shape[1], 0), (args.hidden,) * 3, (1, n_classes, 0),
        n_cores=args.cores, device=device,
        generator=torch.Generator().manual_seed(0))
    opt = adam(model.parameters(), lr=args.lr)
    step = capture_step(make_node_classification_step(model, opt,
                                                       n_classes))

    t0 = time.time()
    it = iter(sampler.epoch(splits["train"]))
    for i in range(1, args.steps + 1):
        try:
            b = next(it)
        except StopIteration:
            it = iter(sampler.epoch(splits["train"]))
            b = next(it)
        loss = step(b.graph, b.node_ids, b.labels, b.label_mask,
                    b.seed_local_idx, feat)
        if i % args.log_every == 0 or i == args.steps:
            print(f"step {i:5d}  loss {float(loss):.4f}  "
                  f"({(time.time() - t0) / i * 1e3:.0f} ms/step avg)")

    acc = accuracy(model, sampler, feat, splits["valid"])
    print(f"validation accuracy: {acc:.4f} "
          f"({len(splits['valid'])} held-out nodes)")
    print("node_classification ok")
    return acc


if __name__ == "__main__":
    sys.exit(0 if main() > 0.5 else 1)
