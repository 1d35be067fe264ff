#!/usr/bin/env python
"""The list-sorting example on the PyTorch port (``graphnets_tpu_torch``).

Trains encoder -> 2x GNCore -> decoder to sort 2-10 integers (vocab 100) on
fully connected graphs: node targets = "is minimum", edge targets =
"consecutive in sorted order".  Recipe: batch 4, AdamW 3e-4, dims
(384, 384, 384), f32, batches from the host generator.  It runs on a CUDA
device unless ``--device cpu`` is given.

Usage:
    python examples/sort_torch.py --steps 2000
    python examples/sort_torch.py --steps 40 --core-dim 64 --device cpu
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np
import torch

from graphnets_tpu_torch.data.sort_task import (SortTaskConfig, get_batch,
                                                sort_pad_spec)
from graphnets_tpu_torch.training.train import train_sort


def show_sample(model, cfg):
    """Print one sample's prediction against its target."""
    rng = np.random.default_rng(123)
    one = SortTaskConfig(cfg.vocab_size, cfg.min_nodes, cfg.max_nodes, 1)
    device = next(model.parameters()).device
    x, y = get_batch(rng, one, sort_pad_spec(one), device=device)
    with torch.no_grad():
        pred = model(x)
    n, e = int(x.n_node[0]), int(x.n_edge[0])
    values = x.nf[:n].argmax(-1).cpu().numpy() + 1
    print(f"values:      {values.tolist()}")
    print(f"is_min pred: {pred.nf[:n].argmax(-1).tolist()}")
    print(f"is_min true: {y.nf[:n].argmax(-1).tolist()}")
    ef_pred = pred.ef[:e].argmax(-1).cpu().numpy().reshape(n, n, order="F")
    ef_true = y.ef[:e].argmax(-1).cpu().numpy().reshape(n, n, order="F")
    print(f"edge-matrix match: {(ef_pred == ef_true).mean():.2%}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--core-dim", type=int, default=384)
    ap.add_argument("--n-cores", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = SortTaskConfig(batch_size=args.batch_size)
    res = train_sort(steps=args.steps, cfg=cfg,
                     core_dims=(args.core_dim,) * 3, n_cores=args.n_cores,
                     learning_rate=args.lr, seed=args.seed,
                     log_every=args.log_every, device=args.device)
    print(f"final metrics: {res.metrics}")
    print(f"throughput: {res.steps_per_sec:.2f} steps/s")
    show_sample(res.model, cfg)


if __name__ == "__main__":
    main()
