#!/usr/bin/env python
"""The list-sorting example on the PyTorch port (``graphnets_tpu_torch``).

Trains encoder -> 2x GNCore -> decoder to sort 2-10 integers (vocab 100) on
fully connected graphs: node targets = "is minimum", edge targets =
"consecutive in sorted order".  Recipe: batch 4, AdamW 3e-4, dims
(384, 384, 384), f32.  By default the whole loop runs on the device
(``train_sort_device``: batches generated inside the captured step, a chunk
of steps per host sync); ``--host-loop`` takes the host generator and one
step a batch (``train_sort``).  It runs on a CUDA device unless
``--device cpu`` is given.

Usage:
    python examples/sort_torch.py --steps 2000 --ckpt /tmp/sort_ckpt \\
        --svg-dir /tmp/sort_svg
    python examples/sort_torch.py --steps 2000 --host-loop
    python examples/sort_torch.py --steps 40 --core-dim 64 --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, ".")

import numpy as np
import torch

from graphnets_tpu_torch.data.sort_task import (SortTaskConfig, get_batch,
                                                sort_pad_spec)
from graphnets_tpu_torch.training.train import train_sort, train_sort_device


def show_sample(model, cfg, svg_dir=None):
    """Print one sample's prediction against its target and, with
    ``svg_dir``, write the input, target and prediction graphs there as
    SVG."""
    rng = np.random.default_rng(123)
    one = SortTaskConfig(cfg.vocab_size, cfg.min_nodes, cfg.max_nodes, 1)
    device = next(model.parameters()).device
    x, y = get_batch(rng, one, sort_pad_spec(one), device=device)
    with torch.no_grad():
        pred = model(x)
    n, e = int(x.n_node[0]), int(x.n_edge[0])
    values_onehot = x.nf[:n].float().cpu().numpy()
    values = values_onehot.argmax(-1) + 1
    is_min_pred = pred.nf[:n].argmax(-1).cpu().numpy()
    is_min_true = y.nf[:n].argmax(-1).cpu().numpy()
    print(f"values:      {values.tolist()}")
    print(f"is_min pred: {is_min_pred.tolist()}")
    print(f"is_min true: {is_min_true.tolist()}")
    ef_pred = pred.ef[:e].argmax(-1).cpu().numpy().reshape(n, n, order="F")
    ef_true = y.ef[:e].argmax(-1).cpu().numpy().reshape(n, n, order="F")
    print(f"edge-matrix match: {(ef_pred == ef_true).mean():.2%}")

    if svg_dir:
        from graphnets_tpu_torch.utils.viz import (sort_input_svg,
                                                   sort_target_svg)
        os.makedirs(svg_dir, exist_ok=True)
        renders = {
            "input.svg": sort_input_svg(values_onehot),
            "target.svg": sort_target_svg(is_min_true,
                                          ef_true.flatten(order="F")),
            "pred.svg": sort_target_svg(is_min_pred,
                                        ef_pred.flatten(order="F")),
        }
        for name, svg in renders.items():
            with open(os.path.join(svg_dir, name), "w") as f:
                f.write(svg)
        print(f"SVGs written to {svg_dir}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--core-dim", type=int, default=384)
    ap.add_argument("--n-cores", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--ckpt", type=str, default=None,
                    help="save the final training state here")
    ap.add_argument("--svg-dir", type=str, default=None,
                    help="write input/target/pred SVG renderings here")
    ap.add_argument("--host-loop", action="store_true",
                    help="one step a host-generated batch (train_sort) "
                    "instead of the device loop (train_sort_device)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = SortTaskConfig(batch_size=args.batch_size)
    if args.host_loop:
        res = train_sort(steps=args.steps, cfg=cfg,
                         core_dims=(args.core_dim,) * 3,
                         n_cores=args.n_cores, learning_rate=args.lr,
                         seed=args.seed, log_every=args.log_every,
                         device=args.device)
    else:
        # The default, as the JAX example's: a chunk of steps a host sync.
        chunk = max(1, min(500, args.steps,
                           args.log_every if args.log_every else 500))
        res = train_sort_device(
            steps=args.steps, cfg=cfg, core_dims=(args.core_dim,) * 3,
            n_cores=args.n_cores, learning_rate=args.lr, seed=args.seed,
            chunk=chunk, device=args.device,
            log_fn=(lambda step, m: print(
                f"step {step}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in m.items()), flush=True)))
    print(f"final metrics: {res.metrics}")
    print(f"throughput: {res.steps_per_sec:.2f} steps/s")
    show_sample(res.model, cfg, svg_dir=args.svg_dir)

    if args.ckpt:
        from graphnets_tpu_torch.training.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.ckpt)
        mgr.save(res.state.step, res.state, wait=True)
        mgr.close()
        print(f"checkpoint saved to {args.ckpt}")


if __name__ == "__main__":
    main()
