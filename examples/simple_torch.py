#!/usr/bin/env python
"""The three README examples on the PyTorch port (``graphnets_tpu_torch``),
the counterpart of ``examples/simple.py``.

1. GNBlock on a batch sharing one adjacency matrix.
2. GNCore on a heterogeneous batch (different structures), and the views.
3. Encoder -> GNCoreList -> decoder stack.

It runs on a CUDA device unless ``--device cpu`` is given.

Usage:
    python examples/simple_torch.py
    python examples/simple_torch.py --device cpu
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np
import torch

import graphnets_tpu_torch as gn


def example_1(device):
    """Same graph structure across the batch."""
    x_de, x_dn, x_dg = 10, 5, 0
    y_de, y_dn, y_dg = 3, 4, 5
    adj = np.array([[1, 0, 1],
                    [1, 1, 0],
                    [0, 0, 1]])
    n, e, b = 3, int((adj == 1).sum()), 2
    rng = np.random.default_rng(0)
    x = gn.batch({
        "graphs": adj,
        "ef": rng.random((b, e, x_de), dtype=np.float32),
        "nf": rng.random((b, n, x_dn), dtype=np.float32),
        "gf": None,
    }, device=device)
    block = gn.GNBlock((x_de, x_dn, x_dg), (y_de, y_dn, y_dg),
                       device=device)
    with torch.no_grad():
        y = block(x)
    out = gn.unbatch(y)
    assert out["ef"].shape == (b, e, y_de)
    assert out["nf"].shape == (b, n, y_dn)
    assert out["gf"].shape == (b, y_dg)
    print("example 1 ok:", out["ef"].shape, out["nf"].shape,
          out["gf"].shape)


def example_2(device):
    """Different graph structures in one batch, and views into it."""
    de, dn, dg = 3, 4, 5
    adj1 = np.array([[1, 0, 1], [1, 1, 0], [0, 0, 1]])
    adj2 = np.array([[1, 0, 1, 0], [1, 1, 0, 1],
                     [0, 0, 1, 0], [1, 1, 0, 1]])
    e1, e2 = int((adj1 == 1).sum()), int((adj2 == 1).sum())
    rng = np.random.default_rng(1)
    x = gn.batch({
        "graphs": [adj1, adj2],
        "ef": [rng.random((e1, de), dtype=np.float32),
               rng.random((e2, de), dtype=np.float32)],
        "nf": [rng.random((3, dn), dtype=np.float32),
               rng.random((4, dn), dtype=np.float32)],
        "gf": [rng.random(dg).astype(np.float32),
               rng.random(dg).astype(np.float32)],
    }, device=device)
    core = gn.GNCore((de, dn, dg), device=device)
    with torch.no_grad():
        y = core(x)
    out = gn.unbatch(y)
    assert out["ef"][0].shape == (e1, de) and out["ef"][1].shape == (e2, de)
    second_edge_graph2 = gn.efview(y, slice(None), 1, 1)
    first_node_graph1 = gn.nfview(y, slice(None), 0, 0)
    globals_graph2 = gn.gfview(y, slice(None), 1)
    assert second_edge_graph2.shape == (de,)
    assert first_node_graph1.shape == (dn,)
    assert globals_graph2.shape == (dg,)
    print("example 2 ok")


def example_3(device):
    """Encoder -> 2x GNCore -> decoder."""
    x_dims, core_dims, y_dims = (0, 8, 0), (16, 16, 16), (2, 2, 0)
    adjs = [np.ones((4, 4), int), np.ones((3, 3), int)]
    rng = np.random.default_rng(2)
    x = gn.batch({
        "graphs": adjs, "ef": None,
        "nf": [rng.random((4, 8), dtype=np.float32),
               rng.random((3, 8), dtype=np.float32)],
        "gf": None,
    }, device=device)
    model = gn.EncodeProcessDecode(x_dims, core_dims, y_dims, n_cores=2,
                                   device=device)
    with torch.no_grad():
        y = model(x)
    out = gn.unbatch(y)
    assert out["nf"][0].shape == (4, 2) and out["ef"][1].shape == (9, 2)
    assert out["gf"] is None
    print("example 3 ok")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    device = ap.parse_args().device
    example_1(device)
    example_2(device)
    example_3(device)
