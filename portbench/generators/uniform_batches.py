"""Training on mini-batches of mid-size graphs in the uniform slot layout:
``batches`` batches made once from the seed and cycled, one a step.

Traffic keys: ``graphs`` (a batch's graphs), ``nodes`` (a graph's),
``in_degree``, ``batches``, ``in_flight``, ``trace_warm_units`` /
``trace_units`` (a unit is a step).  Every node has ``in_degree`` distinct
in-neighbours of its own graph, drawn uniformly by a numpy generator
seeded from the seed (``chip_smoke.bench_graphs``'s graphs); the port's
``batch(..., pad=PadSpec.uniform(nodes, nodes * in_degree))`` lays each
batch out, its edges in column-major order of the adjacency (by receiver,
then sender).  Features of the core widths and node and edge targets are
standard normal in the configuration's feature type, drawn on the device
from the seed, one call a batch.  Each step copies its batch into the
captured step's inputs: ``capture_step(make_train_step(model, optimizer,
graph_loss_nf_ef, compute_dtype))(x, y)``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from generators import single_graph
from reference.gn import Graphs


def senders_by_receiver(rng: np.random.Generator, batches: int, graphs: int,
                        nodes: int, in_degree: int) -> np.ndarray:
    """``[batches, graphs, nodes, in_degree]``: the distinct in-neighbours
    of each node, ascending."""
    draw = rng.random((batches, graphs, nodes, nodes))
    return np.sort(np.argsort(draw, axis=-1)[..., :in_degree], axis=-1)


class Feed(single_graph.Feed):
    def __init__(self, port, config: dict, traffic: dict, seed: int,
                 device):
        self.port, self.config, self.device = port, config, device
        K, G = traffic["batches"], traffic["graphs"]
        n, deg = traffic["nodes"], traffic["in_degree"]
        E, N = G * n * deg, G * n
        de, dn, dg = config["model"]["core_dims"]
        dtype = getattr(torch, config["feature_dtype"])
        src = senders_by_receiver(np.random.default_rng(seed), K, G, n, deg)
        # The edge lists as the benchmark lays them out, for the reference.
        off = (np.arange(G) * n)[:, None, None]
        self.senders = torch.from_numpy((src + off).reshape(K, E))
        self.receivers = torch.arange(N).repeat_interleave(deg)
        self.graphs, self.nodes = G, n
        adj = np.zeros((K, G, n, n), np.int64)
        np.put_along_axis(adj.swapaxes(-1, -2), src, 1, axis=-1)
        pad = port.PadSpec.uniform(n, n * deg)
        # batch() lays out the structure and wants one feature set; the
        # features themselves are drawn on the device below.
        dummy = [np.zeros((n, 1), np.float32)] * G
        gen = torch.Generator(device=device).manual_seed(seed)
        widths = [(E, de), (N, dn), (G, dg), (E, de), (N, dn)]
        self.batches = []
        for k in range(K):
            g = port.batch({"graphs": list(adj[k]), "ef": None,
                            "nf": dummy, "gf": None}, pad=pad, device=device)
            flat = torch.randn(sum(r * d for r, d in widths), generator=gen,
                               device=device).to(dtype)
            ef, nf, gf, yef, ynf = (t.view(r, d) for t, (r, d) in zip(
                flat.split([r * d for r, d in widths]), widths))
            self.batches.append((g.with_features(ef=ef, nf=nf, gf=gf),
                                 g.with_features(ef=yef, nf=ynf, gf=None)))
        self.next = 0
        self.rows = (E, N, G)
        self.host_batch_s = None

    def _step(self) -> torch.Tensor:
        x, y = self.batches[self.next % len(self.batches)]
        self.next += 1
        return self.step(x, y)["loss"]

    def prefix_step(self) -> torch.Tensor:
        return self._step()

    def unit(self, mark) -> List:
        with self.port.annotate("portbench.step"):
            loss = self._step()
        mark()
        return [(loss, 1)]

    def reference_batches(self, k: int) -> List:
        """The first ``k`` steps' batches (the checked steps: the first
        ``k`` of the cycle), on the benchmark's own edge lists."""
        G, dev = self.graphs, self.device
        graph = torch.arange(G, device=dev)
        receivers = self.receivers.to(dev)
        out = []
        for i in range(k):
            x, y = self.batches[i]
            common = dict(senders=self.senders[i].to(dev),
                          receivers=receivers,
                          node_graph=graph.repeat_interleave(self.nodes),
                          edge_graph=graph.repeat_interleave(
                              receivers.numel() // G),
                          n_node=G * self.nodes, n_graph=G)
            out.append((Graphs(nf=x.nf.float(), ef=x.ef.float(),
                               gf=x.gf.float(), **common),
                        Graphs(nf=y.nf.float(), ef=y.ef.float(), gf=None,
                               **common)))
        return out
