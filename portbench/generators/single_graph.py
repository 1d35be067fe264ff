"""Full-graph training on one large graph, the same graph every step.

Traffic keys: ``num_nodes``, ``num_edges``, ``in_flight`` (steps the host
may run ahead of the device), ``trace_warm_units`` / ``trace_units``.
The graph is ``benchmarks/bench_large_graph.py``'s, drawn on the device
from the seed: senders uniform over the nodes, receivers uniform and
sorted (in-degree Poisson), features of the core widths and node and edge
targets standard normal, in the configuration's feature type.  Each step
is ``capture_step(make_train_step(model, optimizer, graph_loss_nf_ef,
compute_dtype))(x, y)``.
"""

from __future__ import annotations

from typing import List

import torch

from reference.gn import Graphs


class Feed:
    steps_per_unit = 1

    def __init__(self, port, config: dict, traffic: dict, seed: int,
                 device):
        self.port, self.config, self.device = port, config, device
        N, E = traffic["num_nodes"], traffic["num_edges"]
        de, dn, dg = config["model"]["core_dims"]
        dtype = getattr(torch, config["feature_dtype"])
        gen = torch.Generator(device=device).manual_seed(seed)
        senders = torch.randint(0, N, (E,), generator=gen, device=device,
                                dtype=torch.int32)
        receivers = torch.randint(0, N, (E,), generator=gen, device=device,
                                  dtype=torch.int32).sort().values
        normal = lambda *s: torch.randn(*s, generator=gen,
                                        device=device).to(dtype)
        i32 = dict(dtype=torch.int32, device=device)
        self.x = port.GraphsTuple(
            senders=senders, receivers=receivers,
            node_graph=torch.zeros(N, **i32),
            edge_graph=torch.zeros(E, **i32),
            n_node=torch.tensor([N], **i32), n_edge=torch.tensor([E], **i32),
            node_mask=torch.ones(N, dtype=torch.bool, device=device),
            edge_mask=torch.ones(E, dtype=torch.bool, device=device),
            graph_mask=torch.ones(1, dtype=torch.bool, device=device),
            ef=normal(E, de), nf=normal(N, dn), gf=normal(1, dg))
        self.y = self.x.with_features(ef=normal(E, de), nf=normal(N, dn),
                                      gf=None)
        self.rows = (E, N, 1)
        self.host_batch_s = None

    def build_step(self, model, optimizer):
        cd = self.config.get("compute_dtype")
        self.step = self.port.capture_step(self.port.make_train_step(
            model, optimizer, self.port.graph_loss_nf_ef,
            compute_dtype=None if cd == "float32" else getattr(torch, cd)))
        return self.step

    def prefix_step(self) -> torch.Tensor:
        return self.step(self.x, self.y)["loss"]

    def begin_window(self) -> None:
        pass

    def unit(self, mark) -> List:
        with self.port.annotate("portbench.step"):
            loss = self.step(self.x, self.y)["loss"]
        mark()
        return [(loss, 1)]

    def window_rows(self, steps: int) -> List:
        return [self.rows] * steps

    def release(self) -> None:
        """Drop what holds the program's state (the captured step)."""
        del self.step

    def reference_batches(self, k: int) -> List:
        x, y = self.x, self.y
        f = lambda t: t.float()
        common = dict(senders=x.senders.long(), receivers=x.receivers.long(),
                      node_graph=x.node_graph.long(),
                      edge_graph=x.edge_graph.long(),
                      n_node=x.nf.shape[0], n_graph=1)
        gx = Graphs(nf=f(x.nf), ef=f(x.ef), gf=f(x.gf), **common)
        gy = Graphs(nf=f(y.nf), ef=f(y.ef), gf=None, **common)
        return [(gx, gy)] * k
