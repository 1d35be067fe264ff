"""GraphCast's one-step training on batches of whole samples:
``batches`` batches made once from the seed and cycled, one a step.

Traffic keys: ``samples`` (a batch's), ``batches``, ``in_flight``,
``trace_warm_units`` / ``trace_units`` (a unit is a step). The port
makes the configuration's graph once (``build_graphcast_graph``) and
``batch_samples`` lays ``samples`` copies of it out on the device,
padded to the kernels' row multiples. Each batch's grid inputs (all but
the last three channels, which are the grid's structural features) and
targets are standard normal f32, drawn on the device from the seed, one
call a batch; padding rows are zero. Each step copies its batch into the
captured step's inputs: ``capture_step(make_train_step(model, optimizer,
latitude_weighted_mse, compute_dtype))(x, y)``, whose one output is the
loss, weighted by GraphCast's latitude weights and by pressure level
(surface variables by the configuration's weights). Where the program's
tracing switch has changed since the last step (a traced run's second
stretch), the step's graphs are dropped first (``CapturedStep.clear``):
a graph's pool holds about one step's activations, ~39 GiB at 4 samples,
and the graph of the other switch is not replayed again.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from reference.graphcast import Batch


def channel_weights(model: dict) -> np.ndarray:
    """``w_j`` of each output channel: every atmospheric variable's levels
    at pressure over the mean level, then the surface variables'
    weights."""
    levels = np.asarray(model["pressure_levels"], np.float64)
    w = np.concatenate([np.tile(levels / levels.mean(),
                                model["atmospheric_variables"]),
                        model["surface_variable_weights"]])
    assert w.shape[0] == model["output_channels"]
    return w.astype(np.float32)


class Feed:
    steps_per_unit = 1

    def __init__(self, port, config: dict, traffic: dict, seed: int,
                 device):
        self.port, self.config, self.device = port, config, device
        m = config["model"]
        B, K = traffic["samples"], traffic["batches"]
        self.graph = port.build_graphcast_graph(
            m["resolution"], m["mesh_size"],
            m["radius_query_fraction_edge_length"])
        g = self.typed = port.batch_samples(self.graph, B, device=device)
        ng, rows = g.num_real_nodes["grid"], g.num_nodes("grid")
        c_in, c_out = m["input_channels"], m["output_channels"]
        structural = g.nodes["grid"][:ng]
        dtype = getattr(torch, config["feature_dtype"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.batches = []
        for _ in range(K):
            flat = torch.randn(ng * (c_in - 3 + c_out), generator=gen,
                               device=device)
            data, target = flat.split([ng * (c_in - 3), ng * c_out])
            grid = torch.zeros(rows, c_in, device=device, dtype=dtype)
            grid[:ng, :c_in - 3] = data.view(ng, c_in - 3)
            grid[:ng, c_in - 3:] = structural
            y = torch.zeros(rows, c_out, device=device, dtype=dtype)
            y[:ng] = target.view(ng, c_out)
            self.batches.append((g.with_nodes(grid=grid), y))
        self.node_weights = torch.from_numpy(np.tile(
            self.graph.latitude_weights, B)).to(device)
        self.channel_weights = torch.from_numpy(channel_weights(m)).to(
            device)
        self.samples, self.next = B, 0
        self.rows = (sum(e.num_real for e in g.edges.values()),
                     sum(g.num_real_nodes.values()), B)
        self.host_batch_s = None

    def build_step(self, model, optimizer):
        cd = self.config.get("compute_dtype")
        loss = functools.partial(self.port.latitude_weighted_mse,
                                 node_weights=self.node_weights,
                                 channel_weights=self.channel_weights)
        self.step = self.port.capture_step(self.port.make_train_step(
            model, optimizer, loss,
            compute_dtype=None if cd == "float32" else getattr(torch, cd)))
        self.traced = self.port.tracing()
        return self.step

    def _step(self) -> torch.Tensor:
        traced = self.port.tracing()
        if traced != self.traced:
            self.step.clear()
            self.traced = traced
        x, y = self.batches[self.next % len(self.batches)]
        self.next += 1
        return self.step(x, y)["loss"]

    def prefix_step(self) -> torch.Tensor:
        return self._step()

    def begin_window(self) -> None:
        pass

    def unit(self, mark) -> List:
        with self.port.annotate("portbench.step"):
            loss = self._step()
        mark()
        return [(loss, 1)]

    def window_rows(self, steps: int) -> List:
        return [self.rows] * steps

    def release(self) -> None:
        """Drop what holds the program's state (the captured step)."""
        del self.step

    def reference_batches(self, k: int) -> List:
        """The first ``k`` steps' batches (the checked steps: the first
        ``k`` of the cycle) on real rows, for the plain reference."""
        g = self.typed
        ng, nm = g.num_real_nodes["grid"], g.num_real_nodes["mesh"]
        edges = {name: (e.senders[:e.num_real].long(),
                        e.receivers[:e.num_real].long(),
                        e.features[:e.num_real].float())
                 for name, e in g.edges.items()}
        out = []
        for i in range(k):
            x, y = self.batches[i]
            out.append((Batch(
                nodes={"grid": x.nodes["grid"][:ng].float(),
                       "mesh": g.nodes["mesh"][:nm].float()},
                edges=edges, node_weights=self.node_weights,
                channel_weights=self.channel_weights, samples=self.samples,
                grid_nodes=ng // self.samples), y[:ng].float()))
        return out
