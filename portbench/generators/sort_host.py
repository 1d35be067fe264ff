"""The sort recipe through the host loop, as ``examples/sort_torch.py
--host-loop`` (``train_sort``) and GraphNets.jl's own ``getbatch`` run it:
each step's samples are made on the host, the port's ``batch(...,
pad=sort_pad_spec(task), device)`` builds the input and the target, and
``capture_step(make_train_step(model, optimizer))`` copies them in and
replays.

Traffic keys: ``in_flight``, ``trace_warm_units`` / ``trace_units`` (a
unit is a step).  A sample is ``gen_sample``'s: ``n`` uniform in
``[min_nodes, max_nodes]``, then ``n`` values uniform in ``[1, vocab]``
from a numpy generator seeded from the seed; the full adjacency, the
one-hot values, the "is a minimum" node targets and the "follows in
sorted order" edge targets in column-major edge order.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from reference.sort_task import sort_graphs


def sample(rng: np.random.Generator, task: dict):
    """``(n, values, adjacency, x_nf, y_nf, y_ef)`` of one graph."""
    n = int(rng.integers(task["min_nodes"], task["max_nodes"] + 1))
    values = rng.integers(1, task["vocab_size"] + 1, size=n)
    x_nf = np.eye(task["vocab_size"], dtype=np.float32)[values - 1]
    y_nf = np.eye(2, dtype=np.float32)[(values == values.min()).astype(int)]
    order = np.argsort(values, kind="stable")
    follows = np.zeros((n, n), dtype=int)
    follows[order[:-1], order[1:]] = 1
    y_ef = np.eye(2, dtype=np.float32)[follows.flatten(order="F")]
    return n, values, np.ones((n, n), dtype=np.int64), x_nf, y_nf, y_ef


class Feed:
    steps_per_unit = 1

    def __init__(self, port, config: dict, traffic: dict, seed: int,
                 device):
        self.port, self.config, self.device = port, config, device
        self.task = config["task"]
        self.rng = np.random.default_rng(seed)
        self.values: List[List[np.ndarray]] = []   # every step's graphs
        self.host_batch_s: List[float] = []
        self._window_start = 0

    def build_step(self, model, optimizer):
        port, t = self.port, self.task
        self.pad = port.sort_pad_spec(port.SortTaskConfig(
            vocab_size=t["vocab_size"], min_nodes=t["min_nodes"],
            max_nodes=t["max_nodes"], batch_size=t["batch_size"]))
        self.step = port.capture_step(port.make_train_step(model, optimizer))
        return self.step

    def _batch(self):
        samples = [sample(self.rng, self.task)
                   for _ in range(self.task["batch_size"])]
        self.values.append([s[1] for s in samples])
        adjs = [s[2] for s in samples]
        t0 = time.perf_counter()
        x = self.port.batch({"graphs": adjs, "ef": None,
                             "nf": [s[3] for s in samples], "gf": None},
                            pad=self.pad, device=self.device)
        y = self.port.batch({"graphs": adjs, "ef": [s[5] for s in samples],
                             "nf": [s[4] for s in samples], "gf": None},
                            pad=self.pad, device=self.device)
        self.host_batch_s.append(time.perf_counter() - t0)
        return x, y

    def prefix_step(self) -> torch.Tensor:
        return self.step(*self._batch())["loss"]

    def begin_window(self) -> None:
        self._window_start = len(self.values)

    def unit(self, mark) -> List:
        with self.port.annotate("portbench.batch"):
            x, y = self._batch()
        with self.port.annotate("portbench.step"):
            loss = self.step(x, y)["loss"]
        mark()
        return [(loss, 1)]

    def window_rows(self, steps: int) -> List:
        s = self._window_start
        return [(sum(len(v) ** 2 for v in vs), sum(len(v) for v in vs),
                 len(vs)) for vs in self.values[s:s + steps]]

    def window_batch_s(self, steps: int) -> List[float]:
        s = self._window_start
        return self.host_batch_s[s:s + steps]

    def release(self) -> None:
        """Drop what holds the program's state (the captured step)."""
        del self.step

    def reference_batches(self, k: int) -> List:
        return [sort_graphs([torch.from_numpy(v) for v in vs],
                            self.task["vocab_size"], self.device)
                for vs in self.values[:k]]
