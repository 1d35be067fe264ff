"""The sort recipe with its batches drawn on the card inside the captured
step, as the JAX package and ``examples/sort_torch.py`` run it by
default: ``capture_step(make_sort_device_step(state, task,
sort_pad_spec(task)))``, a chunk of ``chunk`` replays, then one host sync
that reads the chunk's mean metrics.

Traffic keys: ``chunk``, ``in_flight``, ``trace_warm_units`` /
``trace_units`` (a unit is a chunk).  The batch generator is a
``torch.Generator`` on the card seeded from the seed.  Each step draws
``n [B]`` node counts uniform in ``[min_nodes, max_nodes]``, then
``values [B, max_nodes]`` uniform in ``[1, vocab]`` (graph ``b`` holds the
first ``n[b]``), the order of JAX's ``device_batch``; the benchmark draws
the same again from the same generator state to know each step's real
edges and to hand the reference its batches.
"""

from __future__ import annotations

from typing import List

import torch

from reference.sort_task import sort_graphs


class Feed:
    def __init__(self, port, config: dict, traffic: dict, seed: int,
                 device):
        self.port, self.config, self.device = port, config, device
        self.task = config["task"]
        self.steps_per_unit = traffic["chunk"]
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.host_batch_s = None

    def build_step(self, model, optimizer):
        port, t = self.port, self.task
        cfg = port.SortTaskConfig(vocab_size=t["vocab_size"],
                                  min_nodes=t["min_nodes"],
                                  max_nodes=t["max_nodes"],
                                  batch_size=t["batch_size"])
        state = port.TrainState(model, optimizer, 0, (self.gen,))
        self.inner = port.make_sort_device_step(state, cfg,
                                                port.sort_pad_spec(cfg))
        self.sums = list(self.inner.sums.values())
        self.loss_sum = self.inner.sums["loss"]
        self.first_state = self.gen.get_state()
        self.step = port.capture_step(self.inner)
        return self.step

    def _zero(self) -> None:
        for v in self.sums:
            v.zero_()

    def prefix_step(self) -> torch.Tensor:
        self._zero()
        self.step()
        return self.loss_sum.clone()

    def begin_window(self) -> None:
        self.window_state = self.gen.get_state()

    def unit(self, mark) -> List:
        self._zero()
        for _ in range(self.steps_per_unit):
            with self.port.annotate("portbench.step"):
                self.step()
            mark()
        with self.port.annotate("portbench.sync"):
            mean = float(self.loss_sum) / self.steps_per_unit
        return [(mean, self.steps_per_unit)]

    def _draws(self, state, k: int) -> List[torch.Tensor]:
        """The node counts and values of ``k`` steps drawn from ``state``,
        as lists of the values of each graph, a list a step."""
        t, dev = self.task, self.device
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        B, MN = t["batch_size"], t["max_nodes"]
        out = []
        for _ in range(k):
            n = torch.randint(t["min_nodes"], MN + 1, (B,), generator=gen,
                              device=dev, dtype=torch.int32)
            v = torch.randint(1, t["vocab_size"] + 1, (B, MN), generator=gen,
                              device=dev, dtype=torch.int32)
            out.append((n, v))
        return out

    def window_rows(self, steps: int) -> List:
        draws = self._draws(self.window_state, steps)
        ns = torch.stack([n for n, _ in draws]).long().cpu()
        return [(int((n * n).sum()), int(n.sum()), n.numel()) for n in ns]

    def release(self) -> None:
        """Drop what holds the program's state (the captured step)."""
        del self.step, self.inner, self.sums, self.loss_sum

    def reference_batches(self, k: int) -> List:
        return [sort_graphs([v[b, :int(n[b])] for b in range(n.numel())],
                            self.task["vocab_size"], self.device)
                for n, v in self._draws(self.first_state, k)]
