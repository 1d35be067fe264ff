"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), its checks (``cells/<cell>.json``), the
generator the traffic names (``generators/<generator>.py``), the model
and the plain reference of the configuration's model kind
(``models/<kind>.py``, ``reference/<kind>.py``) and each metric's reader
(``metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parents[1]      # portbench/
ROOT = HERE.parent                              # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def generator(self):
        return importlib.import_module(
            "generators." + self.traffic["generator"])

    def model(self):
        return importlib.import_module(
            "models." + self.config["model"]["kind"])

    def reference(self):
        return importlib.import_module(
            "reference." + self.config["model"]["kind"])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    return Cell(
        name=name, config=cfg,
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        checks=load_json(HERE / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if _reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)])
