"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds
its configuration, traffic, checks, generator, model, plain reference and
metric readers by name."""

import importlib
import re

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.benchmark()
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_token|dims")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_text(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_budget_fits_with_full_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert _text(e[k]), (e["name"], k)


def test_counts_and_bounds():
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_configs_files_and_reduced():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTHS.search(k), k
            assert k in cfg


def test_pairs_unique_and_metrics_reported():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in cells:
        per = [m for m in BENCH["per_layer"]
               if "workloads" not in m or w in m["workloads"]]
        e2e = [m for m in BENCH["end_to_end"]
               if "workloads" not in m or w in m["workloads"]]
        assert per and len(e2e) >= 2
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", ())) <= cells


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(name):
    cell = spec.cell(name)
    assert hasattr(cell.generator(), "Feed")
    model = cell.model()
    for fn in ("build", "make_weights", "step_flops"):
        assert callable(getattr(model, fn))
    ref = cell.reference()
    assert ref.__name__ == "reference." + cell.config["model"]["kind"]
    assert callable(ref.train) and callable(ref.half_batch)
    for m in cell.per_layer + cell.end_to_end:
        assert callable(importlib.import_module("metrics." + m["name"]).read)
    from harness import checks
    assert cell.checks["limits"] and set(cell.checks["limits"]) <= set(
        checks.NAMES)
