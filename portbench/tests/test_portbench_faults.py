"""A whole run, past the look for a card, with the timed path broken
underneath: ``correct`` comes out false for each fault a training cell
can have (its state left unchanged; half of the batch left out of the
loss's mean).  A sound run of the f32 recipe comes out true.  On the CPU,
with the traffic cut so a run fits a test: the large graph at 512 nodes
and 8,192 edges, the sort recipe's chunks at 2 steps, the mini-batches 4
of 4 graphs."""

import io
import json
import time

import pytest
import torch

from graphnets_tpu_torch.training import losses
from harness import runner, spec

CELLS = ("lg256.one_graph", "sort384.device_loop", "sort384.host_loop",
         "lg256.batch8x128")


def _cell(name):
    cell = spec.cell(name)
    if cell.traffic["generator"] == "single_graph":
        cell.traffic.update(num_nodes=512, num_edges=8192)
    if "chunk" in cell.traffic:
        cell.traffic["chunk"] = 2
    if cell.traffic["generator"] == "uniform_batches":
        cell.traffic.update(batches=4, graphs=4)
    return cell


def _run(name, seed=2 ** 33 + 7):
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run(_cell(name), seed, 0.05, False, "cpu",
                    time.perf_counter(), out, err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return result


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged(name, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    result = _run(name)
    assert result["correct"] is False
    # Unmoved parameters and an empty first moment read 1 by the gaps.
    assert max(v["value"] for k, v in result["checks"].items()
               if k.startswith(("grad", "change"))) > 0.9


def _half_rows(logits, targets, mask):
    first = mask & (torch.cumsum(mask.long(), 0) <= mask.sum() // 2)
    return _ce(logits, targets, first)


_ce = losses.masked_logit_crossentropy


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out(name, monkeypatch):
    monkeypatch.setattr(losses, "masked_logit_crossentropy", _half_rows)
    result = _run(name)
    assert result["correct"] is False
    limits = spec.cell(name).checks["limits"]
    assert any(result["checks"][k]["value"] > limits[k] for k in limits)


@pytest.mark.parametrize("name", ["sort384.device_loop", "sort384.host_loop"])
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"] is True, result["checks"]
