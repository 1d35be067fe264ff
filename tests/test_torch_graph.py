"""The port's batching against graphnets_tpu, its default device, and its
independence from JAX.

``batch`` must give exactly the JAX package's arrays (values, dtypes,
``slot_shape``, ``pad_aliases_real``, ``homogeneous``) for the same numpy
inputs.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import graphnets_tpu as gn
import graphnets_tpu_torch as pt

REPO = pathlib.Path(__file__).resolve().parents[1]
_FIELDS = ("senders", "receivers", "node_graph", "edge_graph", "n_node",
           "n_edge", "node_mask", "edge_mask", "graph_mask", "ef", "nf",
           "gf")
_DTYPES = {"int32": torch.int32, "bool": torch.bool,
           "float32": torch.float32}


def _hetero(seed, sizes, d=3, p=0.4):
    rng = np.random.default_rng(seed)
    adjs = [(rng.random((n, n)) < p).astype(np.int64) for n in sizes]
    return {"graphs": adjs,
            "ef": [rng.normal(size=(int(a.sum()), d)).astype(np.float32)
                   for a in adjs],
            "nf": [rng.normal(size=(a.shape[0], d)).astype(np.float32)
                   for a in adjs],
            "gf": rng.normal(size=(len(adjs), d)).astype(np.float32)}


def _homo(seed, B=3, n=5, d=2):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.5).astype(np.int64)
    e = int(adj.sum())
    return {"graphs": adj, "ef": rng.normal(size=(B, e, d)),
            "nf": rng.normal(size=(B, n, d)), "gf": None}


_CASES = {
    "homogeneous_exact": (lambda: _homo(0), None),
    "homogeneous_bucketed": (lambda: _homo(1), gn.PadSpec.bucketed(15, 40, 3)),
    "hetero_exact": (lambda: _hetero(2, [4, 6, 3]), None),
    "hetero_padded": (lambda: _hetero(3, [4, 6, 3]), gn.PadSpec(16, 64, 4)),
    "uniform_exact": (lambda: _homo(4, n=8), gn.PadSpec.uniform(8, 1)),
    "uniform_padded": (lambda: _hetero(5, [5, 7, 3]),
                       gn.PadSpec.uniform(8, 40)),
    "uniform_extra_slots": (lambda: _hetero(6, [5, 7]),
                            gn.PadSpec.uniform(8, 40, num_graphs=4)),
    "nodes_only": (lambda: {**_hetero(7, [4, 5]), "ef": None, "gf": None},
                   None),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_batch_matches_jax(case):
    make, pad = _CASES[case]
    data = make()
    if case == "uniform_exact":
        # Exact capacity: every node has a full in-row (e_slots == E).
        data["graphs"] = np.ones((8, 8), np.int64)
        data["ef"] = np.random.default_rng(4).normal(size=(3, 64, 2))
        pad = gn.PadSpec(8, 64, per_slot=True)
    gj = gn.batch(data, pad=pad)
    gp = pt.batch(data, pad=pad, device="cpu")
    for f in _FIELDS:
        a, b = getattr(gj, f), getattr(gp, f)
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        assert b.device.type == "cpu"
        assert b.dtype == _DTYPES[str(a.dtype)], (f, b.dtype, a.dtype)
        np.testing.assert_array_equal(b.numpy(), a, err_msg=f)
    assert gp.slot_shape == gj.slot_shape
    assert gp.pad_aliases_real == gj.pad_aliases_real
    assert gp.homogeneous == gj.homogeneous
    assert (gp.num_node_slots, gp.num_edge_slots, gp.num_graph_slots) == \
        (gj.num_node_slots, gj.num_edge_slots, gj.num_graph_slots)


@pytest.mark.parametrize("case", ["homogeneous_bucketed", "hetero_padded",
                                  "uniform_padded", "uniform_extra_slots"])
def test_unbatch_matches_jax(case):
    make, pad = _CASES[case]
    data = make()
    uj = gn.unbatch(gn.batch(data, pad=pad))
    up = pt.unbatch(pt.batch(data, pad=pad, device="cpu"))
    for key in ("graphs", "ef", "nf", "gf"):
        a, b = uj[key], up[key]
        if a is None:
            assert b is None
            continue
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_with_features_keeps_structure():
    g = pt.batch(_hetero(8, [4, 5]), pad=pt.PadSpec.uniform(8, 32),
                 device="cpu")
    h = g.with_features(nf=g.nf * 2, gf=None)
    assert h.ef is g.ef and h.gf is None and h.senders is g.senders
    assert h.slot_shape == g.slot_shape
    assert h.pad_aliases_real == g.pad_aliases_real


@pytest.mark.parametrize("bad", ["capacity", "no_pad_node"])
def test_uniform_layout_errors_match_jax(bad):
    data = _hetero(9, [6, 8])
    pad = (gn.PadSpec.uniform(8, 16) if bad == "capacity"
           else gn.PadSpec(8, 128, per_slot=True))
    if bad == "capacity":
        data["graphs"][1] = np.ones((8, 8), np.int64)
        data["ef"][1] = np.zeros((64, 3), np.float32)
    else:
        data["graphs"][1] = (np.random.default_rng(0).random((8, 8)) < 0.3
                             ).astype(np.int64)
        data["ef"][1] = np.zeros((int(data["graphs"][1].sum()), 3),
                                 np.float32)
    with pytest.raises(ValueError):
        gn.batch(data, pad=pad)
    with pytest.raises(ValueError):
        pt.batch(data, pad=pad, device="cpu")


def test_default_device_is_cuda():
    """Without ``device="cpu"`` the port runs on the card, and without a
    card it raises rather than run on the CPU."""
    data = _hetero(10, [4, 5])
    makers = [lambda: pt.batch(data),
              lambda: pt.GNCore((8, 8, 8)),
              lambda: pt.Linear(4, 4),
              lambda: pt.LayerNorm(4)]
    if torch.cuda.is_available():
        assert pt.batch(data).senders.is_cuda
        assert pt.Linear(4, 4).w.is_cuda
    else:
        for make in makers:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    assert pt.batch(data, device="cpu").senders.device.type == "cpu"


def test_import_leaves_jax_out():
    code = ("import sys; before = set(sys.modules); "
            "import graphnets_tpu_torch, graphnets_tpu_torch.params, "
            "graphnets_tpu_torch.ops.kernels.edge_update, "
            "graphnets_tpu_torch.ops.kernels.fused_ffn, "
            "graphnets_tpu_torch.ops.kernels.segment_sum, "
            "graphnets_tpu_torch.ops.kernels.gather, "
            "graphnets_tpu_torch.ops.kernels.ln_linear, "
            "graphnets_tpu_torch.training.train; "
            "new = set(sys.modules) - before; "
            "bad = sorted(m for m in new if m == 'jax' "
            "or m.startswith('jax.') or m == 'graphnets_tpu' "
            "or m.startswith('graphnets_tpu.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_imports_in_port_sources():
    files = sorted((REPO / "graphnets_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "graphnets_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"
