"""GraphCast in the port (``models/graphcast.py``, ``typed_graph.py``,
``data/graphcast_mesh.py``, ``training/losses.latitude_weighted_mse``):
the graph's counts and order at 1 degree and against brute force at a
small size, the latitude weights, the batch's layout, the model on a
padded batch against the plain f32 reference
``tests/graphcast_reference.py`` on the real rows (loss, gradients, three
AdamW steps), the captured step, the benchmark's copy of the reference,
the stage markers' order, and the step's metrics by the prediction's
type.  All on the CPU; the file imports neither JAX nor the JAX package."""

import importlib
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu_torch.data import graphcast_mesh as gm
from graphnets_tpu_torch.utils import profiling
from graphnets_tpu_torch.utils.tree import map_tensors, structure, tensors

sys.path.insert(0, str(Path(__file__).resolve().parent))
import graphcast_reference as ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(resolution=10.0, mesh_size=2)
CI, CO, D, LAYERS, B = 10, 5, 32, 2, 2


@pytest.fixture(scope="module")
def one_degree():
    return pt.build_graphcast_graph(1.0, 5, 0.6)


@pytest.fixture(scope="module")
def small():
    return pt.build_graphcast_graph(**SMALL)


def test_one_degree_counts_and_order(one_degree):
    g = one_degree
    assert g.nodes["grid"].shape == (181 * 360, 3)
    assert g.nodes["mesh"].shape == (10_242, 3)
    counts = {k: s.shape[0] for k, (s, _, _) in g.edges.items()}
    # The g2m count is this construction's (GraphCast's orientation of the
    # icosahedron, radius 0.6 of the finest level's longest edge).
    assert counts == {"g2m": 101_892, "mesh": 81_900, "m2g": 3 * 65_160}
    for name, (s, r, f) in g.edges.items():
        assert bool((np.diff(r) >= 0).all()), name
        same = r[1:] == r[:-1]
        assert bool((np.diff(s)[same] > 0).all()), name   # then by sender
        assert f.shape == (s.shape[0], 4) and f.dtype == np.float32
        assert np.isclose(f[:, 0].max(), 1.0)
    # Every grid node reaches the mesh, every mesh node the grid.
    s, r, _ = g.edges["g2m"]
    assert np.unique(s).size == 65_160 and np.unique(r).size == 10_242


@pytest.mark.parametrize("level", range(6))
def test_mesh_levels(level):
    v, faces = gm.icosahedral_meshes(level)
    assert v.shape == (10 * 4 ** level + 2, 3)
    assert np.allclose(np.linalg.norm(v, axis=1), 1.0)
    assert len(faces) == level + 1
    for lv, f in enumerate(faces):
        assert f.shape == (20 * 4 ** lv, 3)
        assert f.max() < 10 * 4 ** lv + 2       # a prefix of the finest
        a, b, c = (v[f[:, i]] for i in range(3))
        assert bool((np.einsum("ij,ij->i", np.cross(b - a, c - a), a) > 0)
                    .all())                     # counter-clockwise
    s, r = gm._multi_mesh_edges(faces)
    assert s.shape[0] == 2 * sum(30 * 4 ** lv for lv in range(level + 1))


def _pos(lat_deg, lon_deg):
    lat, lon = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)], -1)


def test_small_graph_against_brute_force(small):
    g = small
    grid = _pos(g.grid_lat, g.grid_lon)
    v, levels = gm.icosahedral_meshes(SMALL["mesh_size"])
    fin = levels[-1][:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)
    radius = 0.6 * np.linalg.norm(v[fin[:, 0]] - v[fin[:, 1]], axis=1).max()
    d = np.linalg.norm(grid[:, None] - v[None], axis=-1)
    gi, mi = np.nonzero(d <= radius)
    order = np.lexsort((gi, mi))
    s, r, _ = g.edges["g2m"]
    assert np.array_equal(s, gi[order]) and np.array_equal(r, mi[order])
    # m2g: every grid node inside its triangle (each edge plane's signed
    # distance >= 0 up to rounding), the three vertices ascending.
    s, r, _ = g.edges["m2g"]
    assert np.array_equal(r, np.repeat(np.arange(len(grid)), 3))
    tri = s.reshape(-1, 3)
    assert bool((np.diff(tri, axis=1) > 0).all())
    faces = {tuple(sorted(f)) for f in levels[-1]}
    assert all(tuple(t) in faces for t in tri)
    a, b, c = (v[tri[:, i]] for i in range(3))
    for p, q in ((a, b), (b, c), (c, a)):
        n = np.cross(p, q)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        side = np.einsum("ij,ij->i", n, grid)
        # Orientation of the sorted triple may be either way round.
        orient = np.sign(np.einsum("ij,ij->i", np.cross(b - a, c - a), a))
        assert bool((side * orient >= -1e-12).all())


# Grid rows (degrees) checked at 1 degree: both poles and their neighbours,
# the equator with its neighbours, and rows between.
STRIP = (-90, -89, -45, -1, 0, 1, 37, 89, 90)


def _frame_features(sender_pos, receiver_pos, receiver_lon, scale):
    """``[|d|, d]`` over ``scale``, ``d`` the sender minus the receiver in
    the receiver's (up, east, north) frame, from the frame's vectors."""
    lat = np.arcsin(np.clip(receiver_pos[:, 2], -1.0, 1.0))
    east = np.stack([-np.sin(receiver_lon), np.cos(receiver_lon),
                     np.zeros_like(lat)], -1)
    north = np.stack([-np.sin(lat) * np.cos(receiver_lon),
                      -np.sin(lat) * np.sin(receiver_lon), np.cos(lat)], -1)
    d = sender_pos - receiver_pos
    local = np.stack([np.einsum("ij,ij->i", d, e)
                      for e in (receiver_pos, east, north)], -1)
    return np.concatenate([np.linalg.norm(d, axis=1, keepdims=True), local],
                          -1) / scale


def test_one_degree_strip_against_brute_force(one_degree):
    """The 1 degree graph on the rows ``STRIP``: its g2m edges against every
    mesh node, its m2g triangles against every finest face, the node
    features and every feature of these edges recomputed from the
    positions (the sets' longest edges from all their edges)."""
    g = one_degree
    v, levels = gm.icosahedral_meshes(5)
    lat_deg = np.repeat(np.arange(-90, 91), 360)
    lon_deg = np.tile(np.arange(360), 181)
    grid = _pos(lat_deg, lon_deg)
    rows = np.flatnonzero(np.isin(lat_deg, STRIP))
    glat, glon = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    assert np.allclose(g.nodes["grid"], np.stack(
        [np.cos(glat), np.sin(glon), np.cos(glon)], -1), atol=1e-6)
    mlat, mlon = np.arcsin(v[:, 2]), np.arctan2(v[:, 1], v[:, 0])
    assert np.allclose(g.nodes["mesh"], np.stack(
        [np.cos(mlat), np.sin(mlon), np.cos(mlon)], -1), atol=1e-6)
    pos = {"g2m": (grid, v, mlon), "mesh": (v, v, mlon),
           "m2g": (v, grid, glon)}
    scale = {k: np.linalg.norm(pos[k][0][s] - pos[k][1][r], axis=1).max()
             for k, (s, r, _) in g.edges.items()}

    def check_features(name, pick):
        s, r, f = (a[pick] for a in g.edges[name])
        src, dst, lon = pos[name]
        want = _frame_features(src[s], dst[r], lon[r], scale[name])
        assert np.allclose(f, want, rtol=0, atol=2e-6), name

    fin = levels[-1][:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)
    radius = 0.6 * np.linalg.norm(v[fin[:, 0]] - v[fin[:, 1]], axis=1).max()
    s, r, _ = g.edges["g2m"]
    pick = np.isin(s, rows)
    want = set()
    for lat in STRIP:
        row = rows[lat_deg[rows] == lat]
        d2 = ((grid[row, None, :] - v[None, :, :]) ** 2).sum(-1)
        gi, mi = np.nonzero(d2 <= radius * radius)
        want |= set(zip(row[gi].tolist(), mi.tolist()))
    assert set(zip(s[pick].tolist(), r[pick].tolist())) == want
    check_features("g2m", pick)
    # m2g: each point's triangle is a finest face that holds it (every
    # edge plane's signed distance >= 0 up to rounding; a point on an edge
    # or a vertex lies in several).
    a, b, c = (v[levels[-1][:, i]] for i in range(3))
    n = np.stack([np.cross(a, b), np.cross(b, c), np.cross(c, a)], 1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    faces = np.sort(levels[-1], axis=1)
    s, r, _ = g.edges["m2g"]
    tri = s.reshape(-1, 3)
    for chunk in np.array_split(rows, 54):
        inside = np.einsum("fej,pj->pfe", n, grid[chunk]).min(-1) >= -1e-12
        for p, holds in zip(chunk, inside):
            assert holds.any(), p
            assert any((faces[holds] == tri[p]).all(1)), p
    check_features("m2g", np.isin(r, rows))
    # The mesh edges whose receivers these rows' g2m edges reach.
    s, r, _ = g.edges["mesh"]
    check_features("mesh", np.isin(r, g.edges["g2m"][1][pick]))


def test_edge_features_in_the_receivers_frame():
    # A sender due north of a receiver at (lat 0, lon 90): only z grows.
    s, r = _pos(np.array([10.0]), np.array([90.0])), _pos(
        np.array([0.0]), np.array([90.0]))
    f = gm._edge_features(s, r)
    d = np.array([math.cos(math.radians(10)) - 1, 0.0,
                  math.sin(math.radians(10))])
    assert np.allclose(f[0], np.concatenate([[1.0], d / np.linalg.norm(d)]),
                       atol=1e-6)


def test_latitude_weights():
    lat = np.linspace(-90, 90, 181)
    w = pt.graphcast_latitude_weights(lat)
    assert w.mean() == pytest.approx(1.0, abs=1e-12)
    assert np.allclose(w, w[::-1], rtol=0, atol=1e-12)     # symmetric
    delta = math.radians(1.0)
    raw = np.cos(np.deg2rad(lat)) * math.sin(delta / 2)
    raw[[0, -1]] = math.sin(delta / 4) ** 2                 # polar caps
    assert np.allclose(w, raw / raw.mean(), rtol=1e-12)
    assert w[0] == w[-1] and w[0] < w[1] < w[90]             # poles least
    assert w[90] == w.max()


def _batch(graph, samples=B, seed=0):
    tg = pt.batch_samples(graph, samples, device="cpu")
    ng = tg.num_real_nodes["grid"]
    gen = torch.Generator().manual_seed(seed)
    grid = torch.zeros(tg.num_nodes("grid"), CI)
    grid[:ng, :CI - 3] = torch.randn(ng, CI - 3, generator=gen)
    grid[:ng, CI - 3:] = tg.nodes["grid"][:ng]
    y = torch.zeros(tg.num_nodes("grid"), CO)
    y[:ng] = torch.randn(ng, CO, generator=gen)
    return tg.with_nodes(grid=grid), y


def _weights(graph, samples=B):
    return (torch.from_numpy(np.tile(graph.latitude_weights, samples)),
            torch.tensor([1.0, 0.5, 2.0, 1.0, 0.1]))


def _model(seed=0):
    return pt.GraphCast(grid_in=CI, grid_out=CO, latent=D, hidden=D,
                        n_layers=LAYERS, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def _ref_graph(x):
    ng, nm = x.num_real_nodes["grid"], x.num_real_nodes["mesh"]
    return {"nodes": {"grid": x.nodes["grid"][:ng],
                      "mesh": x.nodes["mesh"][:nm]},
            "edges": {k: (e.senders[:e.num_real].long(),
                          e.receivers[:e.num_real].long(),
                          e.features[:e.num_real])
                      for k, e in x.edges.items()}}


def test_batch_layout(small):
    x, _ = _batch(small)
    for name, src, dst in gm.EDGE_SETS:
        e = x.edges[name]
        r = e.receivers
        assert bool((r[1:] >= r[:-1]).all()), name
        assert e.senders.shape[0] % 128 == 0 and e.senders.dtype == torch.int32
        # Padding edges run from a padding row to a padding row; real
        # edges stay within their sample's real rows.
        assert bool((e.senders[e.num_real:] == x.num_real_nodes[src]).all())
        assert bool((e.receivers[e.num_real:] == x.num_real_nodes[dst]).all())
        assert bool((e.senders[:e.num_real] < x.num_real_nodes[src]).all())
        assert bool((r[:e.num_real] < x.num_real_nodes[dst]).all())
    for name, n in x.num_real_nodes.items():
        assert x.num_nodes(name) % 32 == 0 and x.num_nodes(name) > n


def test_forward_loss_and_gradients_against_the_reference(small):
    """f32 throughout.  Tolerances: the loss 1e-5 relative and each
    gradient 1e-4 of its norm, a few f32 roundings' worth after 2 layers:
    the port sums the split first layer's three products where the
    reference takes one product of the concatenation, and sums edges in
    another order."""
    x, y = _batch(small)
    nw, cw = _weights(small)
    model = _model()
    loss = pt.latitude_weighted_mse(model(x), y, nw, cw)
    loss.backward()
    params = dict(model.named_parameters())
    ng = x.num_real_nodes["grid"]
    rl, rg = ref.loss_and_grads(params, _ref_graph(x), y[:ng], nw, cw,
                                LAYERS)
    assert float(loss) == pytest.approx(float(rl), rel=1e-5)
    assert set(rg) == set(params) and len(params) == 6 * 10 + 6 * 4 + 4
    for k, p in params.items():
        gap = float((p.grad - rg[k]).norm() / rg[k].norm().clamp(min=1e-30))
        assert gap < 1e-4, (k, gap)


def _ref_adamw(params, steps, lr, loss_fn):
    """optax.adamw (b1 0.9, b2 0.999, eps 1e-8, decay 1e-4) from the
    equations."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses = []
    for t in range(1, steps + 1):
        for q in p.values():
            q.grad = None
        lo = loss_fn(p)
        lo.backward()
        losses.append(float(lo))
        with torch.no_grad():
            for k, q in p.items():
                m[k].mul_(0.9).add_(q.grad, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(q.grad, q.grad, value=0.001)
                upd = (m[k] / (1 - 0.9 ** t)) / (
                    (v2[k] / (1 - 0.999 ** t)).sqrt() + 1e-8)
                q.sub_(lr * (upd + 1e-4 * q))
    return losses, p


def test_three_adamw_steps_against_the_reference(small):
    """Three f32 steps of ``make_train_step`` + ``pt.adamw`` against the
    reference's loss and an optax AdamW from the equations.  Tolerances:
    the losses 1e-4 relative and each parameter 1e-5 of its largest
    magnitude plus 0.1 of the rate: AdamW moves each weight by about the
    rate whatever the gradient's size, so a gradient within rounding of 0
    may step either way."""
    x, y = _batch(small)
    nw, cw = _weights(small)
    model = _model()
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    lr = 1e-3
    step = pt.make_train_step(
        model, pt.adamw(model.parameters(), lr),
        lambda p, t: pt.latitude_weighted_mse(p, t, nw, cw))
    got = [float(step(x, y)["loss"]) for _ in range(3)]
    ng, graph = x.num_real_nodes["grid"], _ref_graph(x)
    want, p = _ref_adamw(params0, 3, lr, lambda q: ref.loss(
        ref.forward(q, graph, LAYERS), y[:ng], nw, cw))
    assert got == pytest.approx(want, rel=1e-4)
    for k, q in model.named_parameters():
        tol = 1e-5 * float(p[k].abs().max()) + 0.1 * lr
        assert float((q - p[k]).abs().max()) <= tol, k


def test_typed_graph_walks_like_a_graphs_tuple(small):
    x, _ = _batch(small)
    flat = tensors(x)
    assert len(flat) == 2 + 3 * 3
    copy = map_tensors(lambda t: t.clone(), x)
    assert isinstance(copy, pt.TypedGraph)
    assert isinstance(copy.edges["m2g"], pt.EdgeSet)
    assert copy.edges["m2g"].num_real == x.edges["m2g"].num_real
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(tensors(copy), flat))
    assert structure(copy) == structure(x)
    x2, _ = _batch(small, samples=3)
    assert structure(x2) != structure(x)


def test_captured_step_equals_eager(small):
    """``capture_step`` over the typed graph: on the CPU it runs the step
    eagerly, so losses and parameters equal the eager step's to the bit
    (the card's replay is held to the eager step in the card tests)."""
    x, y = _batch(small)
    nw, cw = _weights(small)
    loss = lambda p, t: pt.latitude_weighted_mse(p, t, nw, cw)
    runs = []
    for wrap in (lambda s: s, pt.capture_step):
        model = _model(1)
        step = wrap(pt.make_train_step(model, pt.adamw(model.parameters(),
                                                       1e-3), loss,
                                       compute_dtype=torch.bfloat16))
        runs.append(([float(step(x, y)["loss"]) for _ in range(3)],
                     [p.detach().clone() for p in model.parameters()]))
    (la, pa), (lb, pb) = runs
    assert la == lb
    assert all(torch.equal(u, v) for u, v in zip(pa, pb))


def _pb_reference():
    """``portbench/reference/graphcast.py`` loaded as a package of its own
    (its relative imports need the package)."""
    name = "portbench_reference_for_tests"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "portbench" / "reference" / "__init__.py",
            submodule_search_locations=[str(ROOT / "portbench"
                                            / "reference")])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(name + ".graphcast")


def test_benchmark_reference_equals_this_one(small):
    """The benchmark's copy (checkpointed processor, on
    ``reference/training.py``) gives this reference's prediction, loss and
    gradients in f32, and its planted fault keeps the first half of the
    samples."""
    pb = _pb_reference()
    x, y = _batch(small)
    nw, cw = _weights(small)
    ng = x.num_real_nodes["grid"]
    graph = _ref_graph(x)
    batch = pb.Batch(nodes=graph["nodes"], edges=graph["edges"],
                     node_weights=nw, channel_weights=cw, samples=B,
                     grid_nodes=ng // B)
    params = {k: v.detach() for k, v in _model().named_parameters()}
    p1 = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    p2 = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    model = {"gnn_msg_steps": LAYERS}
    a = pb.forward(p1, batch, model)
    b = ref.forward(p2, graph, LAYERS)
    assert torch.allclose(a, b, rtol=0, atol=1e-6)
    la = pb.per_row(a, y[:ng], batch).mean()
    lb = ref.loss(b, y[:ng], nw, cw)
    assert float(la) == pytest.approx(float(lb), rel=1e-6)
    la.backward()
    lb.backward()
    for k in params:
        assert torch.allclose(p1[k].grad, p2[k].grad, rtol=1e-5,
                              atol=1e-7), k
    keep = pb.half_batch(batch)
    assert int(keep.sum()) == ng // 2 and bool(keep[:ng // 2].all())


STAGE_ORDER = ["forward", "encoder", "processor", "decoder", "backward",
               "decoder_bwd", "processor_bwd", "encoder_bwd", "optimizer",
               "metrics", "end"]


def test_stage_markers_in_order(small, monkeypatch):
    """With the tracing switch on, a step's markers on a recording stub:
    the step's phases with GraphCast's stages inside the forward and the
    backward, each backward stage after the one that follows it in the
    forward; with the switch off, the same stub sees the phases only
    where the switch lets them through (none)."""
    seen = []
    monkeypatch.setattr(profiling.PhaseMarkers, "__call__",
                        lambda self, phase: seen.append(phase)
                        if pt.tracing() else None)
    x, y = _batch(small)
    nw, cw = _weights(small)
    was = pt.tracing()
    try:
        for on in (True, False):
            pt.enable_tracing(on)
            seen.clear()
            model = _model()
            step = pt.make_train_step(
                model, pt.adamw(model.parameters(), 1e-3),
                lambda p, t: pt.latitude_weighted_mse(p, t, nw, cw))
            step(x, y)
            assert seen == (STAGE_ORDER if on else [])
    finally:
        pt.enable_tracing(was)
    assert set(STAGE_ORDER) - set(profiling.PHASES) == set(profiling.STAGES)


def test_stage_marker_kernels_are_declared():
    import re
    src = (ROOT / "graphnets_tpu_torch" / "csrc" / "stage_marker.cu"
           ).read_text()
    assert re.findall(r"__global__ void (gn_phase_\w+)\(\)", src) == [
        "gn_phase_" + s for s in profiling.STAGES]
    for i, s in enumerate(profiling.STAGES):
        assert f"case {i}: gn_phase_{s}<<<" in src


def _graphs_tuple_step():
    """One sort-style ``GraphsTuple`` step; returns its outputs, the
    batch and the model before the step."""
    import copy
    adj = [np.triu(np.ones((n, n), np.int64), 1) for n in (3, 4)]
    nf = [np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
          for n in (3, 4)]
    x = pt.batch({"graphs": adj, "nf": nf, "ef": None, "gf": None},
                 pad=pt.PadSpec.bucketed(7, 6, 2), device="cpu")
    gen = torch.Generator().manual_seed(0)
    y = x.with_features(
        nf=torch.softmax(torch.randn(x.nf.shape[0], 2, generator=gen), -1),
        ef=torch.softmax(torch.randn(x.senders.shape[0], 2, generator=gen),
                         -1))
    model = pt.EncodeProcessDecode(x_dims=(0, 4, 0), core_dims=(8, 8, 8),
                                   y_dims=(2, 2, 0), n_cores=1,
                                   device="cpu")
    before = copy.deepcopy(model)
    step = pt.make_train_step(model, pt.adamw(model.parameters(), 1e-3))
    return step(x, y), x, y, before


def test_step_metrics_follow_the_prediction(small):
    """A ``GraphsTuple`` prediction: the loss and the three accuracies of
    the model's prediction before the update, as the step always gave
    them.  GraphCast's grid tensor: the loss alone."""
    out, x, y, before = _graphs_tuple_step()
    assert list(out) == ["loss", "node_acc", "edge_acc", "graph_acc"]
    pred = before(x, training=True)
    want = {"loss": pt.graph_loss_nf_ef(pred, y),
            "node_acc": pt.masked_accuracy(pred.nf, y.nf, x.node_mask),
            "edge_acc": pt.masked_accuracy(pred.ef, y.ef, x.edge_mask),
            "graph_acc": pt.graph_accuracy(pred, y)}
    for k, v in want.items():
        assert torch.equal(out[k], v.detach()), k
    gx, gy = _batch(small)
    nw, cw = _weights(small)
    model = _model()
    step = pt.make_train_step(
        model, pt.adamw(model.parameters(), 1e-3),
        lambda p, t: pt.latitude_weighted_mse(p, t, nw, cw))
    assert list(step(gx, gy)) == ["loss"]


def test_latitude_weighted_mse_by_hand():
    pred = torch.tensor([[1.0, 2.0], [0.0, 1.0], [5.0, 5.0]])
    target = torch.tensor([[0.0, 0.0], [0.0, 3.0], [9.0, 9.0]])
    a, w = torch.tensor([2.0, 0.5]), torch.tensor([1.0, 0.25])
    # Row 3 is padding (beyond len(a)).
    want = (2.0 * (1 + 0.25 * 4) + 0.5 * (0 + 0.25 * 4)) / 2
    assert float(pt.latitude_weighted_mse(pred, target, a, w)) == \
        pytest.approx(want)
    assert float(pt.latitude_weighted_mse(pred.bfloat16(), target, a, w)) \
        == pytest.approx(want)


@pytest.mark.cuda
def test_on_the_card():
    """On the card at a size the kernels' gates take (a 5 degree grid, the
    mesh to level 3, width 128, 2 samples): f32 through the kernels
    against the reference (loss 1e-5, gradients 1e-4 of their norm, as on
    the CPU), the bf16 step's kernel route against the plain route (the
    loss 1e-3 relative; each leaf's gradient 2e-2 of its norm, a few of
    bf16's 2^-8 steps accumulated over the layers, where a wrong gather or
    sum moves a leaf's gradient by its own size; the kernel route takes the
    split first edge layer's kernels once a network, forward and backward),
    three captured bf16 steps against three eager ones (to the bit: the
    same kernels in the same order), and a traced replay's markers in
    order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels, CUDA graphs and "
                    "device markers exist only on the card)")
    import json
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from graphnets_tpu_torch.ops.kernels import split_edge_layer as sel
    from graphnets_tpu_torch.utils.config import enable_kernels
    dev = torch.device("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    g = pt.build_graphcast_graph(resolution=5.0, mesh_size=3)
    ci, co, d = 20, 7, 128
    tg = pt.batch_samples(g, B, device=dev)
    ng = tg.num_real_nodes["grid"]
    gen = torch.Generator(device=dev).manual_seed(3)
    grid = torch.zeros(tg.num_nodes("grid"), ci, device=dev)
    grid[:ng, :ci - 3] = torch.randn(ng, ci - 3, generator=gen, device=dev)
    grid[:ng, ci - 3:] = tg.nodes["grid"][:ng]
    x = tg.with_nodes(grid=grid)
    y = torch.zeros(tg.num_nodes("grid"), co, device=dev)
    y[:ng] = torch.randn(ng, co, generator=gen, device=dev)
    nw = torch.from_numpy(np.tile(g.latitude_weights, B)).to(dev)
    cw = torch.linspace(0.1, 2.0, co, device=dev)

    def loss_fn(p, t):
        return pt.latitude_weighted_mse(p, t, nw, cw)

    def model():
        return pt.GraphCast(grid_in=ci, grid_out=co, latent=d, hidden=d,
                            n_layers=LAYERS, device=dev,
                            generator=torch.Generator().manual_seed(0))

    def step(m, captured=False):
        s = pt.make_train_step(m, pt.adamw(m.parameters(), 1e-3), loss_fn,
                               compute_dtype=torch.bfloat16)
        return pt.capture_step(s) if captured else s

    def flat(m):
        return torch.cat([p.detach().flatten() for p in m.parameters()])
    was = pt.tracing()
    try:
        m = model()
        lo = loss_fn(m(x), y)
        lo.backward()
        params = dict(m.named_parameters())
        rl, rg = ref.loss_and_grads(params, _ref_graph(x), y[:ng], nw, cw,
                                    LAYERS)
        assert float(lo.detach()) == pytest.approx(float(rl), rel=1e-5)
        for k, p in params.items():
            assert float((p.grad - rg[k]).norm() / rg[k].norm()) < 1e-4, k
        routes = []
        for kernels in (True, False):
            enable_kernels(kernels)
            m = model()
            before = (sel.LAUNCHES, sel.LAUNCHES_BWD)
            lo = float(step(m)(x, y)["loss"])
            # One split first edge layer a network, forward and backward.
            nets = (LAYERS + 2) * kernels
            assert (sel.LAUNCHES, sel.LAUNCHES_BWD) == (before[0] + nets,
                                                        before[1] + nets)
            routes.append((lo, {k: p.grad.clone()
                                for k, p in m.named_parameters()}))
        enable_kernels(None)
        assert routes[0][0] == pytest.approx(routes[1][0], rel=1e-3)
        gaps = {k: float((g - routes[1][1][k]).norm()
                         / routes[1][1][k].norm())
                for k, g in routes[0][1].items()}
        assert max(gaps.values()) < 2e-2, gaps
        runs = []
        for captured in (False, True):
            m = model()
            s = step(m, captured)
            runs.append(([float(s(x, y)["loss"]) for _ in range(3)],
                         flat(m)))
        assert runs[0][0] == runs[1][0]
        assert torch.equal(runs[0][1], runs[1][1])
        pt.enable_tracing(True)
        s = step(model(), True)
        s(x, y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s(x, y)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        marks = sorted((e["ts"], e["name"].split("(")[0]) for e in events
                       if e.get("cat") == "kernel"
                       and e.get("name", "").startswith("gn_phase_"))
        assert [n for _, n in marks] == ["gn_phase_" + p
                                         for p in STAGE_ORDER]
    finally:
        pt.enable_tracing(was)
        enable_kernels(None)
        torch.backends.cuda.matmul.allow_tf32 = tf32
