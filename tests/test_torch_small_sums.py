"""The one-pass segment sums for few rows (``segment_sum.small_plan``) and
the senders' sum where the windowed kernel's gate refuses the shape.

On the CPU the port's sums run their plain versions; the small kernel's
summation order is replayed in numpy (``segment_layouts.small_sum_order``,
which the card's tests hold the kernel to bit for bit) and the JAX
package's kernel runs in Pallas interpret mode.  Tolerances: f32 sums of
the same rows in another order, rounded once to bf16, may round the other
way: one bf16 ulp of the largest magnitude (2^-7 x max |ref|); f32 sums at
1e-5 of the largest magnitude.  The edge-order sum is JAX's
``jax.ops.segment_sum`` on rows of their own type: bit-equal.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_small_sums.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphnets_tpu.ops import scatter as jax_scatter
from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops import scatter as pt_scatter
from graphnets_tpu_torch.ops.kernels import segment_sum as pt_ss
from graphnets_tpu_torch.utils.config import enable_kernels, use_kernels
from segment_layouts import (LAYOUTS, WINDOWS, layout, small_sum_order,
                             windowed_layout)

_DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
       "f32": (torch.float32, jnp.float32)}
_TOL = {"bf16": 2.0 ** -7, "f32": 1e-5}
_MAX = pt_ss._SMALL_MAX_ROWS
SHARED_LIMIT = 232448   # shared memory a block may use on the H100


@pytest.fixture
def interpret_mode():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    enable_pallas(True, interpret=True)
    yield
    enable_pallas(old[0], interpret=old[1])


@pytest.fixture
def kernels_on():
    old = use_kernels()
    enable_kernels(True)
    yield
    enable_kernels(old)


def _order_plan(rows, segments, graphs=None):
    """(tile, sub-warps) of the plan the kernel would take for these
    sizes, or of its largest tile where the plan refuses them (the order's
    properties hold at any plan)."""
    plan = pt_ss.small_plan(min(rows, _MAX), segments, 128, torch.float32,
                            graphs=graphs)
    if plan is None:
        return 16, 32
    return plan.tile, plan.subwarps


def _columns(plan, dim):
    """The columns each (slab, lane, value) of the kernel reads, as
    ``small_segment_sum_kernel`` computes them."""
    return [(y * 8 + lane) * plan.vec + e for y in range(plan.slabs)
            for lane in range(8) for e in range(plan.vec)
            if (y * 8 + lane) * plan.vec + e < dim]


@pytest.mark.parametrize("graphs", [None, 1, 4, 64])
@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("dim", [128, 256, 384, 512])
@pytest.mark.parametrize("segments", [1, 41, 64, 300, 1024, 1056])
@pytest.mark.parametrize("rows", [128, 512, 1000, 2048, 2049, 4096])
def test_small_plan_covers_every_segment_and_column_once(rows, segments,
                                                         dim, dtype, graphs):
    """A plan where the one-pass kernel wins: at most 2048 rows, at most
    two blocks an SM at 16 segments a tile, and (windowed ids over
    ``graphs`` windows) at most 512 rows a window on average.  Its tiles
    hold every segment once, its slabs every column once, at most 256
    threads and 227 KB of shared memory a block; the fewest segments a
    tile that give at most a block an SM, or 16; 32 sub-warps."""
    tdt = _DT[dtype][0]
    plan = pt_ss.small_plan(rows, segments, dim, tdt, sms=132, graphs=graphs)
    vec = 8 if dtype == "bf16" else 4
    slabs = -(-dim // (8 * vec))
    if (rows > _MAX or -(-segments // 16) * slabs > 264
            or (graphs is not None and rows > 512 * graphs)):
        assert plan is None
        return
    assert plan.vec == vec and plan.slabs == slabs
    assert plan.tile in (4, 8, 16)
    assert (plan.tiles - 1) * plan.tile < segments <= plan.tiles * plan.tile
    assert sorted(_columns(plan, dim)) == list(range(dim))
    assert plan.subwarps == 32
    assert 8 * plan.subwarps <= 256   # the kernel's launch bounds
    assert plan.shared_bytes == (plan.subwarps * plan.tile * 8 * plan.vec
                                 * 4) <= SHARED_LIMIT
    assert plan.tiles * plan.slabs <= 132 or plan.tile == 16
    if plan.tile > 4:
        assert -(-segments // (plan.tile // 2)) * plan.slabs > 132


@pytest.mark.parametrize("shape,graphs,small", [
    ((512, 64, 384, torch.bfloat16), None, True),   # S bf16 uniform
    ((512, 64, 384, torch.bfloat16), 4, True),
    ((512, 64, 384, torch.float32), 4, True),       # S, f32 cotangents
    ((512, 41, 384, torch.float32), 5, True),       # A
    ((_MAX, 128, 384, torch.bfloat16), None, True),  # the crossover
    ((_MAX + 128, 128, 384, torch.bfloat16), None, False),
    ((_MAX, 128, 384, torch.float32), 4, True),
    ((_MAX, 128, 384, torch.float32), 2, False),    # windows of 1024 rows
    ((_MAX, 2048, 384, torch.bfloat16), None, False),  # 768 blocks
    ((16384, 1024, 384, torch.bfloat16), None, False),  # the headline
    ((16384, 1024, 384, torch.bfloat16), 8, False),
    ((16384, 1056, 384, torch.float32), 9, False),  # B
    ((16384, 1024, 384, torch.float32), None, False),  # F(a)
    ((1 << 20, 65536, 256, torch.bfloat16), None, False),  # C
    ((56320, 56960, 256, torch.bfloat16), None, False),  # D
])
def test_small_plan_threshold_cases(shape, graphs, small):
    """The sort task's sums take the one-pass kernel; the headline, B, C,
    D and F(a) sums keep the kernels they had."""
    assert (pt_ss.small_plan(*shape, graphs=graphs) is not None) == small


@pytest.mark.parametrize("dim", [4, 12, 10, 1, 64])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_small_plan_edge_order_takes_any_shape(dim, dtype):
    """The edge-order sum: one sub-warp a block, at any row count; odd
    widths one value a thread."""
    tdt = _DT[dtype][0]
    plan = pt_ss.small_plan(1 << 20, 41, dim, tdt, edge_order=True)
    assert plan.subwarps == 1
    assert plan.vec == (8 if dtype == "bf16" and dim % 8 == 0
                        else 4 if dim % 4 == 0 else 1)
    assert sorted(_columns(plan, dim)) == list(range(dim))
    assert pt_ss.small_plan(512, 41, 10, tdt) is None  # d % 4 != 0


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_small_sum_order_adds_every_row_once_sorted(name):
    """The kernel's order on every sorted layout: each row with an id in
    [0, S) is added once, no row with a negative id (rows with ids past S
    in the last tile go to partial rows that are never written); f32 sums
    within 1e-5 of the largest magnitude of the plain sum.  (Layouts past
    the crossover run at the plan of the crossover's row count, or at 16
    segments a tile.)"""
    ids, S = layout(name)
    D = 16
    x = np.random.default_rng(3).normal(size=(ids.size, D)).astype(
        np.float32)
    got, hits = small_sum_order(x, ids, S, *_order_plan(ids.size, S))
    valid = (ids >= 0) & (ids < S)
    assert (hits[valid] == 1).all() and not hits[ids < 0].any()
    ref = pt_ss.sorted_segment_sum_plain(torch.from_numpy(x),
                                         torch.from_numpy(ids), S).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_small_sum_order_adds_every_row_once_windowed(name):
    """The windowed order: each row is added once, by the tile of its
    sender, from its graph's window (a tile may span graphs)."""
    snd, _, no, eo = windowed_layout(name)
    S, D = int(no[-1]), 8
    x = np.random.default_rng(4).normal(size=(snd.size, D)).astype(
        np.float32)
    got, hits = small_sum_order(x, snd, S,
                                *_order_plan(snd.size, S, len(no) - 1),
                                (no, eo))
    assert (hits == 1).all()
    ref = pt_ss.windowed_segment_sum_plain(
        torch.from_numpy(x), torch.from_numpy(snd), S, None, None).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1e-30)


# The sort task's sums: A (the padded batch, 41 segments, 5 windows) and
# S (the uniform device layout, 64 segments, 4 windows); E = 512, d = 384.
_SORT = {"A": "sort_pad_node", "S": "sort_uniform"}


@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("ids", ["senders", "receivers"])
@pytest.mark.parametrize("cell", sorted(_SORT))
def test_small_sums_match_pallas_at_sort_shapes(interpret_mode, cell, ids,
                                                dtype):
    """The port's sums and the one-pass kernel's order, rounded once,
    against the JAX package's Pallas kernel (the windowed kernel for the
    senders, the sorted one for the receivers) at the sort shapes."""
    from graphnets_tpu.ops.pallas.segment_sum import (
        sorted_segment_sum, supports_sorted_segment_sum,
        windowed_segment_sum)
    tdt, jdt = _DT[dtype]
    snd, rcv, no, eo = windowed_layout(_SORT[cell])
    S, E, D = int(no[-1]), snd.size, 384
    assert (E, S, len(no) - 1) == ((512, 41, 5) if cell == "A"
                                   else (512, 64, 4))
    assert supports_sorted_segment_sum(E, S, D)
    x = np.random.default_rng(7).normal(size=(E, D)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(x).to(tdt)
    if ids == "senders":
        ref = windowed_segment_sum(xj, jnp.asarray(snd), S, jnp.asarray(no),
                                   jnp.asarray(eo))
        out = pt_ss.windowed_segment_sum(xt, torch.from_numpy(snd), S,
                                         torch.from_numpy(no),
                                         torch.from_numpy(eo))
        seg, windows = snd, (no, eo)
    else:
        ref = sorted_segment_sum(xj, jnp.asarray(rcv), S)
        out = pt_ss.sorted_segment_sum(xt, torch.from_numpy(rcv), S)
        seg, windows = rcv, None
    ref = np.asarray(ref, np.float32)
    plan = pt_ss.small_plan(E, S, D, tdt, graphs=None if windows is None
                            else len(no) - 1)
    order, _ = small_sum_order(xt.float().numpy(), seg, S, plan.tile,
                               plan.subwarps, windows)
    order = torch.from_numpy(order).to(tdt).float().numpy()
    lim = _TOL[dtype] * np.abs(ref).max()
    assert out.dtype == tdt and tuple(out.shape) == (S, D)
    assert np.abs(out.float().numpy() - ref).max() <= lim
    assert np.abs(order - ref).max() <= lim


@pytest.mark.parametrize("dim", [64, 10])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_windowed_fallback_rounds_as_jax(interpret_mode, kernels_on, dtype,
                                         dim):
    """Where the windowed kernel's gate refuses the shape (d % 128 != 0),
    JAX's kernel route sums the senders' cotangents with
    ``jax.ops.segment_sum`` in their own type, rows in edge order.  The
    port's bf16 gradient now does the same, bit for bit; the f32 sum it
    took before lies more than one bf16 ulp away at the sort task's padded
    shape (E = 512, N = 41, a pad node sending 297 rows).  f32 cotangents
    keep the port's f32 sum: JAX's in another order, within 1e-5."""
    tdt, jdt = _DT[dtype]
    snd, _, no, eo = windowed_layout("sort_pad_node")
    N, E = int(no[-1]), snd.size
    assert (E, N) == (512, 41)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, dim)).astype(np.float32)
    g = rng.normal(size=(E, dim)).astype(np.float32)
    ids, wins = jnp.asarray(snd), (jnp.asarray(no), jnp.asarray(eo))
    f = lambda xx: jnp.sum(jax_scatter.take_rows_sorted_grad(
        xx, ids, windows=wins).astype(jnp.float32) * jnp.asarray(g))
    want = np.asarray(jax.grad(f)(jnp.asarray(x, jdt)), np.float32)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = pt_scatter.take_rows_sorted_grad(
        xt, torch.from_numpy(snd),
        windows=(torch.from_numpy(no), torch.from_numpy(eo)))
    (y.float() * torch.from_numpy(g)).sum().backward()
    got = xt.grad.float().numpy()
    assert xt.grad.dtype == tdt
    if dtype == "f32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        return
    assert np.array_equal(got, want)
    # The sum the port took before: f32, rounded once.
    before = pt_scatter.segment_sum(torch.from_numpy(g).to(tdt),
                                    torch.from_numpy(snd), N)
    assert (np.abs(before.float().numpy() - want).max()
            > 2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("dim", [384, 64, 3])
@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("name", ["sort_pad_node", "empty_graphs", "sort"])
def test_edge_order_sum_plain_is_xla_segment_sum(name, dtype, dim):
    """``edge_order_segment_sum_plain`` is ``jax.ops.segment_sum`` on rows
    of their own type, bit for bit, ids outside [0, N) dropped."""
    tdt, jdt = _DT[dtype]
    snd, _, no, _ = windowed_layout(name)
    N = int(no[-1])
    seg = snd.copy()
    seg[::17] = -1
    seg[5::23] = N
    x = np.random.default_rng(12).normal(size=(seg.size, dim)).astype(
        np.float32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x, jdt),
                                          jnp.asarray(seg), num_segments=N),
                      np.float32)
    got = pt_ss.edge_order_segment_sum(torch.from_numpy(x).to(tdt),
                                       torch.from_numpy(seg), N)
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(), want)
