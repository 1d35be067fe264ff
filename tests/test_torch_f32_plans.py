"""The host-side plans of the f32 LN->matmul backward and the f32
single-graph edge update, whose kernels only the card runs.

``f32_backward_plan`` sizes the backward's two passes and
``f32_backward_scratch`` the scratch the wrapper hands the C entry
``gn_ln_linear_backward_f32_tiles``; ``g1_f32_plan`` the edge update's
tiles and the partial rows of its edge->node sum.  These tests hold the
plans to the C entries' preconditions (written beside them in
``csrc/ln_linear_bwd.cu`` and ``csrc/edge_update_g1.cu``) on an H100's 132
SMs, at the shapes the driven paths give the kernels (the sort task's
T = 512, the large graph's 65,536 and 1,048,576) and at ragged ones.
"""

import math

import pytest

from graphnets_tpu_torch.ops.kernels import edge_update_g1 as g1
from graphnets_tpu_torch.ops.kernels import ln_linear as ll

SMS = 132
ROWS = [8, 408, 512, 65536, 1048576]


@pytest.mark.parametrize("T", ROWS)
@pytest.mark.parametrize("d,dout", [(128, 128), (256, 256), (384, 384),
                                    (512, 512), (256, 384), (384, 128)])
def test_f32_backward_plan(d, dout, T):
    """Every row lies in exactly one row tile and one dW range; the ranges
    are whole row tiles and none is empty; the row tile is the one the C
    entry takes at that width (16 rows only where the large one leaves
    SMs without a tile); the dW pass fills whole waves of two blocks an SM
    where T has the tiles for it, else at most one wave; the scratch
    shapes are the C entry's."""
    plan = ll.f32_backward_plan(T, d, dout, SMS)
    big = 128 if d == 128 else 64
    assert plan.tile_rows in (16, big)
    assert (plan.tile_rows == big) == (T > big * (SMS - 1))
    assert plan.row_tiles == -(-T // plan.tile_rows)
    assert (plan.row_tiles - 1) * plan.tile_rows < T
    assert plan.row_tiles * plan.tile_rows >= T
    assert plan.tiles == (d // 128) * (dout // 128)
    assert 1 <= plan.splits <= plan.row_tiles
    ranges = ll.f32_split_rows(plan, T)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == T
    for (k0, k1), (n0, _) in zip(ranges, ranges[1:] + [(T, T)]):
        assert k0 < k1 and k1 == n0 and k0 % plan.tile_rows == 0
    wave = 2 * SMS
    blocks = plan.tiles * plan.splits
    whole = wave // math.gcd(plan.tiles, wave)
    if plan.row_tiles >= whole:
        assert blocks % wave == 0
    else:
        assert blocks <= wave
    small = plan.tile_rows == 16
    assert ll.f32_backward_scratch(plan, T, d, dout) == {
        "xn": (T, d), "dxn": (T, d) if small else (0,),
        "part_rows": (plan.row_tiles, 2, d),
        "part_dw": (plan.splits, d, dout),
        "part_sd": (plan.splits, 2, d), "counters": (plan.tiles,)}


@pytest.mark.parametrize("E", ROWS)
@pytest.mark.parametrize("dout", [128, 256, 384, 512])
def test_g1_f32_plan(E, dout):
    """Every edge row lies in exactly one 64-row tile, the column blocks
    cover dout exactly (256 columns where they divide it), and the
    edge->node sum's partial rows are one a tile."""
    rows, cols, tiles = g1.g1_f32_plan(E, dout)
    assert rows == 64 and cols in (128, 256) and dout % cols == 0
    assert cols == 256 or dout % 256
    assert (tiles - 1) * rows < E <= tiles * rows
