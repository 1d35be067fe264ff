"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: ``h`` and the FFN output are bf16, held to one and two bf16
ulps at the largest magnitude (the kernels' f32 sums run in another order,
so a value near a rounding boundary may round the other way); ``agg`` is
held to 1e-4 against an f32 sum of the kernel's own ``h``.  The segment
sums: one bf16 ulp of the largest magnitude, f32 at rtol 1e-5; the gather
is bit-equal; the LN backward: dx at 2^-6 and dW, dscale, dbias at 1e-3 of
the largest magnitude, two launches of its bf16 tensor-core passes
bit-equal, as two launches of the bf16 FFN forward are; the edge update's gradients at 5e-2 of each
tensor's largest magnitude (bf16 cotangents).  ``ln_matmul``: the f32
partial at 1e-3 and the completed bf16 row at one bf16 ulp of the largest
magnitude (the normalised row may round the other way after a differently
ordered f32 sum); with f32 rows, forward and backward at 1e-4 (f32 sums in
another order).  ``sorted_gather_add`` is one f32 add of the same two
values and one rounding: bit-equal.  The single-graph edge update: ``h``
one bf16 ulp (f32: 1e-5), ``agg`` 1e-5 against an f32 sum of the kernel's
own ``h``, gradients 5e-2 (f32: 1e-4).  The fused FFN forward on f32
rows: 1e-5 (f32 sums in another order), two launches bit-equal at the
row counts around its row tile.  The fused FFN backward: dx 2^-6
(f32: 1e-4), the parameter gradients 1e-2 (a relu mask may flip where the
f32 pre-activation is within rounding of 0, on f32 rows too; at d = 384
and 512 by the 2-norm, where one flip at T = 8192 moves a tail element by
2%), two launches bit-equal.  The windowed sum: two launches bit-equal.  ``random_gather``
is a copy: bit-equal.  The two wgmma edge updates at the headline, padded
and wide uniform layouts and at scaled-down large-graph and
sampled-subgraph shapes (ragged edge counts through the launcher): the
tolerances above, both outputs bit-equal on a second launch and when ``h``
is written over a dead ``src``.  The sorted sum on the layouts of
``tests/segment_layouts.py``: one bf16 ulp (f32: 1e-5), two launches and
two replays of a CUDA graph bit-equal.  ``ln_matmul`` on its ``wgmma``
core: its tolerances above, two launches bit-equal.  The f32 LN backward's
register-blocked passes at every width they serve, around their row tiles:
every output at 1e-4 (f32 sums in another order), two launches bit-equal;
the f32 single-graph update around its 64-row tile, both column blocks,
with and without the LN: ``h`` and ``agg`` at 1e-5, bit-equal on a second
launch and over a dead ``src``.
"""

import numpy as np
import pytest
import torch

from graphnets_tpu_torch.ops import ln_linear as lnp
from graphnets_tpu_torch.ops.kernels import edge_update as eu
from graphnets_tpu_torch.ops.kernels import edge_update_g1 as g1
from graphnets_tpu_torch.ops.kernels import fused_ffn as ffn
from graphnets_tpu_torch.ops.kernels import gather as ga
from graphnets_tpu_torch.ops.kernels import ln_linear as ll
from graphnets_tpu_torch.ops.kernels import random_gather as rg
from graphnets_tpu_torch.ops.kernels import segment_sum as ss
from segment_layouts import (LAYOUTS, WINDOWS, layout, small_sum_order,
                             windowed_layout)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _uniform_ids(rng, G, n_slots, e_slots, padded):
    snd, rcv = [], []
    for b in range(G):
        n_real = n_slots - 1 if padded else n_slots
        e_real = e_slots - 37 if padded else e_slots
        s = rng.integers(0, n_real, e_slots) + b * n_slots
        r = np.sort(rng.integers(0, n_real, e_slots)) + b * n_slots
        s[e_real:] = r[e_real:] = (b + 1) * n_slots - 1
        snd.append(s)
        rcv.append(r)
    to = lambda x: torch.from_numpy(np.concatenate(x).astype(np.int32))
    return to(snd), to(rcv)


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("use_ln", [True, False])
def test_edge_update_agg_matches_plain(cuda, padded, use_ln):
    G, n_slots, e_slots, d = 4, 32, 256, 128
    rng = np.random.default_rng(8)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    snd, rcv = _uniform_ids(rng, G, n_slots, e_slots, padded)
    ef, w0 = f(G * e_slots, d).bfloat16(), (f(d, d) * 0.05).bfloat16()
    ts, tr, tg, b = f(G * n_slots, d), f(G * n_slots, d), f(G, d), f(d)
    ln = {"scale": f(d), "bias": f(d)} if use_ln else None
    args = (ef, ln, w0, ts, tr, tg, b, snd, rcv, n_slots, e_slots)
    h_p, _ = eu.fused_edge_update_agg(*args)  # CPU: the plain version
    on = lambda t: t.to(cuda) if isinstance(t, torch.Tensor) else t
    before = eu.LAUNCHES
    h_k, agg_k = eu.fused_edge_update_agg(
        *[({k: on(v) for k, v in a.items()} if isinstance(a, dict) else on(a))
          for a in args])
    torch.cuda.synchronize()
    assert eu.LAUNCHES == before + 1
    tol = 2.0 ** -7 * float(h_p.float().abs().max())
    assert float((h_k.float().cpu() - h_p.float()).abs().max()) <= tol
    own = torch.zeros_like(agg_k).index_add_(0, rcv.to(cuda), h_k.float())
    assert torch.allclose(agg_k, own, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 1000, 4096])
@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16),
                                     (384, torch.bfloat16),
                                     (512, torch.bfloat16),
                                     (128, torch.float32),
                                     (384, torch.float32),
                                     (512, torch.float32)])
def test_ln_ffn_residual_matches_plain(cuda, rows, d, dtype):
    rng = np.random.default_rng(9)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    args = [f(rows, d).to(dtype), f(d), f(d),
            (f(d, 4 * d) * 0.05).to(dtype), f(4 * d).to(dtype),
            (f(4 * d, d) * 0.05).to(dtype), f(d).to(dtype)]
    extra = f(rows, d).to(dtype)
    ref = ffn.ln_ffn_residual(*args, extra=extra)  # CPU: the plain version
    before = ffn.LAUNCHES
    out = ffn.ln_ffn_residual(*[t.to(cuda) for t in args],
                              extra=extra.to(cuda))
    torch.cuda.synchronize()
    assert ffn.LAUNCHES == before + 1 and out.dtype == dtype
    tol = (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * float(
        ref.float().abs().max())
    assert float((out.float().cpu() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["8", "ragged", "split_lo", "split_hi"])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_ln_ffn_residual_tensor_core_tiles(cuda, d, case):
    """The bf16 ``wgmma`` kernel at every width of the gate: 8 rows, rows
    not in whole row tiles, and the last row count whose tiles split the
    hidden dimension beside the first that does not; rows with var == 0
    (zeros, and a constant); two launches bit-equal."""
    rows = ffn._lib().gn_ln_ffn_residual_rows(d)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    edge = (sms // 2) * rows  # more row tiles than sms / 2: no split
    T = {"8": 8, "ragged": 1000, "split_lo": edge,
         "split_hi": edge + 8}[case]
    assert (ffn._splits(T, rows, cuda) > 1) == (case != "split_hi")
    rng = np.random.default_rng(22)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:2], x[2] = 0.0, 1.5
    args = [t.to(cuda) for t in (
        x.bfloat16(), 1 + 0.1 * f(d), 0.1 * f(d),
        (f(d, 4 * d) * d ** -0.5).bfloat16(), (0.1 * f(4 * d)).bfloat16(),
        (f(4 * d, d) * (4 * d) ** -0.5).bfloat16(), (0.1 * f(d)).bfloat16())]
    extra = f(T, d).bfloat16().to(cuda)
    ref = ffn.ln_ffn_residual_plain(*args, extra=extra)
    before = ffn.LAUNCHES
    out = ffn.ln_ffn_residual(*args, extra=extra)
    again = ffn.ln_ffn_residual(*args, extra=extra)
    torch.cuda.synchronize()
    assert ffn.LAUNCHES == before + 2
    assert torch.equal(out, again)
    _close_max(out, ref, 2.0 ** -6)


def _f32_tile_rows(rows, case):
    """Row counts around an f32 kernel's row tile of ``rows``: 8, one tile
    less and more 8 rows, three tiles and 24 rows."""
    return {"8": 8, "tile_lo": rows - 8, "tile_hi": rows + 8,
            "three": 3 * rows + 24}[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["8", "tile_lo", "tile_hi", "three"])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_ln_ffn_residual_f32_tiles(cuda, d, case):
    """The register-blocked f32 kernel at every width of the gate, at row
    counts around its row tile (each with the split over the hidden
    dimension that ``_splits_f32`` picks for it), rows with var == 0
    (zeros, and a constant): 1e-5 of the largest magnitude against the
    plain version, two launches bit-equal."""
    lib = ffn._lib()
    T = _f32_tile_rows(lib.gn_ln_ffn_residual_f32_rows(d), case)
    rng = np.random.default_rng(23)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:2], x[2] = 0.0, 1.5
    args = [t.to(cuda) for t in (
        x, 1 + 0.1 * f(d), 0.1 * f(d), f(d, 4 * d) * d ** -0.5,
        0.1 * f(4 * d), f(4 * d, d) * (4 * d) ** -0.5, 0.1 * f(d))]
    extra = f(T, d).to(cuda)
    ref = ffn.ln_ffn_residual_plain(*args, extra=extra)
    before = ffn.LAUNCHES
    out = ffn.ln_ffn_residual(*args, extra=extra)
    again = ffn.ln_ffn_residual(*args, extra=extra)
    torch.cuda.synchronize()
    assert ffn.LAUNCHES == before + 2
    assert torch.equal(out, again)
    _close_max(out, ref, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["8", "tile_lo", "tile_hi", "three"])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_ln_ffn_backward_f32_tiles(cuda, d, case):
    """The register-blocked f32 backward at every width of the gate, at
    row counts around its 128-row tile: dx within 1e-4 and the parameter
    gradients within 1e-2 of their largest magnitude against the plain
    version, two launches bit-equal."""
    T = _f32_tile_rows(ffn._bwd_lib().gn_ln_ffn_backward_tile_rows(1), case)
    out, ref = _ffn_backward_case(cuda, torch.float32, d, T)
    for o, r, tol in zip(out, ref, (1e-4,) + (1e-2,) * 6):
        _close_max(o, r, tol)


def _f32_backward_rows(d, dout, case):
    """Row counts around the f32 LN backward's tiles (``f32_backward_plan``
    on this card): 8 rows, three 16-row tiles and 8 rows, and its large
    tile on every SM and one ragged more (the dW pass's ranges then fill
    whole waves, unevenly)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = ll.f32_backward_plan(1 << 22, d, dout, sms).tile_rows
    return {"8": 8, "small": 3 * 16 + 8, "large": big * sms + 24}[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["8", "small", "large"])
@pytest.mark.parametrize("d,dout", [(128, 128), (256, 256), (384, 384),
                                    (512, 512), (256, 384)])
def test_ln_linear_backward_f32_tiles(cuda, d, dout, case):
    """The register-blocked f32 passes at every width they are built for
    (and d != dout), at row counts around their row tiles and the dW
    pass's ranges, rows with var == 0 (zeros, and a constant): dx,
    dscale, dbias and dW within 1e-4 of their largest magnitudes against
    the plain version, one launch a call, two launches bit-equal."""
    T = _f32_backward_rows(d, dout, case)
    rng = np.random.default_rng(27)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:2], x[2] = 0.0, 1.5
    args = [t.to(cuda) for t in (x, 1 + 0.1 * f(d), 0.1 * f(d),
                                 f(d, dout) * d ** -0.5, f(T, dout))]
    assert ll._one_step_rows(d, dout, torch.float32)
    ref = lnp.ln_linear_backward_plain(*args)
    before = ll.LAUNCHES
    out = ll.ln_linear_backward(*args)
    again = ll.ln_linear_backward(*args)
    torch.cuda.synchronize()
    assert ll.LAUNCHES == before + 2
    for o, a in zip(out, again):
        assert torch.equal(o, a)
    assert out[0].dtype == torch.float32
    for o, r in zip(out, ref):
        _close_max(o, r, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("E,N,dout", [(56, 32, 256), (72, 40, 128),
                                      (216, 64, 256), (4104, 512, 256),
                                      (4104, 512, 384)])
def test_g1_edge_update_f32_tiles(cuda, E, N, dout, has_ln):
    """The f32 single-graph kernel through its launcher at edge counts
    around its 64-row tile (one tile and less, one and more, three and
    more, 65 tiles) and both column blocks (256 and 128 columns), with and
    without the LN: ascending receivers with a hub across several tiles,
    empty nodes and pad edges on the last node, var == 0 rows.  ``h``
    within 1e-5 and ``agg`` within 1e-5 (of the f32 sum of its own ``h``)
    of their largest magnitudes, zero rows for empty nodes, both bit-equal
    on a second launch and when ``h`` is written over a dead ``src``."""
    de = 256
    rng = np.random.default_rng(28)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                    ).to(cuda)
    ef = f(E, de)
    ef[:3] = 0.0
    scale, bias = 1 + 0.1 * f(de), 0.1 * f(de)
    w0 = f(de, dout) * de ** -0.5
    src, tr, gb = f(E, dout), f(N, dout), f(dout)
    rl = _sorted_receivers(rng, E, N, True).to(cuda)
    if not has_ln:
        scale, bias = torch.ones_like(scale), torch.zeros_like(bias)
    assert g1._lib().gn_g1_edge_update_tile_rows(1) == \
        g1.g1_f32_plan(E, dout)[0]
    plain = g1.g1_edge_update_plain(ef, scale, bias, w0, src, tr, rl, gb,
                                    has_ln)
    run = lambda with_agg, out=None: g1._launch(
        ef, scale, bias, w0, src if out is None else out, tr, rl, gb, has_ln,
        with_agg, out=out)
    kept = src.clone()
    h, agg = run(True)
    h2, agg2 = run(True)
    h3 = run(False)
    torch.cuda.synchronize()
    assert torch.equal(src, kept)
    _close_max(h, plain, 1e-5)
    assert torch.equal(h, h2) and torch.equal(agg, agg2)
    assert torch.equal(h3, h)
    own = torch.zeros_like(agg).index_add_(0, rl.long(), h)
    _close_max(agg, own, 1e-5)
    empty = torch.bincount(rl.long(), minlength=N) == 0
    assert bool(empty.any()) and not agg[empty].any()
    dead = src.clone()
    ha, agga = run(True, out=dead)
    torch.cuda.synchronize()
    assert ha.data_ptr() == dead.data_ptr()
    assert torch.equal(ha, h) and torch.equal(agga, agg)


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """Outside the JAX gate (d = 640, rows not in whole 8-row tiles) and
    on f16 rows the FFN kernels raise on the card."""
    v = lambda *n: torch.zeros(*n, device=cuda)
    for T, d, dt in ((8, 640, torch.bfloat16), (7, 384, torch.bfloat16),
                     (8, 384, torch.float16)):
        x = v(T, d).to(dt)
        with pytest.raises(ValueError):
            ffn.ln_ffn_residual(x, v(d), v(d), v(d, 4 * d), v(4 * d),
                                v(4 * d, d), v(d))
        with pytest.raises(ValueError):
            ffn.ln_ffn_backward(x, v(d), v(d), v(d, 4 * d), v(4 * d),
                                v(4 * d, d), x)


def _close_max(out, ref, tol):
    out, ref = out.float().cpu(), ref.float().cpu()
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [128, 96])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_segment_sums_match_plain(cuda, dtype, padded, n_slots):
    """Sorted (receivers) and windowed (senders) sums; at n_slots = 96 a
    128-segment tile of the windowed kernel spans two graphs."""
    G, e_slots, d = 6, 1024, 384
    rng = np.random.default_rng(10)
    snd, rcv = _uniform_ids(rng, G, n_slots, e_slots, padded)
    x = torch.from_numpy(rng.normal(size=(G * e_slots, d)).astype(
        np.float32)).to(dtype)
    N = G * n_slots
    gi = torch.arange(G + 1, dtype=torch.int32)
    wins = (gi * n_slots, gi * e_slots)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    before = (ss.LAUNCHES, ss.WINDOWED_LAUNCHES)
    out = ss.sorted_segment_sum(x.to(cuda), rcv.to(cuda), N)
    win = ss.windowed_segment_sum(x.to(cuda), snd.to(cuda), N,
                                  *[w.to(cuda) for w in wins])
    torch.cuda.synchronize()
    assert (ss.LAUNCHES, ss.WINDOWED_LAUNCHES) == (before[0] + 1,
                                                   before[1] + 1)
    assert out.dtype == win.dtype == dtype
    _close_max(out, ss.sorted_segment_sum_plain(x, rcv, N), tol)
    _close_max(win, ss.windowed_segment_sum_plain(x, snd, N, *wins), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["wrapper", "chunked"])
@pytest.mark.parametrize("d", [384, 256, 12])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sorted_segment_sum_layouts(cuda, name, dtype, d, path):
    """The chunked kernel on every layout of ``tests/segment_layouts.py``
    (a pad node with 90% of the rows and empty segments behind it, a hub
    across chunks, empty runs, ids outside [0, S), segments ending on
    chunk edges, E = 128), through the wrapper (which takes the one-pass
    kernel where ``small_plan`` says so) and forced: one launch a call,
    two launches bit-equal (a fixed summation order, no float atomics),
    within one bf16 ulp of the largest magnitude (f32: 1e-5) of the plain
    sum; d = 12 takes the 4-value vectors of bf16 rows, d = 384 in f32 two
    column slabs."""
    ids, S = layout(name)
    x = torch.from_numpy(np.random.default_rng(25).normal(
        size=(ids.size, d)).astype(np.float32)).to(dtype)
    seg = torch.from_numpy(ids)
    args = (x.to(cuda), seg.to(cuda), S)
    launch = ss.sorted_segment_sum if path == "wrapper" else ss._launch_sorted
    before = ss.LAUNCHES
    out = launch(*args)
    assert ss.LAUNCHES == before + 1
    again = launch(*args)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 2
    assert out.dtype == dtype and torch.equal(out, again)
    _close_max(out, ss.sorted_segment_sum_plain(x, seg, S),
               2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pad_node", "hub", "headline"])
def test_sorted_segment_sum_replays_in_a_cuda_graph(cuda, name):
    """Captured once and replayed twice, the kernel gives its eager result
    bit for bit: the counters of the runs that cross chunks are back at 0
    after every launch."""
    ids, S = layout(name)
    x = torch.randn(ids.size, 256, device=cuda).to(torch.bfloat16)
    seg = torch.from_numpy(ids).to(cuda)
    ref = ss.sorted_segment_sum(x, seg, S)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.sorted_segment_sum(x, seg, S)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ss.sorted_segment_sum(x, seg, S)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def _small_plan_or_widest(E, S, d, dtype, graphs=None):
    """The one-pass kernel's plan, or its largest tile where the plan
    sends the shape to the large-row kernels (to run it there anyway)."""
    plan = ss.small_plan(E, S, d, dtype, graphs=graphs)
    if plan is None:
        base = ss.small_plan(1, 1, d, dtype, graphs=graphs)
        plan = base._replace(tile=16, tiles=-(-S // 16),
                             shared_bytes=base.shared_bytes * 16 // base.tile)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["wrapper", "large"])
@pytest.mark.parametrize("d", [384, 12])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", sorted(WINDOWS))
def test_windowed_segment_sum_layouts(cuda, layout, dtype, d, path):
    """Unsorted graph-local ids (``segment_layouts.WINDOWS``: the sort
    task's graphs, its pad node sending 297 of 512 rows, its uniform
    layout, the headline, an edgeless padding graph, empty graphs, long
    windows) against the plain sum, through the wrapper (the one-pass
    kernel where ``small_plan`` says so) and the large-row kernel forced,
    and two launches bit-equal (a fixed summation order, no float
    atomics); d = 12 takes the 4-value path of bf16 rows."""
    snd, _, no, eo = windowed_layout(layout)
    N, E = int(no[-1]), int(eo[-1])
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.normal(size=(E, d)).astype(np.float32)).to(dtype)
    ids, wins = torch.from_numpy(snd), (torch.from_numpy(no),
                                        torch.from_numpy(eo))
    before = ss.WINDOWED_LAUNCHES
    args = (x.to(cuda), ids.to(cuda), N, *[w.to(cuda) for w in wins])
    launch = (ss.windowed_segment_sum if path == "wrapper"
              else ss._launch_windowed)
    out = launch(*args)
    again = launch(*args)
    torch.cuda.synchronize()
    assert ss.WINDOWED_LAUNCHES == before + 2
    assert out.dtype == dtype and torch.equal(out, again)
    _close_max(out, ss.windowed_segment_sum_plain(x, ids, N, *wins),
               2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)


_SMALL_CASES = ([("sorted", n) for n in sorted(LAYOUTS)]
                + [("windowed", n) for n in sorted(WINDOWS)])


def _small_case(kind, name, d, dtype, seed=26):
    """Inputs of a one-pass sum: ``(x, seg, S, windows or None)`` on the
    CPU, and the plan (forced to the largest tile where ``small_plan``
    refuses the shape)."""
    if kind == "sorted":
        seg, S = layout(name)
        windows = None
    else:
        seg, _, no, eo = windowed_layout(name)
        S, windows = int(no[-1]), (no, eo)
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(seg.size, d)).astype(np.float32)).to(dtype)
    plan = _small_plan_or_widest(seg.size, S, d, dtype,
                                 None if windows is None else len(no) - 1)
    return x, seg, S, windows, plan


def _launch_small(kind, x, seg, S, windows, plan, cuda):
    args = (x.to(cuda), torch.from_numpy(seg).to(cuda), S)
    if kind == "sorted":
        return ss._launch_sorted_small(*args, plan)
    return ss._launch_windowed_small(
        *args, *[torch.from_numpy(w).to(cuda) for w in windows], plan)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 128, 12])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,name", _SMALL_CASES)
def test_small_segment_sums_match_plain_and_order(cuda, kind, name, dtype,
                                                  d):
    """The one-pass kernel on every sorted and windowed layout (empty
    segments, a pad node with most rows, ids outside [0, S), tiles that
    span graphs, an edgeless padding graph, empty graphs; those the plan
    sends to the large-row kernels at the largest tile): within one bf16
    ulp (f32: 1e-5) of the plain sum, bit-equal to its summation order
    replayed in numpy (``segment_layouts.small_sum_order``) and on a
    second launch."""
    x, seg, S, windows, plan = _small_case(kind, name, d, dtype)
    counter = "LAUNCHES" if kind == "sorted" else "WINDOWED_LAUNCHES"
    before = getattr(ss, counter)
    out = _launch_small(kind, x, seg, S, windows, plan, cuda)
    again = _launch_small(kind, x, seg, S, windows, plan, cuda)
    torch.cuda.synchronize()
    assert getattr(ss, counter) == before + 2
    assert out.dtype == dtype and torch.equal(out, again)
    order, _ = small_sum_order(x.float().numpy(), seg, S, plan.tile,
                               plan.subwarps, windows)
    assert torch.equal(out.cpu(), torch.from_numpy(order).to(dtype))
    ref = ss.sorted_segment_sum_plain(x, torch.from_numpy(seg), S)
    _close_max(out, ref, 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sorted", "windowed"])
@pytest.mark.parametrize("rows", [ss._SMALL_MAX_ROWS, ss._SMALL_MAX_ROWS
                                  + 128])
def test_small_path_threshold(cuda, monkeypatch, kind, rows):
    """Row counts on both sides of the crossover take the kernel that
    ``small_plan`` names: 16 graphs of 16 nodes and rows / 16 edges."""
    G, npg = 16, 16
    epg = rows // G
    rng = np.random.default_rng(27)
    no = np.arange(G + 1, dtype=np.int32) * npg
    eo = np.arange(G + 1, dtype=np.int32) * epg
    seg = np.concatenate([rng.integers(0, npg, epg) + b * npg
                          for b in range(G)]).astype(np.int32)
    graphs = None
    if kind == "sorted":
        seg = np.sort(seg)
    else:
        graphs = G
    S, d = G * npg, 384
    x = torch.randn(rows, d).to(torch.bfloat16)
    small = []
    real = ss._launch_small
    monkeypatch.setattr(ss, "_launch_small",
                        lambda *a, **k: small.append(1) or real(*a, **k))
    args = (x.to(cuda), torch.from_numpy(seg).to(cuda), S)
    if kind == "sorted":
        out = ss.sorted_segment_sum(*args)
    else:
        out = ss.windowed_segment_sum(
            *args, torch.from_numpy(no).to(cuda),
            torch.from_numpy(eo).to(cuda))
    torch.cuda.synchronize()
    want = ss.small_plan(rows, S, d, torch.bfloat16, graphs=graphs)
    assert bool(small) == (want is not None) == (rows <= ss._SMALL_MAX_ROWS)
    _close_max(out, ss.sorted_segment_sum_plain(x, torch.from_numpy(seg), S),
               2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,name", [("sorted", "e128"),
                                       ("windowed", "sort_pad_node"),
                                       ("windowed", "sort_uniform")])
def test_small_segment_sums_replay_in_a_cuda_graph(cuda, kind, name, dtype):
    """Captured once and replayed twice, the one-pass kernel gives its
    eager result bit for bit."""
    x, seg, S, windows, plan = _small_case(kind, name, 384, dtype)
    ref = _launch_small(kind, x, seg, S, windows, plan, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _launch_small(kind, x, seg, S, windows, plan, cuda)
    torch.cuda.current_stream().wait_stream(side)
    xs, segs = x.to(cuda), torch.from_numpy(seg).to(cuda)
    wins = None if windows is None else [torch.from_numpy(w).to(cuda)
                                         for w in windows]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        if kind == "sorted":
            out = ss._launch_sorted_small(xs, segs, S, plan)
        else:
            out = ss._launch_windowed_small(xs, segs, S, *wins, plan)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 64, 10])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_edge_order_segment_sum_matches_plain(cuda, name, dtype, d):
    """The sum of the senders' fallback (rows in edge order, every add
    rounded to the rows' type): bit-equal to its plain version, ids
    outside [0, N) dropped, at odd widths too."""
    snd, _, no, _ = windowed_layout(name)
    N = int(no[-1])
    seg = snd.copy()
    seg[::17] = -1
    seg[5::23] = N
    x = torch.from_numpy(np.random.default_rng(28).normal(
        size=(seg.size, d)).astype(np.float32)).to(dtype)
    before = ss.WINDOWED_LAUNCHES
    out = ss.edge_order_segment_sum(x.to(cuda),
                                    torch.from_numpy(seg).to(cuda), N)
    torch.cuda.synchronize()
    assert ss.WINDOWED_LAUNCHES == before + 1
    ref = ss.edge_order_segment_sum_plain(x, torch.from_numpy(seg), N)
    assert out.dtype == dtype and torch.equal(out.cpu(), ref)


@pytest.mark.cuda
def test_edge_order_segment_sum_is_linear_on_one_large_graph(cuda):
    """The senders' fallback on one graph of 262,144 edges and 16,384
    nodes (d = 64 bf16, a width the windowed gate refuses): bit-equal to
    its plain version and to a relaunch, and within 2 ms on the card.
    Each block reads only its own tile's rows; a block that walked the
    whole window would take seconds here."""
    E, N, d = 1 << 18, 1 << 14, 64
    rng = np.random.default_rng(29)
    seg = torch.from_numpy(rng.integers(0, N, E).astype(np.int32)).to(cuda)
    x = torch.from_numpy(rng.normal(size=(E, d)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    out = ss.edge_order_segment_sum(x, seg, N)
    again = ss.edge_order_segment_sum(x, seg, N)
    ref = ss.edge_order_segment_sum_plain(x, seg, N)
    assert torch.equal(out, again) and torch.equal(out, ref)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        ss.edge_order_segment_sum(x, seg, N)
    end.record()
    end.synchronize()
    assert start.elapsed_time(end) / 5 < 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sorted_gather_is_bit_equal(cuda, dtype):
    rng = np.random.default_rng(11)
    _, rcv = _uniform_ids(rng, 4, 128, 2048, True)
    rcv[-5:] = 512  # past the table: zero rows
    table = torch.from_numpy(rng.normal(size=(512, 384)).astype(
        np.float32)).to(dtype)
    before = ga.LAUNCHES
    out = ga.sorted_gather(table.to(cuda), rcv.to(cuda))
    torch.cuda.synchronize()
    assert ga.LAUNCHES == before + 1
    assert torch.equal(out.cpu(), ga.sorted_gather_plain(table, rcv))
    assert not out[-5:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1000, 4096])
@pytest.mark.parametrize("d", [128, 384, 512])
def test_ln_linear_backward_matches_plain(cuda, d, T):
    rng = np.random.default_rng(12)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:3] = 0.0  # var == 0 rows
    args = [x.bfloat16(), 1 + 0.1 * f(d), 0.1 * f(d),
            (f(d, 384) * d ** -0.5).bfloat16(), f(T, 384).bfloat16()]
    ref = ll.ln_linear_backward(*args)  # CPU: the plain version
    before = ll.LAUNCHES
    out = ll.ln_linear_backward(*[t.to(cuda) for t in args])
    torch.cuda.synchronize()
    assert ll.LAUNCHES == before + 1
    assert out[0].dtype == torch.bfloat16
    for o, r, tol in zip(out, ref, (2.0 ** -6, 1e-3, 1e-3, 1e-3)):
        _close_max(o, r, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 1000, 8200, 40000])
@pytest.mark.parametrize("d,dout", [(128, 128), (256, 256), (256, 384),
                                    (384, 384), (512, 512), (512, 128)])
def test_ln_linear_backward_tensor_core_passes(cuda, d, dout, T):
    """The bf16 ``wgmma`` passes at every width they are built for: 8 rows,
    rows not in whole 64-row tiles, persistent row-pass blocks that walk
    several tiles (T = 40000), rows with var == 0 (zeros, and a constant);
    two launches bit-equal (the fused reduction's fixed order)."""
    rng = np.random.default_rng(23)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:2], x[2] = 0.0, 1.5
    args = [t.to(cuda) for t in (x.bfloat16(), 1 + 0.1 * f(d), 0.1 * f(d),
                                 (f(d, dout) * d ** -0.5).bfloat16(),
                                 f(T, dout).bfloat16())]
    assert ll._one_step_rows(d, dout, torch.bfloat16)
    ref = lnp.ln_linear_backward_plain(*args)
    before = ll.LAUNCHES
    out = ll.ln_linear_backward(*args)
    again = ll.ln_linear_backward(*args)
    torch.cuda.synchronize()
    assert ll.LAUNCHES == before + 2
    for o, a in zip(out, again):
        assert torch.equal(o, a)
    assert out[0].dtype == torch.bfloat16
    for o, r, tol in zip(out, ref, (2.0 ** -6, 1e-3, 1e-3, 1e-3)):
        _close_max(o, r, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True])
def test_fused_edge_update_and_gradients_match_plain(cuda, padded):
    G, n_slots, e_slots, d = 4, 32, 256, 128
    rng = np.random.default_rng(13)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    snd, rcv = _uniform_ids(rng, G, n_slots, e_slots, padded)
    base = {"ef": f(G * e_slots, d).bfloat16(), "scale": 1 + 0.1 * f(d),
            "bias": 0.1 * f(d), "w0": (f(d, d) * 0.05).bfloat16(),
            "ts": f(G * n_slots, d), "tr": f(G * n_slots, d),
            "tg": f(G, d), "b": f(d)}
    ct = f(G * e_slots, d).bfloat16()
    results = []
    for dev in ("cpu", cuda):
        ins = {k: v.to(dev).detach().requires_grad_()
               for k, v in base.items()}
        h = eu.fused_edge_update(
            ins["ef"], {"scale": ins["scale"], "bias": ins["bias"]},
            ins["w0"], ins["ts"], ins["tr"], ins["tg"], ins["b"],
            snd.to(dev), rcv.to(dev), n_slots, e_slots)
        h.backward(ct.to(dev))
        results.append((h, {k: v.grad for k, v in ins.items()}))
    torch.cuda.synchronize()
    (h_p, g_p), (h_k, g_k) = results
    _close_max(h_k, h_p, 2.0 ** -7)
    for k in base:
        _close_max(g_k[k], g_p[k], 5e-2)


@pytest.mark.cuda
def test_training_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(64, 384, device=cuda)
    v = torch.zeros(384, device=cuda)
    with pytest.raises(ValueError):  # float16: the kernel takes bf16 and f32
        ll.ln_linear_backward(x.half(), v, v,
                              torch.zeros(384, 384, device=cuda), x)
    with pytest.raises(TypeError):
        ss.sorted_segment_sum(x, torch.zeros(64, dtype=torch.int64,
                                             device=cuda), 8)
    with pytest.raises(ValueError):
        ga.sorted_gather(torch.zeros(8, 3, device=cuda),
                         torch.zeros(4, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("addend", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [512, 1000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_matmul_matches_plain(cuda, dtype, T, addend):
    """T = 1000 leaves the last row block partial in both kernels."""
    d, dout = 384, 256
    rng = np.random.default_rng(14)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:3] = 0.0  # var == 0 rows
    args = [x.to(dtype), 1 + 0.1 * f(d), 0.1 * f(d),
            (f(d, dout) * d ** -0.5).to(dtype)]
    add = None if addend is None else f(T, dout).to(addend)
    ref = ll.ln_matmul(*args, addend=add)  # CPU: the plain version
    before = ll.FWD_LAUNCHES
    out = ll.ln_matmul(*[t.to(cuda) for t in args],
                       addend=None if add is None else add.to(cuda))
    torch.cuda.synchronize()
    assert ll.FWD_LAUNCHES == before + 1
    assert out.dtype == ref.dtype == (torch.float32 if add is None
                                      else dtype)
    if dtype == torch.float32:
        tol = 1e-4
    else:
        tol = 1e-3 if add is None else 2.0 ** -7
    _close_max(out, ref, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [512, 1000])
@pytest.mark.parametrize("d", [128, 384, 512])
def test_ln_linear_backward_f32_matches_plain(cuda, d, T):
    rng = np.random.default_rng(15)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:3] = 0.0  # var == 0 rows
    args = [x, 1 + 0.1 * f(d), 0.1 * f(d), f(d, 384) * d ** -0.5, f(T, 384)]
    ref = ll.ln_linear_backward(*args)  # CPU: the plain version
    before = ll.LAUNCHES
    out = ll.ln_linear_backward(*[t.to(cuda) for t in args])
    torch.cuda.synchronize()
    assert ll.LAUNCHES == before + 1
    assert out[0].dtype == torch.float32
    for o, r in zip(out, ref):
        _close_max(o, r, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_matmul_gradients_match_plain(cuda, dtype):
    T, d = 512, 384
    rng = np.random.default_rng(16)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    base = {"x": f(T, d).to(dtype), "scale": 1 + 0.1 * f(d),
            "bias": 0.1 * f(d), "w": f(d, d) * d ** -0.5, "addend": f(T, d)}
    ct = f(T, d).to(dtype)
    grads = []
    for dev in ("cpu", cuda):
        ins = {k: v.to(dev).detach().requires_grad_()
               for k, v in base.items()}
        before = (ll.FWD_LAUNCHES, ll.LAUNCHES)
        ll.ln_matmul(ins["x"], ins["scale"], ins["bias"], ins["w"],
                     addend=ins["addend"]).backward(ct.to(dev))
        launched = (ll.FWD_LAUNCHES - before[0], ll.LAUNCHES - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads.append({k: v.grad for k, v in ins.items()})
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for k in base:
        assert grads[1][k].dtype == base[k].dtype
        _close_max(grads[1][k], grads[0][k],
                   tol if k in ("x", "addend") else max(tol, 1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [512, 640])
def test_ln_matmul_f32_wide_rows_launch_or_raise(cuda, d):
    """f32 rows wider than 384 take the forward kernel, and the backward
    launches its kernel too (at d = 640 its two-step wide form): nothing
    composes plain ops on the card and nothing raises."""
    T, dout = 256, 128
    rng = np.random.default_rng(18)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    base = [f(T, d), 1 + 0.1 * f(d), 0.1 * f(d), f(d, dout) * d ** -0.5]
    ct = f(T, dout)
    cpu = [t.clone().requires_grad_() for t in base]
    ref = ll.ln_matmul(*cpu)
    ref.backward(ct)
    dev = [t.to(cuda).requires_grad_() for t in base]
    before = (ll.FWD_LAUNCHES, ll.LAUNCHES)
    out = ll.ln_matmul(*dev)
    torch.cuda.synchronize()
    assert ll.FWD_LAUNCHES == before[0] + 1
    _close_max(out, ref, 1e-4)
    out.backward(ct.to(cuda))
    torch.cuda.synchronize()
    assert ll.LAUNCHES == before[1] + 1
    for a, b in zip(dev, cpu):
        _close_max(a.grad, b.grad, 1e-4)


@pytest.mark.cuda
def test_ln_matmul_bf16_rows_past_shared_memory_warn_once(cuda, caplog):
    """bf16 rows at d = 512: the kernel takes every width of the gate
    (rows too wide for its shared memory are held in pieces), so it runs
    (no plain composition on the card) and nothing is logged."""
    T, d = 64, 512
    x = torch.randn(T, d, device=cuda).bfloat16()
    v = torch.ones(d, device=cuda)
    w = torch.randn(d, 128, device=cuda) * d ** -0.5
    assert ll.supports_ln_matmul(T, d, 128, torch.bfloat16)
    before = ll.FWD_LAUNCHES
    with caplog.at_level("WARNING", logger="graphnets_tpu_torch"):
        out = ll.ln_matmul(x, v, v, w)
        ll.ln_matmul(x, v, v, w)
    torch.cuda.synchronize()
    assert ll.FWD_LAUNCHES == before + 2
    assert not caplog.records
    _close_max(out, lnp.ln_matmul_reference(x, v, v, w), 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,dout,dtype", [
    (4096, 512, 512, torch.bfloat16), (1000, 1024, 1024, torch.bfloat16),
    (1000, 640, 640, torch.float32), (264, 2816, 128, torch.bfloat16),
    (264, 128, 5248, torch.bfloat16), (264, 1792, 128, torch.float32)])
@pytest.mark.parametrize("addend", [False, True])
def test_ln_matmul_wide_rows_match_plain(cuda, T, d, dout, dtype, addend):
    """The wide end of the JAX package's gate (d = dout = 512 and 1024 in
    bf16, 640 in f32, and the widest d and dout of the gate; the backward's
    row pass in two steps): forward and backward kernels against the plain
    versions."""
    assert ll.supports_ln_matmul(T, d, dout, dtype)
    rng = np.random.default_rng(19)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:2] = 0.0
    args = [x.to(dtype), 1 + 0.1 * f(d), 0.1 * f(d),
            (f(d, dout) * d ** -0.5).to(dtype)]
    add = f(T, dout) if addend else None
    g = f(T, dout).to(dtype)
    ref = lnp.ln_matmul_reference(*args, addend=add)
    bref = lnp.ln_linear_backward_plain(*args, g)
    dev = [t.to(cuda) for t in args]
    before = (ll.FWD_LAUNCHES, ll.LAUNCHES)
    out = ll.ln_matmul(*dev, addend=None if add is None else add.to(cuda))
    bw = ll.ln_linear_backward(*dev, g.to(cuda))
    torch.cuda.synchronize()
    assert (ll.FWD_LAUNCHES, ll.LAUNCHES) == (before[0] + 1, before[1] + 1)
    if dtype == torch.float32:
        tol, tols = 1e-4, (1e-4,) * 4
    else:
        tol, tols = (2.0 ** -7 if addend else 1e-3), (2.0 ** -6, 1e-3, 1e-3,
                                                      1e-3)
    _close_max(out, ref, tol)
    for o, r, t in zip(bw, bref, tols):
        _close_max(o, r, t)


@pytest.mark.cuda
@pytest.mark.parametrize("addend", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,dout", [(1000, 384, 384), (264, 384, 256),
                                      (264, 1024, 128), (1000, 128, 640)])
def test_ln_matmul_wgmma_relaunch_bit_equal(cuda, T, d, dout, addend):
    """bf16 rows on the ``wgmma`` core: T not a multiple of 64 (1000, 264:
    a partial last tile, a warpgroup with no rows), var == 0 rows, an f32
    or a bf16 addend or none (the f32 product out), rows held whole or in
    pieces: within the tolerances of ``test_ln_matmul_matches_plain``, one
    launch a call, and a second launch bit-equal."""
    rng = np.random.default_rng(26)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:5] = 0.0  # var == 0 rows
    x[7] = 3.0
    args = [x.bfloat16(), 1 + 0.1 * f(d), 0.1 * f(d),
            (f(d, dout) * d ** -0.5).bfloat16()]
    add = None if addend is None else f(T, dout).to(addend)
    ref = lnp.ln_matmul_reference(*args, addend=add)
    dev = [t.to(cuda) for t in args]
    dev_add = None if add is None else add.to(cuda)
    before = ll.FWD_LAUNCHES
    out = ll.ln_matmul(*dev, addend=dev_add)
    again = ll.ln_matmul(*dev, addend=dev_add)
    torch.cuda.synchronize()
    assert ll.FWD_LAUNCHES == before + 2
    assert out.dtype == ref.dtype and torch.equal(out, again)
    _close_max(out, ref, 1e-3 if add is None else 2.0 ** -7)


def _sorted_receivers(rng, E, N, pads):
    """Ascending ids; with ``pads`` two fifths of the slots are real edges
    (one node a hub spanning several 64-row tiles, many nodes empty) and
    the rest pad edges on the last node."""
    if not pads:
        return torch.from_numpy(np.sort(rng.integers(0, N, E)).astype(
            np.int32))
    real = E * 2 // 5
    r = rng.integers(0, N - 1, real)
    r[:E // 8] = 5
    r[r % 3 == 1] = 9
    return torch.from_numpy(np.sort(np.concatenate(
        [r, np.full(E - real, N - 1)])).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("pads", [False, True])
@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("dtype,parts", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
def test_g1_edge_update_matches_plain(cuda, dtype, parts, has_ln, pads):
    """The single-graph edge update, with and without the edge->node sum,
    and all its gradients, against the plain version on the CPU."""
    E, N, de, dout = 2048, 256, 256, 128
    rng = np.random.default_rng(20)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    ef = f(E, de)
    ef[:2] = 0.0
    base = dict(ef=ef.to(dtype), w0=(f(de, dout) * de ** -0.5).to(dtype),
                src=f(E, dout).to(parts), tr=f(N, dout).to(parts),
                gb=f(dout), scale=1 + 0.1 * f(de), bias=0.1 * f(de))
    rl = _sorted_receivers(rng, E, N, pads)
    ct_h, ct_a = f(E, dout).to(dtype), f(N, dout)
    assert g1.supports_g1_edge_update(E, N, de, dout, ef.to(dtype)
                                      .element_size(), with_agg=True,
                                      part_itemsize=base["src"].element_size())

    def run(device, with_agg):
        t = {k: v.detach().clone().to(device).requires_grad_()
             for k, v in base.items()}
        ln = {"scale": t["scale"], "bias": t["bias"]} if has_ln else None
        args = (t["ef"], ln, t["w0"], t["src"], t["tr"], rl.to(device),
                t["gb"])
        if with_agg:
            h, agg = g1.fused_g1_edge_update_agg(*args)
            torch.autograd.backward([h, agg], [ct_h.to(device),
                                               ct_a.to(device)])
            return h, agg, t
        h = g1.fused_g1_edge_update(*args)
        h.backward(ct_h.to(device))
        return h, None, t

    bf = dtype == torch.bfloat16
    for with_agg in (True, False):
        h_ref, agg_ref, t_ref = run("cpu", with_agg)
        before = (g1.LAUNCHES, g1.LAUNCHES_NO_AGG)
        h, agg, t = run(cuda, with_agg)
        torch.cuda.synchronize()
        assert (g1.LAUNCHES, g1.LAUNCHES_NO_AGG) == (
            before[0] + with_agg, before[1] + (not with_agg))
        _close_max(h, h_ref, 2.0 ** -7 if bf else 1e-5)
        if with_agg:
            own = torch.zeros(N, dout).index_add_(0, rl.long(),
                                                  h.detach().float().cpu())
            _close_max(agg, own, 1e-5)
            empty = torch.bincount(rl.long(), minlength=N) == 0
            assert not agg.detach().cpu()[empty].any()
        for k in base:
            if not has_ln and k in ("scale", "bias"):
                continue
            _close_max(t[k].grad, t_ref[k].grad, 5e-2 if bf else 1e-4)


def _ffn_backward_case(cuda, dtype, d, T):
    """The kernel's and the plain version's gradients on the card for
    seeded inputs (two rows constant), and a second launch of the
    kernel."""
    rng = np.random.default_rng(21)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:2] = 0.0
    args = [x.to(dtype), 1 + 0.1 * f(d), 0.1 * f(d),
            (f(d, 4 * d) * d ** -0.5).to(dtype), (0.1 * f(4 * d)).to(dtype),
            (f(4 * d, d) * (4 * d) ** -0.5).to(dtype), f(T, d).to(dtype)]
    dev = [t.to(cuda) for t in args]
    ref = ffn.ln_ffn_backward_plain(*dev)
    before = ffn.BWD_LAUNCHES
    out = ffn.ln_ffn_backward(*dev)
    again = ffn.ln_ffn_backward(*dev)
    torch.cuda.synchronize()
    assert ffn.BWD_LAUNCHES == before + 2
    for o, a, r in zip(out, again, ref):
        assert o.dtype == r.dtype and torch.equal(o, a)
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 200, 1000, 8192])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_ffn_backward_matches_plain(cuda, dtype, d, T):
    """The trained widths on bf16 and f32 rows, with row counts that are
    not whole 64- or 128-row tiles, against the plain version on the card
    (as ``chip_smoke.py`` holds it); two launches bit-equal."""
    out, ref = _ffn_backward_case(cuda, dtype, d, T)
    tols = (2.0 ** -6 if dtype == torch.bfloat16 else 1e-4,) + (1e-2,) * 6
    for o, r, tol in zip(out, ref, tols):
        _close_max(o, r, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 200, 1000, 8192])
@pytest.mark.parametrize("d", [384, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_ffn_backward_wide_rows_match_plain(cuda, dtype, d, T):
    """The rest of the JAX gate's widths.  dx, dW2 and db2 as above; the
    gradients that pass through the relu mask (dscale, dbias, dW1, db1) by
    the 2-norm of the difference, within 1e-2 of the plain version's norm:
    at T = 8192 and d = 384 a mask flips where the f32 pre-activation of
    12.6M is within summation-order rounding of 0, moving one column of
    dW1 by 2% of its largest element, a tail value the norm does not
    weigh (``chip_smoke.py`` holds T = 65,536 by the
    largest element)."""
    out, ref = _ffn_backward_case(cuda, dtype, d, T)
    tols = (2.0 ** -6 if dtype == torch.bfloat16 else 1e-4,) + (1e-2,) * 6
    for i in (0, 5, 6):
        _close_max(out[i], ref[i], tols[i])
    for i in (1, 2, 3, 4):
        o, r = out[i].float().cpu(), ref[i].float().cpu()
        assert bool(torch.isfinite(o).all())
        assert float((o - r).norm()) <= 1e-2 * float(r.norm())


@pytest.mark.cuda
def test_ln_ffn_residual_trains_through_its_backward_kernel(cuda):
    """Autograd through the fused forward reaches the backward kernel, with
    ``extra``'s gradient the cotangent itself; d = 640, outside the JAX
    gate, raises."""
    T, d = 512, 256
    rng = np.random.default_rng(22)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    bf = torch.bfloat16
    base = [f(T, d).to(bf), 1 + 0.1 * f(d), 0.1 * f(d),
            (f(d, 4 * d) * d ** -0.5).to(bf), (0.1 * f(4 * d)).to(bf),
            (f(4 * d, d) * (4 * d) ** -0.5).to(bf), (0.1 * f(d)).to(bf),
            f(T, d).to(bf)]
    ct = f(T, d).to(bf)
    cpu = [t.clone().requires_grad_() for t in base]
    ffn.ln_ffn_residual(*cpu[:7], extra=cpu[7]).backward(ct)
    dev = [t.to(cuda).requires_grad_() for t in base]
    before = (ffn.LAUNCHES, ffn.BWD_LAUNCHES)
    ffn.ln_ffn_residual(*dev[:7], extra=dev[7]).backward(ct.to(cuda))
    torch.cuda.synchronize()
    assert (ffn.LAUNCHES, ffn.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(dev[7].grad.cpu(), ct)
    for a, b, tol in zip(dev[:7], cpu[:7], (2.0 ** -6,) + (1e-2,) * 6):
        _close_max(a.grad, b.grad, tol)
    wide = [torch.zeros(8, 640, device=cuda, dtype=bf).requires_grad_()] + [
        torch.zeros(*s, device=cuda) for s in
        ((640,), (640,), (640, 2560), (2560,), (2560, 640), (640,))]
    with pytest.raises(ValueError, match="unsupported"):
        ffn.ln_ffn_residual(*wide)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_random_gather_is_bit_equal(cuda, dtype):
    rng = np.random.default_rng(23)
    N, d, E = 1000, 256, 4096
    table = torch.from_numpy(rng.normal(size=(N, d)).astype(
        np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, N, E).astype(np.int32))
    ct = torch.from_numpy(rng.normal(size=(E, d)).astype(np.float32)).to(dtype)
    assert rg.supports_random_gather(E, N, d)
    t_cpu = table.clone().requires_grad_()
    rg.random_gather(t_cpu, idx).backward(ct)
    t_dev = table.to(cuda).requires_grad_()
    before = (rg.LAUNCHES, ss.LAUNCHES)
    out = rg.random_gather(t_dev, idx.to(cuda))
    out.backward(ct.to(cuda))
    torch.cuda.synchronize()
    assert (rg.LAUNCHES, ss.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out.detach().cpu(), table[idx.long()])
    _close_max(t_dev.grad, t_cpu.grad,
               2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)
    # Outside the gate (E not a multiple of 512): index_select, no launch.
    out = rg.random_gather(t_dev, idx[:100].to(cuda))
    assert rg.LAUNCHES == before[0] + 1
    assert torch.equal(out.detach().cpu(), table[idx[:100].long()])


@pytest.mark.cuda
@pytest.mark.parametrize("addend_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
def test_sorted_gather_add_matches_plain(cuda, table_dtype, addend_dtype):
    rng = np.random.default_rng(17)
    _, rcv = _uniform_ids(rng, 4, 128, 2048, True)
    rcv[-5:] = 512  # past the table: zero rows, the addend alone
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    table = f(512, 384).to(table_dtype).requires_grad_()
    addend = f(rcv.shape[0], 384).to(addend_dtype).requires_grad_()
    ct = f(rcv.shape[0], 384)
    ref = ga.sorted_gather_add(table, rcv, addend)  # CPU: the plain version
    ref.backward(ct.to(ref.dtype))
    tk = table.detach().to(cuda).requires_grad_()
    ak = addend.detach().to(cuda).requires_grad_()
    before = (ga.ADD_LAUNCHES, ss.LAUNCHES)
    out = ga.sorted_gather_add(tk, rcv.to(cuda), ak)
    out.backward(ct.to(cuda).to(out.dtype))
    torch.cuda.synchronize()
    assert (ga.ADD_LAUNCHES, ss.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.promote_types(table_dtype, addend_dtype)
    assert torch.equal(out.detach().cpu(), ref.detach())
    assert torch.equal(ak.grad.cpu(), addend.grad)
    _close_max(tk.grad, table.grad,
               2.0 ** -7 if table_dtype == torch.bfloat16 else 1e-5)


# ---- the wgmma edge updates (uniform layouts and the single graph) --------

# (G, n_slots, e_slots, de, dout, padded): the headline, exact and padded;
# de = 512, which the JAX gate admits and the port refused before; de =
# 1024, whose rows are held in pieces; a small tile of several graphs.
_UNIFORM_WIDE = [(8, 128, 2048, 384, 384, False),
                 (8, 128, 2048, 384, 384, True),
                 (16, 64, 1024, 512, 512, False),
                 (16, 32, 512, 1024, 1024, True),
                 (8, 32, 512, 512, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _UNIFORM_WIDE)
def test_uniform_edge_update_wgmma_matches_plain(cuda, case):
    """The uniform update with and without its sum against the plain
    version on the card: ``h`` one bf16 ulp, ``agg`` 1e-5 against the f32
    sum of the kernel's own ``h`` (zero for nodes without edges), both
    bit-equal on a second launch."""
    G, n_slots, e_slots, de, dout, padded = case
    E, N = G * e_slots, G * n_slots
    assert eu.supports_fused_edge_update(E, N, G, de, dout, n_slots,
                                         e_slots, torch.bfloat16,
                                         with_agg=True)
    rng = np.random.default_rng(22)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                    ).to(cuda)
    snd, rcv = (t.to(cuda) for t in _uniform_ids(rng, G, n_slots, e_slots,
                                                 padded))
    ef = f(E, de)
    ef[:2] = 0.0
    ln = {"scale": 1 + 0.1 * f(de), "bias": 0.1 * f(de)}
    args = (ef.bfloat16(), ln, (f(de, dout) * de ** -0.5).bfloat16(),
            f(N, dout), f(N, dout), f(G, dout), f(dout), snd, rcv, n_slots,
            e_slots)
    plain = eu.fused_edge_update_plain(args[0], ln["scale"], ln["bias"],
                                       *args[2:9], e_slots)
    before = (eu.LAUNCHES, eu.LAUNCHES_NO_AGG)
    h, agg = eu.fused_edge_update_agg(*args)
    h2, agg2 = eu.fused_edge_update_agg(*args)
    h3 = eu.fused_edge_update(*args)
    torch.cuda.synchronize()
    assert (eu.LAUNCHES, eu.LAUNCHES_NO_AGG) == (before[0] + 2,
                                                 before[1] + 1)
    _close_max(h, plain, 2.0 ** -7)
    assert torch.equal(h, h2) and torch.equal(agg, agg2)
    assert torch.equal(h3, h)
    own = torch.zeros_like(agg).index_add_(0, rcv.long(), h.float())
    _close_max(agg, own, 1e-5)
    empty = torch.bincount(rcv.long(), minlength=N) == 0
    assert not agg[empty].any()


# (E, N, d, parts, receivers): the large graph scaled down (uniform
# receivers, bf16 partials, W0 resident); the sampled subgraph scaled down
# (f32 partials, a hub over many 64-row tiles, empty nodes, pad edges);
# ragged edge counts (a last tile of 40 rows; a last 128-row tile with an
# empty half), which the gate refuses but the kernel takes; d = 512 (W0
# through the ring).
_G1_WIDE = [(65536, 4096, 256, torch.bfloat16, False),
            (7040, 7120, 256, torch.float32, True),
            (1000, 96, 256, torch.bfloat16, True),
            (1088, 96, 256, torch.float32, True),
            (4096, 512, 512, torch.bfloat16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _G1_WIDE)
def test_g1_edge_update_wgmma_matches_plain(cuda, case):
    """The single-graph wgmma kernel, called through its launcher (so the
    ragged counts reach it), against the plain version on the card: ``h``
    one bf16 ulp, ``agg`` 1e-5 of the f32 sum of its own ``h`` with zero
    rows for empty nodes, bit-equal on a second launch and when ``h`` is
    written over ``src``."""
    E, N, d, parts, pads = case
    rng = np.random.default_rng(23)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                    ).to(cuda)
    ef = f(E, d)
    ef[:3] = 0.0
    ef = ef.bfloat16()
    scale, bias = 1 + 0.1 * f(d), 0.1 * f(d)
    w0 = (f(d, d) * d ** -0.5).bfloat16()
    src, tr, gb = f(E, d).to(parts), f(N, d).to(parts), f(d)
    rl = _sorted_receivers(rng, E, N, pads).to(cuda)
    plain = g1.g1_edge_update_plain(ef, scale, bias, w0, src, tr, rl, gb)
    run = lambda with_agg, out=None: g1._launch(
        ef, scale, bias, w0, src if out is None else out, tr, rl, gb, True,
        with_agg, out=out)
    kept = src.clone()
    h, agg = run(True)
    h2, agg2 = run(True)
    h3 = run(False)
    torch.cuda.synchronize()
    assert torch.equal(src, kept)
    _close_max(h, plain, 2.0 ** -7)
    assert torch.equal(h, h2) and torch.equal(agg, agg2)
    assert torch.equal(h3, h)
    own = torch.zeros_like(agg).index_add_(0, rl.long(), h.float())
    _close_max(agg, own, 1e-5)
    empty = torch.bincount(rl.long(), minlength=N) == 0
    assert not agg[empty].any()
    if parts == torch.bfloat16:
        dead = src.clone()
        ha, agga = run(True, out=dead)
        torch.cuda.synchronize()
        assert ha.data_ptr() == dead.data_ptr()
        assert torch.equal(ha, h) and torch.equal(agga, agg)


@pytest.mark.cuda
def test_g1_public_call_writes_over_a_dead_src_only(cuda):
    """On the card a public call leaves ``src`` as it was; with
    ``src_is_dead`` the result lands in ``src`` and equals it."""
    E, N, d = 2048, 256, 256
    rng = np.random.default_rng(24)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                    ).to(cuda)
    ln = {"scale": 1 + 0.1 * f(d), "bias": 0.1 * f(d)}
    args = [f(E, d).bfloat16(), ln, (f(d, d) * d ** -0.5).bfloat16(),
            f(E, d).bfloat16(), f(N, d).bfloat16(),
            _sorted_receivers(rng, E, N, True).to(cuda), f(d)]
    kept = args[3].clone()
    h, agg = g1.fused_g1_edge_update_agg(*args)
    assert torch.equal(args[3], kept) and h.data_ptr() != args[3].data_ptr()
    ha, agga = g1.fused_g1_edge_update_agg(*args, src_is_dead=True)
    torch.cuda.synchronize()
    assert ha.data_ptr() == args[3].data_ptr()
    assert torch.equal(ha, h) and torch.equal(agga, agg)


# -- The captured step, prefetch to the card, remat on the kernel route -----
#
# One step captured as a CUDA graph against the same step run eagerly from
# the same state on the same batch: the loss within 1e-5 relative, every
# parameter after the step within 1e-5 of its largest magnitude plus a
# tenth of the learning rate (the graph pools' f32 atomics allow no more).


def _graph_batch(cuda, layout, n_graphs=4, n=30, d=128, seed=0):
    import graphnets_tpu_torch as pt
    rng = np.random.default_rng(seed)
    adjs = [(rng.random((n, n)) < 0.3).astype(np.int64)
            for _ in range(n_graphs)]
    E = sum(int(a.sum()) for a in adjs)
    data = {"graphs": adjs,
            "ef": [rng.normal(size=(int(a.sum()), d)).astype(np.float32)
                   for a in adjs],
            "nf": [rng.normal(size=(n, d)).astype(np.float32) for _ in adjs],
            "gf": rng.normal(size=(n_graphs, d)).astype(np.float32)}
    pad = (pt.PadSpec.uniform(n + 2, max(int(a.sum()) for a in adjs) + 64)
           if layout == "uniform" else
           pt.PadSpec.bucketed(n_graphs * n, E, n_graphs, node_multiple=32))
    x = pt.batch(data, pad=pad, device=cuda)
    bf = lambda t: t.to(torch.bfloat16)
    x = x.with_features(ef=bf(x.ef), nf=bf(x.nf), gf=bf(x.gf))
    t = lambda *s: bf(torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(cuda))
    return x, x.with_features(ef=t(*x.ef.shape), nf=t(*x.nf.shape), gf=None)


def _core_step(cuda, d=128, remat=False, lr=3e-4):
    import graphnets_tpu_torch as pt
    gen = torch.Generator().manual_seed(0)
    model = pt.GNCoreList([pt.GNCore((d, d, d), device=cuda, generator=gen)
                           for _ in range(2)], remat=remat)
    return model, pt.make_train_step(model, pt.adamw(model.parameters(), lr),
                                     compute_dtype=torch.bfloat16)


def _one_step_rule(models, losses, lr):
    a, b = (float(v) for v in losses)
    assert np.isfinite(a) and abs(a - b) <= 1e-5 * abs(b), (a, b)
    for (n, p), q in zip(models[0].named_parameters(),
                         models[1].parameters()):
        if p.numel():
            bound = 1e-5 * float(q.abs().max()) + 0.1 * lr
            assert float((p - q).abs().max()) <= bound, n


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["uniform", "bucketed"])
def test_captured_train_step_matches_eager(cuda, layout):
    import graphnets_tpu_torch as pt
    pt.enable_kernels(True)
    x, y = _graph_batch(cuda, layout)
    (mc, sc), (me, se) = _core_step(cuda), _core_step(cuda)
    cap = pt.capture_step(sc)
    _one_step_rule((mc, me), (cap(x, y)["loss"], se(x, y)["loss"]), 3e-4)
    assert cap.captures == 1 and cap.replays == 1
    losses = [float(cap(x, y)["loss"]) for _ in range(5)]
    assert all(np.isfinite(losses)) and cap.captures == 1


def _sampled_setup(cuda, seed=0, n=3000, e=30000, d=128, classes=8):
    import graphnets_tpu_torch as pt
    rng = np.random.default_rng(seed)
    g = pt.LargeGraph.from_coo(rng.integers(0, n, e), rng.integers(0, n, e),
                               rng.normal(size=(n, d)).astype(np.float32),
                               rng.integers(0, classes, n))
    return g, pt.device_feature_table(g, torch.bfloat16, device=cuda)


def _sampled_step(cuda, d=128, classes=8, lr=1e-3):
    import graphnets_tpu_torch as pt
    model = pt.EncodeProcessDecode((0, d, 0), (256,) * 3, (1, classes, 0),
                                   n_cores=2, device=cuda,
                                   generator=torch.Generator().manual_seed(0))
    return model, pt.make_node_classification_step(
        model, pt.adam(model.parameters(), lr), classes,
        compute_dtype=torch.bfloat16)


@pytest.mark.cuda
def test_captured_sampled_step_matches_eager(cuda):
    import graphnets_tpu_torch as pt
    pt.enable_kernels(True)
    g, feat = _sampled_setup(cuda)
    b = pt.NeighborSampler(g, (10, 10), 64, seed=1, emit_node_ids=True,
                           device=cuda).sample(np.arange(64))
    args = (b.graph, b.node_ids, b.labels, b.label_mask, b.seed_local_idx,
            feat)
    (mc, sc), (me, se) = _sampled_step(cuda), _sampled_step(cuda)
    cap = pt.capture_step(sc)
    _one_step_rule((mc, me), (cap(*args), se(*args)), 1e-3)


@pytest.mark.cuda
def test_prefetch_pool_to_the_card(cuda):
    """Pinned CPU batches moved by the workers on their own streams arrive
    on the card equal to the in-line sampler's, and a step on them runs."""
    import itertools
    import graphnets_tpu_torch as pt
    g, feat = _sampled_setup(cuda, seed=1)

    def sampler(seed, **kw):
        return pt.NeighborSampler(g, (5, 5), 32, seed=seed,
                                  emit_node_ids=True, **kw)

    def factory(wid):
        it = sampler(10 + wid, device="cpu", pin_memory=True).epoch(
            np.arange(g.num_nodes))
        for i, b in enumerate(itertools.islice(it, 6)):
            assert b.node_ids.is_pinned()
            yield wid, i, b

    got = list(pt.PrefetchPool(factory, num_workers=3, device=cuda))
    assert len(got) == 18
    for wid, i, b in got:
        ref = list(itertools.islice(sampler(10 + wid, device="cpu").epoch(
            np.arange(g.num_nodes)), 6))[i]
        for have, want in zip((b.node_ids, b.graph.senders, b.graph.receivers,
                               b.labels, b.label_mask),
                              (ref.node_ids, ref.graph.senders,
                               ref.graph.receivers, ref.labels,
                               ref.label_mask)):
            assert have.is_cuda and torch.equal(have.cpu(), want)
    one = [b for _, _, b in got][:3]
    out = [feat.index_select(0, b.node_ids).float().sum() for b in one]
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in out)


@pytest.mark.cuda
def test_remat_on_the_kernel_route(cuda):
    """A bf16 step of a stack under remat on the card, against the same
    step without: loss within 1e-5 relative, each gradient within 1e-2 of
    its largest magnitude (f32 atomics in the graph pools)."""
    import graphnets_tpu_torch as pt
    pt.enable_kernels(True)
    x, y = _graph_batch(cuda, "uniform", seed=3)
    out = []
    for remat in (False, True):
        m, step = _core_step(cuda, remat=remat)
        loss = float(step(x, y)["loss"])
        # A leaf the loss does not reach keeps no gradient on the card
        # (the port's optimizer takes it as zero): zeros here.
        out.append((loss, {n: torch.zeros_like(p) if p.grad is None
                           else p.grad.clone()
                           for n, p in m.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for n in g0:
        assert float((g1[n] - g0[n]).abs().max()) <= \
            1e-2 * float(g0[n].abs().max()) + 1e-12, n


@pytest.mark.cuda
def test_two_captured_graphs_share_one_pool(cuda):
    """Two bucket shapes give two graphs of one memory pool; replays in
    any order each equal an eager step from the same state."""
    import graphnets_tpu_torch as pt
    pt.enable_kernels(True)
    xs = [_graph_batch(cuda, "bucketed", n=n, seed=n) for n in (30, 40)]
    (mc, sc), (me, se) = _core_step(cuda), _core_step(cuda)
    cap = pt.capture_step(sc)
    for i in (0, 1, 1, 0, 1):
        x, y = xs[i]
        _one_step_rule((mc, me), (cap(x, y)["loss"], se(x, y)["loss"]),
                       3e-4)
    assert cap.captures == 2 and cap.replays == 5
    assert len({id(v[1]) for v in cap._graphs.values()}) == 2


# -- The sort flagship's device loop ------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("uniform", [False, True])
def test_captured_device_batches_follow_the_generator(cuda, uniform):
    """A step that draws a sort batch on the card, captured as a CUDA graph:
    each replay draws the batch that an eager call from the same generator
    state draws, bit for bit, and two replays draw different batches (the
    generator is registered with the graph and advances every replay)."""
    import graphnets_tpu_torch as pt
    cfg = pt.SortTaskConfig()
    pad = pt.sort_pad_spec(cfg, uniform)
    gen = torch.Generator(device=cuda).manual_seed(5)

    def step():
        x, y = pt.device_batch(gen, cfg, pad)
        return x.nf, x.senders, x.receivers, x.n_node, y.nf, y.ef

    step.generators = (gen,)
    cap = pt.capture_step(step)
    start = gen.get_state()
    replays = [cap() for _ in range(3)]
    assert cap.captures == 1 and cap.replays == 3
    gen.set_state(start)
    eager = [step() for _ in range(3)]
    for a, b in zip(replays, eager):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    assert not torch.equal(replays[0][0], replays[1][0])


@pytest.mark.cuda
def test_captured_device_chunk_matches_eager(cuda):
    """Four steps of the device loop's step captured against four eager
    steps from the same state and generator state, under the one-step rule
    above; the summed metrics agree as the losses do."""
    import graphnets_tpu_torch as pt
    pt.enable_kernels(True)
    cfg = pt.SortTaskConfig()

    def build():
        model = pt.EncodeProcessDecode(
            (0, 100, 0), (128,) * 3, (2, 2, 0), n_cores=2, device=cuda,
            generator=torch.Generator().manual_seed(0))
        state = pt.TrainState(model, pt.adamw(model.parameters()), 0,
                              (torch.Generator(device=cuda).manual_seed(1),))
        return model, pt.make_sort_device_step(state, cfg)

    (mc, sc), (me, se) = build(), build()
    cap = pt.capture_step(sc)
    for _ in range(4):
        cap()
        se()
    _one_step_rule((mc, me), (sc.sums["loss"], se.sums["loss"]), 3e-4)
    assert cap.captures == 1 and cap.replays == 4


@pytest.mark.cuda
def test_few_segment_sums_repeat_bit_for_bit(cuda):
    """The graph pools (at most 64 segments) are a one-hot f32 product in a
    fixed order, as JAX's one-hot matmul: two calls on the card are
    bit-equal, where float atomics (``index_add_``) may not be."""
    from graphnets_tpu_torch.ops.scatter import segment_sum
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(16384, 384, generator=gen).to(cuda)
    seg = torch.sort(torch.randint(0, 8, (16384,), generator=gen))[0].to(
        torch.int32).to(cuda)
    outs = [segment_sum(x, seg, 8) for _ in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = torch.zeros(8, 384, dtype=torch.float64, device=cuda).index_add_(
        0, seg.long(), x.double())
    assert float((outs[0].double() - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max())
    # With TF32 switched on by the caller the product stays f32 (TF32's
    # 10-bit mantissa would miss the reference by ~1e-3), and so does its
    # backward (each row's gradient is one exact term).
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        xg = x.clone().requires_grad_()
        tf32_out = segment_sum(xg, seg, 8)
        w = torch.randn(8, 384, generator=gen).to(cuda)
        (tf32_out * w).sum().backward()
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(tf32_out.detach(), outs[0])
    assert torch.equal(xg.grad, w[seg.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("use_ln", [True, False])
def test_fused_edge_update_agg_gradients_match_plain(cuda, use_ln):
    """The inference edge update with its sum is differentiable on the
    card through both outputs: the gradients of every input against
    autograd of the plain version (5e-2 of each tensor's largest
    magnitude, bf16 cotangents), the sorted gather launched for ``agg``'s
    cotangent."""
    G, n_slots, e_slots, d = 4, 32, 256, 128
    rng = np.random.default_rng(17)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    snd, rcv = _uniform_ids(rng, G, n_slots, e_slots, False)
    base = {"ef": f(G * e_slots, d).bfloat16(), "scale": 1 + 0.1 * f(d),
            "bias": 0.1 * f(d), "w0": (f(d, d) * 0.05).bfloat16(),
            "ts": f(G * n_slots, d), "tr": f(G * n_slots, d),
            "tg": f(G, d), "b": f(d)}
    ct_h, ct_agg = f(G * e_slots, d).bfloat16().to(cuda), \
        f(G * n_slots, d).to(cuda)
    results = []
    for kernel in (False, True):
        ins = {k: v.to(cuda).detach().requires_grad_()
               for k, v in base.items()}
        ln = {"scale": ins["scale"], "bias": ins["bias"]} if use_ln else None
        args = (ins["ef"], ln, ins["w0"], ins["ts"], ins["tr"], ins["tg"],
                ins["b"], snd.to(cuda), rcv.to(cuda), n_slots, e_slots)
        if kernel:
            before = (eu.LAUNCHES, ga.LAUNCHES)
            h, agg = eu.fused_edge_update_agg(*args)
        else:
            scale = ins["scale"] if use_ln else torch.ones(d, device=cuda)
            bias = ins["bias"] if use_ln else torch.zeros(d, device=cuda)
            h, agg = eu.fused_edge_update_agg_plain(
                ins["ef"], scale, bias, ins["w0"], ins["ts"], ins["tr"],
                ins["tg"], ins["b"], snd.to(cuda), rcv.to(cuda), e_slots,
                use_ln)
        torch.autograd.backward((h, agg), (ct_h, ct_agg))
        results.append({k: v.grad for k, v in ins.items()})
    torch.cuda.synchronize()
    assert (eu.LAUNCHES, ga.LAUNCHES) == (before[0] + 1, before[1] + 1)
    plain, kern = results
    for k in base:
        if not use_ln and k in ("scale", "bias"):
            continue
        assert kern[k] is not None, k
        _close_max(kern[k], plain[k], 5e-2)


@pytest.mark.cuda
def test_captured_dp_step_matches_the_plain_captured_step(cuda, tmp_path):
    """``make_dp_train_step`` at world size 1 (NCCL) through
    ``capture_step``, the all-reduce inside the graph, against the plain
    captured step on the same batch and weights under the one-step rule;
    each warm-up and the capture call the collective once."""
    import torch.distributed as dist
    import graphnets_tpu_torch as pt
    from graphnets_tpu_torch.parallel import _comm
    from graphnets_tpu_torch.parallel.data_parallel import make_dp_train_step
    from graphnets_tpu_torch.parallel.distributed import init_distributed
    from graphnets_tpu_torch.parallel.mesh import make_mesh
    pt.enable_kernels(True)
    init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cuda",
                     timeout_s=120)
    try:
        assert dist.get_backend() == "nccl"
        x, y = _graph_batch(cuda, "uniform")
        (mc, _), (me, se) = _core_step(cuda), _core_step(cuda)
        dp = pt.capture_step(make_dp_train_step(
            mc, pt.adamw(mc.parameters(), 3e-4), make_mesh(),
            compute_dtype=torch.bfloat16))
        plain = pt.capture_step(se)
        before = _comm.COLLECTIVES
        _one_step_rule((mc, me), (dp(x, y)["loss"], plain(x, y)["loss"]),
                       3e-4)
        assert _comm.COLLECTIVES - before == dp.traced_calls == 3
        losses = [float(dp(x, y)["loss"]) for _ in range(5)]
        assert all(np.isfinite(losses)) and dp.captures == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_captured_schedule_matches_eager(cuda):
    """The device loop's step with a warmup-cosine AdamW, captured against
    eager from the same state: the rate written at each step bit-equal and
    equal to the schedule at the step's count, then the one-step rule on
    the parameters."""
    import graphnets_tpu_torch as pt
    from graphnets_tpu_torch.training.schedules import \
        warmup_cosine_decay_schedule
    pt.enable_kernels(True)
    cfg = pt.SortTaskConfig()
    sched = warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10, 1e-5)

    def build():
        model = pt.EncodeProcessDecode(
            (0, 100, 0), (128,) * 3, (2, 2, 0), n_cores=2, device=cuda,
            generator=torch.Generator().manual_seed(0))
        state = pt.TrainState(model, pt.adamw(model.parameters(), sched), 0,
                              (torch.Generator(device=cuda).manual_seed(1),))
        return model, state, pt.make_sort_device_step(state, cfg)

    (mc, stc, sc), (me, ste, se) = build(), build()
    cap = pt.capture_step(sc)
    rates = {"c": [], "e": []}
    for _ in range(6):
        cap()
        se()
        rates["c"].append(stc.optimizer.param_groups[0]["lr"].item())
        rates["e"].append(ste.optimizer.param_groups[0]["lr"].item())
    want = [sched(torch.tensor(float(i), device=cuda)).item()
            for i in range(6)]
    assert rates["c"] == rates["e"] == want
    _one_step_rule((mc, me), (sc.sums["loss"], se.sums["loss"]), 3e-4)


def _partitioned_case(cuda, layout, N=2048, deg=8, d=256, seed=3):
    """One shard of a single graph with all three feature sets, its halo
    plan and a ``GNCoreList`` of one core at width ``d``.  ``uniform``:
    in-degree ``deg`` and random senders, ``N * deg`` edges, no pad slot;
    ``padded``: 77 edges fewer, random receivers too, so in-degrees vary,
    some nodes receive nothing and the pad slots sit on the overflow
    segment ``Npad``."""
    import graphnets_tpu_torch as pt
    from graphnets_tpu_torch.parallel import edge_partition as ep
    rng = np.random.default_rng(seed)
    E = N * deg if layout == "uniform" else N * deg - 77
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    receivers = (np.repeat(np.arange(N), deg) if layout == "uniform"
                 else rng.integers(0, N, E))
    pg = ep.partition_edges(
        rng.integers(0, N, E).astype(np.int32), receivers.astype(np.int32),
        f(N, d), 1, ef=f(E, d), gf=f(d), device=cuda)
    pads = int((~pg.edge_mask).sum())
    assert pads == (0 if layout == "uniform" else 77)
    cores = pt.GNCoreList([pt.GNCore((d, d, d), device=cuda,
                                     generator=torch.Generator().manual_seed(
                                         seed))])
    return pg, ep.build_halo_plan(pg), cores


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["uniform", "padded"])
@pytest.mark.parametrize("route", ["g1", "composed"])
def test_partitioned_v3_core_matches_plain(cuda, route, layout):
    """The partitioned v3 core on one shard on the card, on a layout
    without pad slots and on one with pads on the overflow segment, kernel
    route against the plain route (kernels off) on the same inputs: bf16 rows
    forward under training (the single-graph edge update with its sum,
    or with ``g1_agg_fusion_training`` off the composed route:
    ``sorted_gather_add``, ``ln_matmul`` and the sorted sum over ``Npad +
    1`` segments), each output within 5e-2 of its largest magnitude; on
    f32 rows the outputs and the gradients of every parameter within 1e-3
    of their largest magnitude.  Outputs and loss take the real rows only:
    a pad slot's row is junk, and the routes' junk differs (the kernel's
    receiver table has zero rows past ``Npad``, the composed route clamps
    to ``Npad - 1``).  The route's kernels launch once each, the sorted
    sum at least once on the composed route, the plain route's none."""
    import graphnets_tpu_torch as pt
    from graphnets_tpu_torch.parallel.edge_partition_stack import \
        gn_core_list_partitioned
    from graphnets_tpu_torch.utils.config import get_config
    pg, plan, cores = _partitioned_case(cuda, layout)
    em, nm = pg.edge_mask[0], pg.node_mask[0]
    get_config().g1_agg_fusion_training = route == "g1"
    try:
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
            x = pg.replace(ef=pg.ef.to(dtype), nf=pg.nf.to(dtype),
                           gf=pg.gf.to(dtype))
            model = cores.to(dtype)
            res = []
            for kernels in (True, False):
                pt.enable_kernels(kernels)
                model.zero_grad(set_to_none=True)
                before = (g1.LAUNCHES, ga.ADD_LAUNCHES, ll.FWD_LAUNCHES,
                          ss.LAUNCHES)
                y = gn_core_list_partitioned(model, x, plan, training=True)
                out = (y.ef[0][em], y.nf[0][nm], y.gf)
                sum(t.float().square().sum() for t in out).backward()
                torch.cuda.synchronize()
                res.append((out, {n: p.grad.clone()
                                  for n, p in model.named_parameters()},
                            (g1.LAUNCHES - before[0],
                             ga.ADD_LAUNCHES - before[1],
                             ll.FWD_LAUNCHES - before[2]),
                            ss.LAUNCHES - before[3]))
            (kern, kgrads, launches, sums), (plain, pgrads, none,
                                              plain_sums) = res
            assert launches == ((1, 0, 0) if route == "g1" else (0, 1, 1))
            assert route == "g1" or sums >= 1
            assert none == (0, 0, 0) and plain_sums == 0
            for a, b in zip(kern, plain):
                _close_max(a, b, tol)
            if dtype == torch.float32:
                for n in pgrads:
                    _close_max(kgrads[n], pgrads[n], tol)
    finally:
        get_config().g1_agg_fusion_training = True
        pt.enable_kernels(True)
        cores.float()
