"""The sorted segment sum on the layouts of ``tests/segment_layouts.py``,
and the host-side plans of the sorted sum's and ``ln_matmul``'s launchers.

On the CPU the port's ``sorted_segment_sum`` runs its plain version; the
JAX package's kernel runs in Pallas interpret mode.  The same numpy rows
(d = 128, the JAX gate's lane width) go to both.  Tolerance: f32 sums of
the same rows in another order, rounded once to bf16, may round the other
way: one bf16 ulp of the largest magnitude (2^-7 x max |ref|); f32 sums at
1e-5 of the largest magnitude.  The card runs the same layouts through the
CUDA kernel (``tests/test_torch_cuda.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_segment_layouts.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops.kernels import ln_linear as pt_ll
from graphnets_tpu_torch.ops.kernels import segment_sum as pt_ss
from segment_layouts import LAYOUTS, layout

D = 128
_DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
       "f32": (torch.float32, jnp.float32)}


@pytest.fixture
def interpret_mode():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    enable_pallas(True, interpret=True)
    yield
    enable_pallas(old[0], interpret=old[1])


@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sorted_segment_sum_layout_matches_pallas(interpret_mode, name,
                                                  dtype):
    from graphnets_tpu.ops.pallas.segment_sum import (
        sorted_segment_sum, supports_sorted_segment_sum)
    tdt, jdt = _DT[dtype]
    ids, S = layout(name)
    assert supports_sorted_segment_sum(ids.size, S, D)
    x = np.random.default_rng(5).normal(size=(ids.size, D)).astype(
        np.float32)
    ref = np.asarray(sorted_segment_sum(jnp.asarray(x, jdt),
                                        jnp.asarray(ids), S), np.float32)
    before = pt_ss.LAUNCHES
    out = pt_ss.sorted_segment_sum(torch.from_numpy(x).to(tdt),
                                   torch.from_numpy(ids), S)
    assert pt_ss.LAUNCHES == before  # CPU tensors never launch
    assert out.dtype == tdt and tuple(out.shape) == (S, D)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= (2.0 ** -7 if dtype == "bf16" else 1e-5) * np.abs(ref).max()
    # Segments without a row (gaps, and past the last id) are zeros.
    valid = ids[(ids >= 0) & (ids < S)]
    empty = np.setdiff1d(np.arange(S), valid)
    assert not out[torch.from_numpy(empty)].float().any()


def _kernel_slabs(dim, bf16):
    """Column slabs of the CUDA kernel (``csrc/segment_sum.cu``): 16-byte
    vectors (4 values: f32, or bf16 with dim % 8 != 0; else 8), 32 of them
    a slab, or 64 where a row has more than 32."""
    vec = 8 if bf16 and dim % 8 == 0 else 4
    per = 64 if dim // vec > 32 else 32
    return -(-(dim // vec) // per)


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("E", [0, 1, 128, 1000, 16384, 56320, 1 << 20,
                               (1 << 22) + 8])
@pytest.mark.parametrize("dim,dtype", [(384, torch.bfloat16),
                                       (384, torch.float32),
                                       (256, torch.bfloat16),
                                       (12, torch.bfloat16)])
def test_sorted_plan_covers_every_row_once(E, sms, dim, dtype):
    """Chunks of 64 x 2^k rows (a multiple of the kernel's 8 warps, at most
    the 2048 ids it stages) tile the rows once, at most two blocks (chunks
    x slabs) an SM unless the chunk is at its largest."""
    rows, chunks, slabs = pt_ss.sorted_plan(E, dim, dtype, sms)
    assert slabs == _kernel_slabs(dim, dtype == torch.bfloat16)
    assert rows % 8 == 0 and 64 <= rows <= 2048
    assert rows & (rows - 1) == 0
    assert chunks >= 1 and (chunks - 1) * rows < max(E, 1) <= chunks * rows
    assert chunks * slabs <= 2 * sms or rows == 2048
    if rows > 64:  # the smallest chunk that gives at most two an SM
        assert -(-E // (rows // 2)) * slabs > 2 * sms


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sorted_plan_scratch_holds_the_worst_layout(dtype):
    """Each chunk leaves at most two partial rows (its first and its last
    run), so ``2 * chunks`` rows of scratch hold any layout; the counters
    and spans are sized by the plan's ``slabs`` a segment, the kernel's
    column slabs at every width it takes (d % 4 == 0)."""
    bf16 = dtype == torch.bfloat16
    for dim in range(4, 4100, 4):
        _, _, slabs = pt_ss.sorted_plan(16384, dim, dtype)
        assert _kernel_slabs(dim, bf16) == slabs
    # The partial rows a layout needs: a chunk's first run if it continues
    # from the chunk before, its last run if it continues into the next.
    for name in LAYOUTS:
        ids, _ = layout(name)
        rows, chunks, _ = pt_ss.sorted_plan(ids.size, D, dtype, 8)
        starts = np.arange(chunks) * rows
        ends = np.minimum(starts + rows, ids.size) - 1
        into_next = np.zeros(chunks, bool)
        into_next[:-1] = ids[ends[:-1]] == ids[starts[1:]]
        from_prev = np.zeros(chunks, bool)
        from_prev[1:] = into_next[:-1]
        single = ids[starts] == ids[ends]
        needed = (from_prev | (single & into_next)).sum() + (
            into_next & ~single).sum()
        assert needed <= 2 * chunks


@pytest.mark.parametrize("T,dout", [(512, 384), (16384, 384), (16384, 640),
                                    (264, 128), (8, 5248), (1000, 1792)])
@pytest.mark.parametrize("sms", [132, 114])
def test_ln_matmul_f32_plan(T, dout, sms):
    """Every row and column falls in one tile; 32 x 128 tiles where they
    give each SM a block, else 16 x 64; the sort task's shape (A: T = 512,
    dout = 384) gets at least a block an SM."""
    rows, cols, blocks = pt_ll.f32_plan(T, dout, sms)
    assert (rows, cols) in ((32, 128), (16, 64))
    assert dout % cols == 0
    assert blocks == -(-T // rows) * (dout // cols)
    assert (-(-T // rows) - 1) * rows < T <= -(-T // rows) * rows
    if (rows, cols) == (16, 64):
        assert -(-T // 32) * (dout // 128) < sms
    if (T, dout) == (512, 384):
        assert blocks >= sms
