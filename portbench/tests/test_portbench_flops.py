"""The FLOP and byte counts agree with hand counts at small shapes."""

import pytest

from metrics import ffn_roofline_share as ffn
from models import gn

PEAKS = {"bfloat16": 1e12, "float32": 1e11, "bytes_per_s": 1e9}


def test_core_stack_flops_by_hand():
    # One core at d = 2 on E = 3 edges, N = 2 nodes, G = 1 graph.
    model = {"core_dims": [2, 2, 2], "n_cores": 1}
    E, N, G, d = 3, 2, 1, 2
    edge = 2 * (E * d * d + 2 * N * d * d + G * d * d)
    node = 2 * (N * d * d + N * d * d + G * d * d)
    graph = 2 * (G * 3 * d * d)
    ffn_f = 2 * 2 * (E + N + G) * d * 4 * d
    assert gn.step_flops(model, (E, N, G)) == 3 * (edge + node + graph
                                                   + ffn_f)


def test_encode_process_decode_flops_by_hand():
    # Encoder (0, 3, 0) -> (2, 2, 2), no core, decoder (2, 2, 2) -> (1, 1, 0)
    model = {"x_dims": [0, 3, 0], "core_dims": [2, 2, 2],
             "y_dims": [1, 1, 0], "n_cores": 0}
    E, N, G = 4, 2, 1
    enc = 2 * (2 * N * 3 * 2          # senders' and receivers' terms
               + (N * 2 + N * 3) * 2  # node update: agg and nf
               + G * (2 + 2) * 2)     # graph update
    dec = 2 * ((E * 2 + 2 * N * 2 + G * 2) * 1
               + (N * 1 + N * 2 + G * 2) * 1
               + 0)
    assert gn.step_flops(model, (E, N, G)) == 3 * (enc + dec)


def test_ffn_work_by_hand():
    (ff, fb), (bf, bb) = ffn.work(rows=10, d=4, itemsize=2)
    assert ff == 2 * 10 * 4 * 16 * 2
    assert bf == 2 * ff
    assert fb == 3 * 10 * 4 * 2 + 2 * 4 * 16 * 2
    assert bb == 3 * 10 * 4 * 2 + 2 * 4 * 16 * 2 + 2 * 4 * 16 * 4


def test_ffn_bound_takes_the_larger_side():
    # d = 4, two cores, 10 rows in one set and none in the other two:
    # every term is byte-bound at these peaks, and an empty set still
    # reads its weights (8 d^2 bf16) and writes their f32 gradients.
    (ff, fb), (bf, bb) = ffn.work(10, 4, 2)
    weights = 8 * 4 * 4
    empty = weights * 2 + (weights * 2 + weights * 4)
    got = ffn.bound_s([10, 0, 0], [4, 4, 4], 2, 2, PEAKS, "bfloat16")
    assert got == pytest.approx(2 * (fb + bb + 2 * empty)
                                / PEAKS["bytes_per_s"])
    compute = {**PEAKS, "bytes_per_s": 1e30}
    assert ffn.bound_s([10, 0, 0], [4, 4, 4], 2, 2, compute, "bfloat16") \
        == pytest.approx(2 * (ff + bf) / PEAKS["bfloat16"])
