"""Runtime switches of the PyTorch port (counterpart of
``graphnets_tpu/utils/config.py``).

``use_kernels()`` says whether the hot paths take the hand-written CUDA
kernels (``ops/kernels``).  ``None`` means "auto": on iff CUDA is available,
decided on first query.  ``GRAPHNETS_TPU_TORCH_KERNELS=0/1`` forces either
mode, as ``GRAPHNETS_TPU_PALLAS`` does for the JAX package.
``bf16_gather_partials(rows)`` is the JAX package's gate for rounding the
gathered split-linear partials to bf16 (``GRAPHNETS_TPU_TORCH_BF16_GATHER``
pins it).  ``g1_agg_fusion_training()`` says whether the single-graph edge
update keeps its fused edge->node sum under training
(``GRAPHNETS_TPU_TORCH_G1_AGG_TRAIN=0/1``).  ``use_split_linear()`` says
whether GNBlock takes the split-linear route (gather after transform) or
materialises the concatenated update inputs
(``GRAPHNETS_TPU_TORCH_SPLIT_LINEAR=0/1``, default 1, as
``GRAPHNETS_TPU_SPLIT_LINEAR`` for the JAX package).  ``debug_checks()``
says whether the host-side invariant checks run
(``GRAPHNETS_TPU_TORCH_DEBUG=1``, as ``GRAPHNETS_TPU_DEBUG`` for the JAX
package; see ``utils/debug``).  ``tracing()`` says whether the step,
capture and batch paths record their spans and the step bodies their
device phase markers (``utils/profiling.span`` / ``PhaseMarkers``;
``GRAPHNETS_TPU_TORCH_TRACE=1``, default 0).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch


@dataclasses.dataclass
class Config:
    # Route the hot paths through the CUDA kernels (the plain torch path
    # stays the numerics reference and the route for unsupported shapes).
    use_kernels: Optional[bool] = None
    # Compute GNBlock update nets as per-segment split matmuls with
    # gather-after-transform instead of materializing the concatenated
    # input (same per-row dot products; partials accumulate in f32).
    split_linear: bool = True
    # Run the backward scatter-add of row gathers as a sorted f32 segment
    # sum (the sorted / windowed kernels where their gates hold) instead of
    # autograd's ``index_add_`` in the cotangent's own type.
    sorted_scatter_grad: bool = True
    # Round the partial products of GATHERED split-linear terms to bf16
    # before the E-row gather (models/gn_block._linear_split): half the
    # bytes of the dominant streams of the non-uniform edge update, at up
    # to 3 more bf16 roundings per output element.  Only bf16 inputs are
    # affected.  None = "auto": on when the gather writes at least
    # ``bf16_gather_rows`` rows.
    bf16_gather_partials: Optional[bool] = None
    bf16_gather_rows: int = 1 << 17
    # Keep the single-graph edge update's fused edge->node sum under
    # training too (models/gn_block._edge_update_split): its backward adds a
    # sorted gather and an add, against the saved re-read of the [E, dout]
    # output.  The JAX package's default, from its measurements; off, the
    # training step takes the kernel without the sum and aggregates after.
    g1_agg_fusion_training: bool = True
    # Debug-mode invariant checks (GRAPHNETS_TPU_TORCH_DEBUG=1): batch()
    # validates its output, segment_sum(sorted_pad_safe=True) enforces
    # ascending ids and pad-targets-pad, and the sorted gather ascending
    # ids within the table.  The kernels skip masks and bounds on these
    # contracts; a violation raises instead of corrupting results.  The
    # checks read tensors on the host, so a CUDA-graph capture refuses to
    # run while they are on (training/train.CapturedStep).
    debug_checks: bool = False
    # Spans and device phase markers (GRAPHNETS_TPU_TORCH_TRACE=1): the
    # step, capture and batch paths open named host ranges
    # (utils/profiling.span) and the step bodies enqueue a phase marker
    # at each phase boundary (utils/profiling.PhaseMarkers).  A field of
    # this dataclass, so it is part of CapturedStep's key: a graph
    # captured with it on holds the markers, one captured with it off
    # holds nothing of them.
    trace: bool = False


def _env_tristate(name: str) -> Optional[bool]:
    v = os.environ.get(name, "auto").lower()
    if v in ("auto", ""):
        return None
    return v == "1"


_config = Config(
    use_kernels=_env_tristate("GRAPHNETS_TPU_TORCH_KERNELS"),
    bf16_gather_partials=_env_tristate("GRAPHNETS_TPU_TORCH_BF16_GATHER"),
    split_linear=os.environ.get("GRAPHNETS_TPU_TORCH_SPLIT_LINEAR",
                                "1") == "1",
    g1_agg_fusion_training=os.environ.get(
        "GRAPHNETS_TPU_TORCH_G1_AGG_TRAIN", "1") == "1",
    debug_checks=os.environ.get("GRAPHNETS_TPU_TORCH_DEBUG", "0") == "1",
    trace=os.environ.get("GRAPHNETS_TPU_TORCH_TRACE", "0") == "1")


def get_config() -> Config:
    return _config


def use_kernels() -> bool:
    if _config.use_kernels is None:
        _config.use_kernels = torch.cuda.is_available()
    return _config.use_kernels


def enable_kernels(flag: bool = True) -> None:
    _config.use_kernels = flag


def use_split_linear() -> bool:
    return _config.split_linear


_bf16_gate_logged = False


def bf16_gather_partials(rows: int) -> bool:
    """Whether a gathered partial of ``rows`` output rows rounds to bf16."""
    if _config.bf16_gather_partials is not None:
        return _config.bf16_gather_partials
    on = rows >= _config.bf16_gather_rows
    global _bf16_gate_logged
    if on and not _bf16_gate_logged:
        # The auto gate keys on the padded row count, so two runs of one
        # model with other padding can round differently: say so once.
        _bf16_gate_logged = True
        logging.getLogger("graphnets_tpu_torch").info(
            "bf16_gather_partials auto-enabled (gather rows %d >= %d): "
            "split-linear partials round to bf16 before the edge gather; "
            "set GRAPHNETS_TPU_TORCH_BF16_GATHER=0/1 to pin.",
            rows, _config.bf16_gather_rows)
    return on


def g1_agg_fusion_training() -> bool:
    return _config.g1_agg_fusion_training


def debug_checks() -> bool:
    return _config.debug_checks


def enable_debug_checks(flag: bool = True) -> None:
    _config.debug_checks = flag


def tracing() -> bool:
    return _config.trace


def enable_tracing(flag: bool = True) -> None:
    _config.trace = flag


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU: ``None`` means ``cuda``, and a CUDA request without a card
    raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "graphnets_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return dev
