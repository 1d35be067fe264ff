"""Build cache and warm-up (counterpart of ``graphnets_tpu/utils/warmup.py``).

JAX pays its compile latency at the first trace and keeps compiled
executables in a persistent cache.  The port's compiled code is its kernel
libraries (``nvcc``, ``ops/kernels/_build``) and its native runtime
(``g++``, ``runtime/native``): both are built on first use into one
directory and kept there, keyed by a hash of their sources and flags, so a
later process reuses them.  :func:`warmup` builds them all ahead of the
first step and runs a ``GNBlock`` and a ``GNCore`` forward at tiny shapes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels import _build
from ..runtime import native
from .config import resolve_device

__all__ = ["enable_compilation_cache", "warmup"]


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    """The directory that holds the built kernel libraries and the native
    runtime (``build/`` at the root of the checkout unless ``cache_dir``
    moves both there).  Idempotent."""
    if cache_dir is not None:
        _build.BUILD_DIR = native.BUILD_DIR = Path(cache_dir)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return str(_build.BUILD_DIR)


def warmup(dims: Tuple[int, int, int] = (16, 16, 16), n_cores: int = 1,
           device=None) -> None:
    """Build every kernel library (on a CUDA device; all ``nvcc`` runs at
    once) and the native runtime, then run a ``GNBlock`` and ``n_cores``
    ``GNCore`` forward on a tiny padded batch of two graphs on ``device``
    (``cuda`` unless the caller passes another), so that the first real
    step pays none of it."""
    from ..graph import PadSpec, batch
    from ..models.gn_block import GNBlock
    from ..models.gn_core import GNCore, GNCoreList

    device = resolve_device(device)
    if device.type == "cuda":
        _build.build()
    native.available()
    adj = np.array([[1, 0], [1, 1]])
    de, dn, dg = dims
    rng = np.random.default_rng(0)
    x = batch({
        "graphs": [adj, adj],
        "ef": [rng.normal(size=(3, de)).astype(np.float32)] * 2,
        "nf": [rng.normal(size=(2, dn)).astype(np.float32)] * 2,
        "gf": np.zeros((2, dg), np.float32),
    }, pad=PadSpec(8, 8, 3), device=device)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        GNBlock(dims, dims, device=device, generator=gen)(x)
        GNCoreList([GNCore(dims, device=device, generator=gen)
                    for _ in range(n_cores)])(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
