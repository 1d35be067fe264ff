"""Runtime switches of the PyTorch port (counterpart of
``graphnets_tpu/utils/config.py``).

``use_kernels()`` says whether the hot paths take the hand-written CUDA
kernels (``ops/kernels``).  ``None`` means "auto": on iff CUDA is available,
decided on first query.  ``GRAPHNETS_TPU_TORCH_KERNELS=0/1`` forces either
mode, as ``GRAPHNETS_TPU_PALLAS`` does for the JAX package.
"""

from __future__ import annotations

import dataclasses
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


def _env_kernels() -> Optional[bool]:
    v = os.environ.get("GRAPHNETS_TPU_TORCH_KERNELS", "auto").lower()
    if v in ("auto", ""):
        return None
    return v == "1"


_config = Config(use_kernels=_env_kernels())


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
