"""Device meshes over ``torch.distributed`` (counterpart of
``graphnets_tpu/parallel/mesh.py``).

JAX lays a ``Mesh`` over the devices of one program; here every rank is a
process of an initialised process group (``parallel/distributed``), and
:func:`make_mesh` lays a ``DeviceMesh`` with named dims over the world:
``make_mesh()`` is a 1-D ``"data"`` mesh of every rank, ``make_mesh((2,
2), ("data", "model"))`` a 2-D one.  A dim's process group
(``mesh.get_group(name)``) carries that axis's collectives, and a rank's
coordinate on it (``mesh.get_local_rank(name)``) picks its shard.
:func:`replicated` and :func:`sharded_leading` are the placements of
JAX's ``P()`` and ``P(axis)``, one per mesh dim, as ``DTensor`` takes
them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

from ..utils.config import resolve_device

__all__ = ["make_mesh", "replicated", "sharded_leading", "DeviceMesh",
           "Replicate", "Shard"]


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_sizes`` (default: the world size) named
    ``axis_names`` over the initialised world, rank ``r`` at the
    row-major position ``r``.  ``device_type`` is ``"cuda"`` unless the
    caller asks for ``"cpu"``.  The product of the sizes must equal the
    world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(parallel.distributed.init_distributed)")
    world = dist.get_world_size()
    sizes = (world,) if axis_sizes is None else tuple(int(s)
                                                      for s in axis_sizes)
    names = tuple(axis_names)
    if len(names) != len(sizes):
        raise ValueError(f"make_mesh: {len(sizes)} axis sizes for "
                         f"{len(names)} names {names}")
    if math.prod(sizes) != world:
        raise ValueError(f"make_mesh: axes {dict(zip(names, sizes))} hold "
                         f"{math.prod(sizes)} ranks, the world has {world}")
    device_type = resolve_device(device_type).type
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def replicated(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """Every mesh dim replicates (JAX's ``P()``)."""
    return tuple(Replicate() for _ in range(mesh.ndim))


def sharded_leading(mesh: DeviceMesh, axis: str = "data"
                    ) -> Tuple[Placement, ...]:
    """The leading dimension sharded over ``axis``, the other dims
    replicated (JAX's ``P(axis)``)."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"sharded_leading: no axis {axis!r} in "
                         f"{mesh.mesh_dim_names}")
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)
