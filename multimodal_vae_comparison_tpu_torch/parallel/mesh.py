"""Device mesh and batch placement (counterpart of ``parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets XLA
place the data; here each device is a rank of a ``torch.distributed``
process group (started by ``parallel/launch.py``), and a mesh is a
``DeviceMesh`` over the group's ranks.  The rules are the reference's:

* the default mesh puts every rank on its first axis, ``("data",)``;
* a batch is sharded on dim 0 over the data axis: rank ``r`` of ``N`` holds
  the contiguous rows ``[r B/N, (r+1) B/N)``, which is what ``P("data")``
  gives device ``r``;
* parameters are replicated: every rank holds rank 0's.

Every function here needs an initialized process group.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

if TYPE_CHECKING:   # DTensor's modules load where a mesh is made
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate


def make_mesh(num_devices: Optional[int] = None, axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over the process group's ``num_devices`` ranks (default: all
    of them).

    :param axes: mesh axis names, default 1-D data-parallel
    :param shape: explicit per-axis sizes; default puts everything on axes[0]
    :param device_type: the ranks' device type, default ``cuda`` where there
        is a card
    """
    world = dist.get_world_size()
    n = num_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a process group of {n} "
                         f"ranks; this one has {world}")
    if shape is None:
        shape = [n] + [1] * (len(axes) - 1)
    if int(np.prod(shape)) != n or len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} over axes {tuple(axes)} does not "
                         f"hold {n} devices")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> Tuple[int, int]:
    """(this rank's coordinate on ``axis``, the axis's size): the block of
    dim 0 that the rank holds."""
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def replicated(mesh: DeviceMesh) -> List[Replicate]:
    """The placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def local_rows(x, index: int, size: int, dim: int = 0):
    """Block ``index`` of ``size`` equal blocks of ``x`` along ``dim`` (a
    tensor or a numpy array); ``x.shape[dim]`` must divide by ``size``."""
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"{n} rows do not split into {size} equal blocks")
    b = n // size
    sl = (slice(None),) * dim + (slice(index * b, (index + 1) * b),)
    return x[sl]


def shard_batch(batch, mesh: DeviceMesh, axis: str = "data"):
    """This rank's block of a host or device batch ``{mod: {"data", "masks"}}``,
    batch-dim sharded over ``axis``."""
    index, size = batch_sharding(mesh, axis)
    return {name: {k: None if v is None else local_rows(v, index, size)
                   for k, v in mod.items()}
            for name, mod in batch.items()}


@torch.no_grad()
def shard_params(module: torch.nn.Module) -> torch.nn.Module:
    """Replicate ``module``'s parameters and buffers across the ranks of the
    process group (a mesh spans all of them): every rank takes rank 0's."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module
