"""Device meshes for (batch, y, x) decompositions (port of ``parallel/mesh.py``).

The JAX package holds every device of a mesh in one process.  The port runs
one process per GPU: the ranks of a ``torch.distributed`` process group (NCCL
on the card, gloo on the CPU) form a ``DeviceMesh`` with the axes
("batch", "y", "x"), and each rank holds its own tile.  ``axis_size``,
``axis_index`` and ``axis_group`` read one named axis of such a mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("batch", "y", "x")


def mesh_shape_for(n_devices: int, batch: int = 1) -> tuple:
    """Factor ``n_devices`` into a (batch, y, x) mesh shape.  The spatial part
    is kept as square as possible so halo perimeter (ICI traffic) is minimal."""
    assert n_devices % batch == 0, (n_devices, batch)
    spatial = n_devices // batch
    y = int(np.sqrt(spatial))
    while spatial % y != 0:
        y -= 1
    return (batch, y, spatial // y)


def make_mesh(n: int | None = None, batch: int = 1, device_type: str | None = None,
              shape: tuple | None = None) -> DeviceMesh:
    """A ("batch", "y", "x") ``DeviceMesh`` over the ranks of the default
    process group, shaped ``mesh_shape_for(n, batch)`` (or ``shape``).

    ``n`` defaults to the world size and must equal it: every rank of the
    group is a device of the mesh.  ``device_type`` is "cuda" unless the
    caller asks for "cpu".  Every rank calls this, in the same order (the
    mesh creates one process group per axis and coordinate)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call parallel.distributed."
                           "initialize() first")
    world = dist.get_world_size()
    n = world if n is None else int(n)
    if n != world:
        raise ValueError(f"a mesh spans every rank of the group: n={n}, world size {world}")
    shape = tuple(shape) if shape is not None else mesh_shape_for(n, batch)
    if len(shape) != 3 or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not hold the {world} ranks")
    ranks = torch.arange(world, dtype=torch.int).reshape(shape)
    return DeviceMesh(device_type or "cuda", ranks, mesh_dim_names=AXES)


# (id(mesh), axis) -> (mesh, size, index, group).  DeviceMesh works its shape
# out from its layout at every call (~50 us on the H100 machine's torch,
# scripts/torch_parallel_profile.py), and a halo exchange asks several times;
# the entry holds the mesh, so its id is not reused while the entry lives.
_AXES_SEEN: dict = {}


def _axis(mesh: DeviceMesh, axis: str) -> tuple:
    hit = _AXES_SEEN.get((id(mesh), axis))
    if hit is None:
        size = int(mesh.shape[mesh.mesh_dim_names.index(axis)])
        hit = (mesh, size, int(mesh.get_local_rank(axis)), mesh.get_group(axis))
        _AXES_SEEN[(id(mesh), axis)] = hit
    return hit


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` ("batch", "y" or "x")."""
    return _axis(mesh, axis)[1]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return _axis(mesh, axis)[2]


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that share this rank's coordinates on
    the other axes: its neighbours along ``axis``."""
    return _axis(mesh, axis)[3]
