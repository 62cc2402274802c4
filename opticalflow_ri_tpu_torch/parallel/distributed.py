"""Process-group setup and tile placement (port of ``parallel/distributed.py``).

The JAX package initialises ``jax.distributed`` and builds global arrays from
per-host shards.  The port runs one process per GPU, each holding its own
tile, so a "global array" is the set of the ranks' tiles:

    from opticalflow_ri_tpu_torch.parallel import distributed as dist
    dist.initialize()                      # torchrun's environment, NCCL
    mesh = dist.global_mesh(batch=1)
    a, b = dist.shard_batch_global(mesh, my_im1, my_im2,
                                   global_shape=(B, H, W))
    u, v, err = batched_hs_pipeline(mesh, a, b)      # this rank's tiles

``local_slices`` says which part of a global array a rank holds under a
partition spec (one mesh axis name, or None, per array dimension), and
``gather_global`` assembles the tiles on rank 0.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from opticalflow_ri_tpu_torch.parallel.mesh import AXES, axis_index, axis_size, make_mesh

SPEC_BATCH = ("batch", "y", "x")   # a (B, H, W) stack: pairs over 'batch', tiles over (y, x)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device: str = "cuda") -> None:
    """Join the default process group; a second call is a no-op.

    With no arguments it reads torchrun's environment (``env://``: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  ``device="cuda"`` (the default)
    needs a GPU: it raises without one, sets this rank's device (LOCAL_RANK,
    else the rank, modulo the devices) and takes NCCL unless ``backend``
    asks for gloo (then halos move through host memory, see ``halo.py``).
    ``device="cpu"`` takes gloo."""
    if dist.is_initialized():
        return
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    if world_size is None or rank is None:
        raise ValueError("initialize(init_method=...) needs world_size and rank")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): this rank finds no CUDA device")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
        torch.cuda.init()
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend == "nccl" and device != "cuda":
        raise ValueError("the NCCL backend needs device='cuda'")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))


def global_mesh(batch: int = 1, device_type: str | None = None):
    """("batch", "y", "x") mesh over every rank of the group."""
    return make_mesh(dist.get_world_size(), batch=batch, device_type=device_type)


def _mesh_device(mesh) -> torch.device:
    """The device this rank's tiles live on under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_slices(mesh, global_shape, spec) -> tuple:
    """This rank's slice of each dimension of an array of ``global_shape``
    partitioned by ``spec`` (a mesh axis name or None per dimension): the
    dimension split evenly over that axis's ranks, or whole."""
    if len(spec) != len(global_shape):
        raise ValueError(f"spec {spec} does not match shape {tuple(global_shape)}")
    out = []
    for n, axis in zip(global_shape, spec):
        if axis is None:
            out.append(slice(0, n))
            continue
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        parts = axis_size(mesh, axis)
        if n % parts:
            raise ValueError(f"dimension {n} does not split over the {parts} ranks of {axis!r}")
        step = n // parts
        i = axis_index(mesh, axis)
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def _global_shape_of(mesh, local_shape, spec) -> tuple:
    return tuple(n * (axis_size(mesh, a) if a is not None else 1)
                 for n, a in zip(local_shape, spec))


def shard_batch_global(mesh, *host_local_arrays, global_shape=None, spec=SPEC_BATCH):
    """Each rank's block of a global (B, H, W) array, checked and put on the
    rank's device as float32.

    ``global_shape`` defaults to the blocks' shape times the mesh axes; every
    rank's block must then have one shape.  Given, each rank's block must be
    its ``local_slices`` of it.  The ranks' shapes are compared with one
    ``all_gather_object``; a mismatch raises on every rank."""
    dev = _mesh_device(mesh)
    shapes = [tuple(np.shape(a)) for a in host_local_arrays]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, shapes)
    out = []
    for i, arr in enumerate(host_local_arrays):
        want = (global_shape if global_shape is not None
                else _global_shape_of(mesh, shapes[i], spec))
        local = tuple(s.stop - s.start for s in local_slices(mesh, want, spec))
        bad = [r for r, sh in enumerate(every) if tuple(sh[i]) != local]
        if bad:  # the same list on every rank, so every rank raises
            raise ValueError(f"array {i}: ranks {bad} hold blocks {[every[r][i] for r in bad]}, "
                             f"not the {local} blocks of {tuple(want)}")
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
        out.append(t.to(device=dev, dtype=torch.float32).contiguous())
    return tuple(out)


def gather_global(mesh, tile: torch.Tensor, spec):
    """The global array of the ranks' tiles under ``spec``, on rank 0 (on the
    tile's device); None on the other ranks.  Every rank calls it.  Ranks
    that hold the same block (an axis the spec leaves whole) must agree bit
    for bit, or it raises on rank 0."""
    shape = _global_shape_of(mesh, tuple(tile.shape), spec)
    mine = (local_slices(mesh, shape, spec), tile.detach().cpu().numpy())
    every = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(mine, every, dst=0)
    if dist.get_rank() != 0:
        return None
    out = np.empty(shape, dtype=mine[1].dtype)
    seen = {}
    for slices, block in every:
        key = tuple((s.start, s.stop) for s in slices)
        if key in seen and not np.array_equal(seen[key], block, equal_nan=True):
            raise AssertionError(f"replicas of block {key} differ")
        seen[key] = block
        out[slices] = block
    return torch.from_numpy(out).to(tile.device)

