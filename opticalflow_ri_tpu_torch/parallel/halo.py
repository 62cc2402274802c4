"""Halo exchange and reductions for spatially sharded stencils (port of
``parallel/halo.py``).

Every stencil iteration on a rank's tile needs an apron of its neighbours'
rows and columns.  ``exchange_halo`` pads the tile with real neighbour data
moved between the ranks of the mesh axis's process group; tiles on the
image's border synthesise their apron from the solver's border rule instead
(mirror / symmetric / nearest / constant, ops/padding.py).  Per-tile padding
alone would change the numerics (global mirror != per-tile mirror), so
interior tile edges always carry real neighbour data.

Transport, chosen by the group's backend:

  * NCCL: the slabs go rank to rank, ``batch_isend_irecv`` on the axis's
    group, device to device;
  * gloo with CPU tensors: the same calls on the tensors themselves;
  * gloo with CUDA tensors: gloo moves CPU tensors only, so the send slabs
    are copied to host memory, exchanged there, and the received slabs
    copied back to the tile's device.  This is what lets several ranks share
    one GPU (NCCL refuses two ranks on one device).  It is chosen up front
    from the backend, never as a retry after a failure.

``reduce_over`` all-reduces a tensor over mesh axes with the same staging
rule (the sharded solvers' error norms and image maxima: JAX's psum and
pmax).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from opticalflow_ri_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

_MODES = ("mirror", "symmetric", "nearest", "constant")


def _staged(group, t: torch.Tensor) -> bool:
    """True where ``t`` must pass through host memory: a CUDA tensor on a
    gloo group.  A CPU tensor on an NCCL group cannot move at all."""
    backend = dist.get_backend(group)
    if t.device.type == "cuda":
        return backend == "gloo"
    if backend == "nccl":
        raise ValueError("an NCCL group moves CUDA tensors only; this tile is on the CPU")
    return False


def _boundary_block(x, n, side, axis, mode):
    """Apron of width ``n`` on ``side`` ('lo'/'hi') of ``axis`` per border rule."""
    size = x.shape[axis]
    if mode == "mirror":
        start = 1 if side == "lo" else size - n - 1
        return x.narrow(axis, start, n).flip(axis)
    if mode == "symmetric":
        start = 0 if side == "lo" else size - n
        return x.narrow(axis, start, n).flip(axis)
    if mode == "nearest":
        edge = x.narrow(axis, 0 if side == "lo" else size - 1, 1)
        reps = [1] * x.ndim
        reps[axis] = n
        return edge.repeat(*reps)
    shape = list(x.shape)
    shape[axis] = n
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def _send_recv(group, sends: dict, recvs: dict) -> dict:
    """Post the sends ({group rank: tensor}) and receives ({group rank:
    (shape, like)}) on ``group`` in one batch and wait; returns the received
    tensors on the device of ``like``."""
    if not sends and not recvs:
        return {}
    like = next(iter(sends.values())) if sends else next(iter(recvs.values()))[1]
    host = _staged(group, like)
    ops, out = [], {}
    for peer, t in sends.items():
        t = t.to("cpu") if host else t.contiguous()
        ops.append(dist.P2POp(dist.isend, t, peer=dist.get_global_rank(group, peer),
                              group=group))
    for peer, (shape, ref) in recvs.items():
        out[peer] = torch.empty(shape, dtype=ref.dtype, device="cpu" if host else ref.device)
        ops.append(dist.P2POp(dist.irecv, out[peer], peer=dist.get_global_rank(group, peer),
                              group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        out = {peer: t.to(recvs[peer][1].device) for peer, t in out.items()}
    return out


def _exchange_axis(x, lo, hi, mesh, mesh_axis, axis, mode):
    """Pad ``axis`` of the local tile with (lo, hi) halo widths along mesh
    axis ``mesh_axis``."""
    if lo == 0 and hi == 0:
        return x
    size = x.shape[axis]
    if lo > size or hi > size:
        raise ValueError(f"halo ({lo}, {hi}) is wider than the tile's {size} cells")
    p = axis_size(mesh, mesh_axis)
    me = axis_index(mesh, mesh_axis)
    sends, recvs = {}, {}
    if lo and me < p - 1:   # my last rows -> the next rank's top apron
        sends[me + 1] = x.narrow(axis, size - lo, lo)
    if hi and me > 0:       # my first rows -> the previous rank's bottom apron
        sends[me - 1] = x.narrow(axis, 0, hi)
    shape = list(x.shape)
    if lo and me > 0:
        recvs[me - 1] = (tuple(shape[:axis] + [lo] + shape[axis + 1:]), x)
    if hi and me < p - 1:
        recvs[me + 1] = (tuple(shape[:axis] + [hi] + shape[axis + 1:]), x)
    got = _send_recv(axis_group(mesh, mesh_axis), sends, recvs) if p > 1 else {}
    parts = []
    if lo:
        parts.append(_boundary_block(x, lo, "lo", axis, mode) if me == 0 else got[me - 1])
    parts.append(x)
    if hi:
        parts.append(_boundary_block(x, hi, "hi", axis, mode) if me == p - 1 else got[me + 1])
    return torch.cat(parts, dim=axis)


def exchange_halo(x, halo, mode, mesh, axis_y: str = "y", axis_x: str = "x"):
    """Pad the trailing two dims of local tile ``x`` with neighbour halos.

    ``halo`` is an int (all four sides) or ((top, bottom), (left, right)).
    The y pass runs first, then the x pass on the y-padded tile, so the
    corners hold the diagonal neighbours' cells.  Every rank of the axes'
    groups calls it with the same widths; a width wider than the tile raises
    (the apron would have to come from beyond the neighbour).  Counted in
    ``exchange_halo.exchanges``."""
    if mode not in _MODES:
        raise ValueError(f"unknown boundary mode {mode!r}")
    if isinstance(halo, int):
        (t, b), (l, r) = (halo, halo), (halo, halo)
    else:
        (t, b), (l, r) = halo
    if mode == "mirror" and (max(t, b) >= x.shape[-2] or max(l, r) >= x.shape[-1]):
        raise ValueError(f"a mirror halo {halo} needs a tile wider than it, got {tuple(x.shape)}")
    exchange_halo.exchanges += 1
    out = _exchange_axis(x, t, b, mesh, axis_y, x.ndim - 2, mode)
    return _exchange_axis(out, l, r, mesh, axis_x, x.ndim - 1, mode)


exchange_halo.exchanges = 0


def reduce_over(t: torch.Tensor, mesh, axes=("y", "x"), op: str = "sum") -> torch.Tensor:
    """``t`` all-reduced ("sum" or "max") over the ranks of the mesh ``axes``:
    one all-reduce per axis, so every rank ends with the same value."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = t.clone()
    for axis in axes:
        if axis_size(mesh, axis) == 1:
            continue
        group = axis_group(mesh, axis)
        if _staged(group, out):
            host = out.to("cpu")
            dist.all_reduce(host, op=red, group=group)
            out = host.to(t.device)
        else:
            dist.all_reduce(out, op=red, group=group)
    return out
