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

``refresh_apron`` is the exchange of an iterated field that stays padded
from one kernel launch to the next: it writes the neighbours' slabs
straight into the apron of the padded buffer, y rows first, then x columns
over the full padded height so that the corners arrive, and moves nothing
else.

Staging through host memory cannot be captured in a CUDA graph:
``_send_recv``, ``gather_axis`` and ``reduce_over`` raise when asked to
stage while the current stream is capturing (``utils.device.capturing``).

``reduce_over`` all-reduces a tensor over mesh axes with the same staging
rule (the sharded solvers' error norms and image maxima: JAX's psum and
pmax).  ``gather_axis`` all-gathers the tiles along one mesh axis (the
dense spline upsample, and the rows-only solvers' stripes on a mesh with
x > 1: what GSPMD does for JAX's ``in_specs=P("y", None)``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from opticalflow_ri_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
from opticalflow_ri_tpu_torch.utils.device import capturing

_MODES = ("mirror", "symmetric", "nearest", "constant")


def _staged(group, t: torch.Tensor) -> bool:
    """True where ``t`` must pass through host memory: a CUDA tensor on a
    gloo group.  A CPU tensor on an NCCL group cannot move at all, and
    nothing can be staged while a CUDA graph is being captured."""
    backend = dist.get_backend(group)
    if t.device.type == "cuda":
        if backend == "gloo" and capturing():
            raise RuntimeError("a gloo group stages CUDA tiles through host memory, which a "
                               "CUDA graph capture cannot hold: capture on an NCCL group")
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


def _send_recv_into(group, sends: dict, targets: dict) -> None:
    """Post the sends ({group rank: tensor}) and receives ({group rank:
    tensor written in place}) on ``group`` in one batch and wait.  A
    target that is contiguous on a group that moves it directly receives
    in place; any other (a strided view, a staged tile) receives into a
    buffer of its own size that is then copied in."""
    if not sends and not targets:
        return
    like = next(iter(sends.values())) if sends else next(iter(targets.values()))
    host = _staged(group, like)
    ops, staged = [], {}
    for peer, t in sends.items():
        t = t.to("cpu") if host else t.contiguous()
        ops.append(dist.P2POp(dist.isend, t, peer=dist.get_global_rank(group, peer),
                              group=group))
    for peer, dst in targets.items():
        buf = dst
        if host or not dst.is_contiguous():
            buf = staged[peer] = torch.empty(dst.shape, dtype=dst.dtype,
                                             device="cpu" if host else dst.device)
        ops.append(dist.P2POp(dist.irecv, buf, peer=dist.get_global_rank(group, peer),
                              group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for peer, buf in staged.items():
        targets[peer].copy_(buf)


def _send_recv(group, sends: dict, recvs: dict) -> dict:
    """``_send_recv_into`` with receives given as ({group rank: (shape,
    like)}); returns the received tensors, new, on the device of ``like``."""
    out = {peer: torch.empty(shape, dtype=ref.dtype, device=ref.device)
           for peer, (shape, ref) in recvs.items()}
    _send_recv_into(group, sends, out)
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


def refresh_apron(zp: torch.Tensor, t: int, mesh, apron, axes=("y", "x")) -> None:
    """Write the neighbours' data into the apron of ``zp`` in place.

    ``zp`` is a tile padded as ``sharded_kernel._pad_interior`` pads it:
    ``t`` cells of the neighbour's data on each interior side (``apron``:
    the (top, bottom, left, right) flags) and nothing on the image's border
    sides; x takes part only where it is in ``axes``.  The y pass sends the
    rank's first and last ``t`` owned rows over its owned columns and
    writes the received ones above and below them; the x pass then sends
    its first and last ``t`` owned columns over the full padded height, y
    apron included, so that the corners hold the diagonal neighbours'
    cells: the apron ``_pad_interior`` would build from the owned cells,
    bit for bit.  Only the slabs move; the owned cells are read, never
    written.  Every rank of the axes' groups calls it with the same
    ``t``.  Counted in ``exchange_halo.exchanges``, one a call."""
    exchange_halo.exchanges += 1
    top, bot, left, right = apron
    tx = t if "x" in axes else 0
    r0, c0 = (t if top else 0), (tx if left else 0)
    h = zp.shape[-2] - r0 - (t if bot else 0)
    w = zp.shape[-1] - c0 - (tx if right else 0)
    if t > h or tx > w:
        raise ValueError(f"an apron of {t} is wider than the tile's ({h}, {w}) owned cells")
    passes = [("y", zp.ndim - 2, r0, h, t, (top, bot), zp.narrow(-1, c0, w))]
    if "x" in axes:
        passes.append(("x", zp.ndim - 1, c0, w, tx, (left, right), zp))
    for mesh_axis, dim, start, size, n, (lo, hi), view in passes:
        if not (lo or hi):
            continue
        me = axis_index(mesh, mesh_axis)
        sends, targets = {}, {}
        if lo:   # my first owned cells -> the previous rank; its last -> my lo apron
            sends[me - 1] = view.narrow(dim, start, n)
            targets[me - 1] = view.narrow(dim, start - n, n)
        if hi:   # my last owned cells -> the next rank; its first -> my hi apron
            sends[me + 1] = view.narrow(dim, start + size - n, n)
            targets[me + 1] = view.narrow(dim, start + size, n)
        _send_recv_into(axis_group(mesh, mesh_axis), sends, targets)


def gather_axis(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The tiles of this rank's group along mesh ``axis`` concatenated along
    ``dim`` of ``x``, in the group's rank order: every rank of the group
    ends with the same tensor.  Every rank calls it with a tile of the same
    shape.  NCCL gathers device to device (``all_gather_into_tensor``);
    gloo moves the tiles through host memory when they lie on the card, as
    ``_send_recv`` does.  Each collective is counted in
    ``gather_axis.gathers``; a one-rank axis returns ``x`` and moves
    nothing."""
    p = axis_size(mesh, axis)
    if p == 1:
        return x
    gather_axis.gathers += 1
    group = axis_group(mesh, axis)
    src = x.contiguous()
    if _staged(group, src) or src.device.type == "cpu":   # gloo (raises while capturing)
        host = src.to("cpu")
        parts = [torch.empty_like(host) for _ in range(p)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(x.device)
    out = torch.empty((p * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return torch.cat(out.chunk(p, dim=0), dim=dim)


gather_axis.gathers = 0


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
