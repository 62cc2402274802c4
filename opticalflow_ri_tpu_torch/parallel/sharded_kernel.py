"""Sharded Horn-Schunck and Liu-Shen solves on the Hopper kernels, one
T-deep halo exchange per launch (port of the HS and Liu-Shen half of
``parallel/sharded_pallas.py``).

Every rank runs the single-device kernel (``ops/cuda/hs_iter.py``,
``ops/cuda/liu_shen_iter.py``) on its tile, padded by T rows and columns of
its neighbours' data on each interior side; between launches the halos move
over the mesh (``halo.exchange_halo``).  On CPU tiles the kernels' plain
versions run the same schedule.

How the border differs from the JAX package, and why.  There the tiled HS
kernel has no border logic, so the image's border sides get a T-deep mirror
ring that evolves with the tile.  The Hopper HS kernel applies the mirror as
an index rule, and a mirrored copy iterated beside the tile would not round
the same way (``csrc/hs_jacobi.cu``, "The border").  So the image's border
sides get no apron at all and keep the kernels' own rule, and the interior
sides are apron edges: the ``edges`` mask of both kernels says which is
which, and the kernel reads 0 beyond an apron edge, whose wrong values stay
within the T cells that are cropped.  The cells a rank owns then take
exactly the single-device iteration: the sharded u and v equal the
single-device port's bit for bit.

The ``*_supported`` predicates keep JAX's geometric conditions (the local
tile deeper than the T-block, no halo wider than the neighbour's tile) and
drop the TPU's 8x128 layout gates (``sharded_pallas.py:67,184``): the
port's kernels take any H, W >= 2.  This is a difference of the hardware,
not a fault.

Liu-Shen decomposes rows only, as in JAX: its tiles are whole-width stripes,
spec ("y", None); ranks along x hold replicas.  Its stop is block-granular
(``sharded_pallas.py:243-289``): each block runs T steps without the stop
(``stop=False``: the apron cells hold stale values, and an err over them
could be NaN), err of the block's last step is taken on the owned rows and
all-reduced over y, and the host reads it to decide on the next block
(counted in ``liu_shen_solve_sharded_kernel.err_reads``).  At max_iter the
result is the single-device solve's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import hs_iter, liu_shen_iter
from opticalflow_ri_tpu_torch.ops.padding import pad2d
from opticalflow_ri_tpu_torch.ops.stencil import correlate3x3_padded
from opticalflow_ri_tpu_torch.parallel import sharded as _sh
from opticalflow_ri_tpu_torch.parallel.halo import exchange_halo, reduce_over
from opticalflow_ri_tpu_torch.parallel.mesh import axis_index, axis_size

_Y_ONLY = ("y",)


def _border_sides(mesh, axes=("y", "x")) -> tuple:
    """(edges mask, (top, bottom, left, right) apron flags) of this rank's
    tile: a side is the image's border where the rank is first or last on
    its axis (always, on an axis not in ``axes``)."""
    edges, apron = 0, []
    for axis, (lo, hi) in (("y", (hs_iter.TOP, hs_iter.BOTTOM)),
                           ("x", (hs_iter.LEFT, hs_iter.RIGHT))):
        n = axis_size(mesh, axis) if axis in axes else 1
        i = axis_index(mesh, axis) if axis in axes else 0
        first, last = i == 0, i == n - 1
        edges |= (lo if first else 0) | (hi if last else 0)
        apron += [not first, not last]
    return edges, tuple(apron)


def _pad_interior(z, t, mesh, apron, axes=("y", "x")):
    """``z`` with t cells of the neighbours' data on each interior side and
    nothing on the image's border sides, contiguous for the kernel."""
    tx = t if "x" in axes else 0
    p = exchange_halo(z, ((t, t), (tx, tx)), "constant", mesh)
    top, bot, left, right = apron
    h, w = z.shape[-2], z.shape[-1]
    rows = slice(0 if top else t, t + h + (t if bot else 0))
    cols = slice(0 if left else tx, tx + w + (tx if right else 0))
    return p[..., rows, cols].contiguous()


def _crop(zp, h, w, t, apron):
    top, _, left, _ = apron
    r, c = (t if top else 0), (t if left else 0)
    return zp[..., r : r + h, c : c + w]


# ---------------------------------------------------------------------------
# Horn-Schunck
# ---------------------------------------------------------------------------

def hs_shard_kernel_supported(h_loc: int, w_loc: int, t_block: int) -> bool:
    """Can the kernel path run on an (h_loc, w_loc) local tile with T-deep
    halos?  JAX's geometric condition (``sharded_pallas.py:65``)."""
    return 1 <= t_block <= hs_iter.MAX_STEPS_PER_LAUNCH and min(h_loc, w_loc) > t_block + 1


def pick_hs_shard_t(mesh, shape) -> int | None:
    """The T-block of a kernel-sharded HS solve of the global ``shape`` on
    ``mesh``: the kernel's iterations per launch, ``hs_iter.STEPS_PER_LAUNCH``,
    where the tiles allow it; None otherwise."""
    my, mx = axis_size(mesh, "y"), axis_size(mesh, "x")
    h, w = shape[-2], shape[-1]
    if h % my or w % mx:
        return None
    t = hs_iter.STEPS_PER_LAUNCH
    return t if hs_shard_kernel_supported(h // my, w // mx, t) else None


def _hs_body_shardkernel(im1, im2, u0, v0, mesh, *, alpha, niter, t_block):
    """Per-rank body: derivatives on the local tile, then niter Jacobi
    iterations in ceil(niter / T) kernel launches (T each, the remainder
    last), one T-deep halo exchange of u and v before each."""
    fx, fy, ft = _sh._hs_derivatives_local(im1, im2, mesh)
    t = int(t_block)
    h, w = im1.shape[-2], im1.shape[-1]
    edges, apron = _border_sides(mesh)
    fxp, fyp, ftp = (_pad_interior(z, t, mesh, apron) for z in (fx, fy, ft))
    u, v = u0, v0
    done = 0
    while done < niter:
        k = min(t, niter - done)
        up, vp = hs_iter.hs_iterate(fxp, fyp, ftp, _pad_interior(u, t, mesh, apron),
                                    _pad_interior(v, t, mesh, apron), alpha, k, edges)
        u, v = _crop(up, h, w, t, apron), _crop(vp, h, w, t, apron)
        done += k
    return u.contiguous(), v.contiguous(), _sh._flow_err(u, v, u0, v0, mesh)


def hs_solve_sharded_kernel(mesh, im1, im2, alpha, niter, u0, v0, t_block: int | None = None):
    """Spatially sharded Horn-Schunck on the Hopper kernel, ("y", "x") tiles;
    the contract of sharded.hs_solve_sharded.  ``t_block`` defaults to the
    kernel's iterations per launch."""
    t = hs_iter.STEPS_PER_LAUNCH if t_block is None else int(t_block)
    h_loc, w_loc = im1.shape[-2], im1.shape[-1]
    if not hs_shard_kernel_supported(h_loc, w_loc, t):
        raise ValueError(f"hs kernel-sharded path unsupported for local tile ({h_loc}, {w_loc}), "
                         f"t_block {t}")
    im1, im2, u0, v0 = _sh._f32(im1, im2, u0, v0)
    return _hs_body_shardkernel(im1, im2, u0, v0, mesh, alpha=alpha, niter=int(niter),
                                t_block=t)


# ---------------------------------------------------------------------------
# Liu-Shen (rows-only decomposition; see the module docstring)
# ---------------------------------------------------------------------------

def ls_shard_kernel_supported(h_loc: int, w: int, t_block: int) -> bool:
    """JAX's geometric condition (``sharded_pallas.py:182``): the stripe
    deeper than the T-block; the kernel takes any width >= 2."""
    return t_block >= 1 and h_loc > t_block and w >= 2


def pick_ls_shard_t(mesh, shape) -> int | None:
    """Largest T-block of 16, 8, 4 for a rows-sharded Liu-Shen solve of the
    global ``shape`` (JAX's candidates), or None."""
    my = axis_size(mesh, "y")
    h, w = shape[-2], shape[-1]
    if h % my:
        return None
    for t in (16, 8, 4):
        if ls_shard_kernel_supported(h // my, w, t):
            return t
    return None


def _corr3_sharded_y(z, kernel, mode, mesh):
    """3x3 correlation on a whole-width stripe: y halos exchanged, x padded
    by the global rule itself."""
    zp = pad2d(exchange_halo(z, ((1, 1), (0, 0)), mode, mesh), ((0, 0), (1, 1)), mode)
    return correlate3x3_padded(zp, kernel, z.shape[-2], z.shape[-1])


def _ls_body_shardkernel(im1, im2, u0, v0, mesh, *, h_reg, max_iter, tol, t_block):
    corr = lambda z, k, mode: _corr3_sharded_y(z, k, mode, mesh)  # noqa: E731
    fields = _sh._ls_fields_local(im1, im2, h_reg, corr, mesh, _Y_ONLY)
    t = int(t_block)
    h_loc, w = im1.shape[-2], im1.shape[-1]
    edges, apron = _border_sides(mesh, _Y_ONLY)
    pad = lambda z: _pad_interior(z, t, mesh, apron, _Y_ONLY)  # noqa: E731
    fields_p = tuple(pad(f) for f in fields)
    npix = float(h_loc * axis_size(mesh, "y") * w)

    def block(u, v, k):
        """k steps from (u, v) and the err of the last, on the owned rows."""
        up, vp = pad(u), pad(v)
        if k > 1:
            up, vp = liu_shen_iter.liu_shen_iterate(h_reg, fields_p, up, vp, k - 1, 0.0,
                                                    edges, stop=False)[:2]
        un, vn = liu_shen_iter.liu_shen_iterate(h_reg, fields_p, up, vp, 1, 0.0, edges,
                                                stop=False)[:2]
        before = [_crop(z, h_loc, w, t, apron) for z in (up, vp)]
        after = [_crop(z, h_loc, w, t, apron) for z in (un, vn)]
        sums = torch.stack([((a - b).double() ** 2).sum() for a, b in zip(after, before)])
        sums = reduce_over(sums, mesh, _Y_ONLY)
        err = ((torch.sqrt(sums[0]) + torch.sqrt(sums[1])) / npix).to(torch.float32)
        return after[0].contiguous(), after[1].contiguous(), err

    tol32 = float(np.float32(tol))
    u, v = u0, v0
    err = torch.zeros((), dtype=torch.float32, device=u0.device)
    last = float(np.float32(1e8))
    n_full, rem = divmod(int(max_iter), t)
    for n in [t] * n_full + ([rem] if rem else []):
        if not last > tol32:
            break
        u, v, err = block(u, v, n)
        last = float(err)   # the host reads each block's err: the stop test
        liu_shen_solve_sharded_kernel.err_reads += 1
    return u, v, err


def liu_shen_solve_sharded_kernel(mesh, im1, im2, h_reg, u0, v0, max_iter=60, tol=1e-8,
                                  t_block: int | None = None):
    """Rows-sharded Liu-Shen solve on the Hopper kernel: this rank's
    ("y", None) stripes in, its (u, v) stripes and err out.  ``t_block``
    defaults to ``pick_ls_shard_t``."""
    h_loc, w = im1.shape[-2], im1.shape[-1]
    t = (pick_ls_shard_t(mesh, (h_loc * axis_size(mesh, "y"), w)) if t_block is None
         else int(t_block))
    if t is None or not ls_shard_kernel_supported(h_loc, w, t):
        raise ValueError(f"ls kernel-sharded path unsupported for local stripe ({h_loc}, {w}), "
                         f"t_block {t}")
    im1, im2, u0, v0 = _sh._f32(im1, im2, u0, v0)
    return _ls_body_shardkernel(im1, im2, u0, v0, mesh, h_reg=h_reg, max_iter=int(max_iter),
                                tol=tol, t_block=t)


liu_shen_solve_sharded_kernel.err_reads = 0
