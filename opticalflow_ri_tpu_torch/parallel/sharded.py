"""Spatially sharded solvers: halo exchange per iteration plus all-reduced
norms (port of ``parallel/sharded.py``).

Each function takes and returns this rank's LOCAL tiles under the spec it
names (a mesh axis per array dimension, ``distributed.local_slices``); the
JAX functions take and return global arrays.  Every rank of the mesh calls
it with its own tiles.  The solvers are the single-device ones of
``models/``, run SPMD over a ("batch", "y", "x") mesh:

  * image tiles live on the ranks; every Jacobi / fixed-point iteration
    exchanges a 1-px halo with the 4 neighbours (``halo.exchange_halo``);
  * global scalars (Frobenius error norms, image maxima) are all-reduced
    over the spatial axes (``halo.reduce_over``: JAX's psum and pmax);
  * whole image pairs batch over the 'batch' axis (pure data parallelism).

``impl="auto"`` takes the kernel path (``sharded_kernel.py``: the Hopper
kernels on each tile, one T-deep halo exchange per launch) for CUDA tiles
and the plain per-iteration body here for CPU tiles.  ``err`` is a 0-d
tensor (one per pair for the batched pipeline), equal on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_ri_tpu_torch.models import liu_shen as ls
from opticalflow_ri_tpu_torch.ops.stencil import correlate3x3_padded, hs_avg3x3_padded
from opticalflow_ri_tpu_torch.parallel.halo import exchange_halo, reduce_over
from opticalflow_ri_tpu_torch.parallel.sharded_glue import prefilter_sharded

_SPATIAL = ("y", "x")


def _pick(impl: str, t: torch.Tensor) -> str:
    if impl == "auto":
        return "kernel" if t.device.type == "cuda" else "body"
    if impl not in ("kernel", "body"):
        raise ValueError(f"impl must be 'auto', 'kernel' or 'body', got {impl!r}")
    return impl


def _f32(*ts):
    return tuple(t.to(torch.float32) for t in ts)


def _hs_derivatives_local(im1, im2, mesh):
    """HS 2x2 derivative stencils on local tiles: +1 halo bottom/right with
    the global mirror rule (cf. ops.stencil.hs_derivatives)."""

    def quads(im):
        p = exchange_halo(im, ((0, 1), (0, 1)), "mirror", mesh)
        h, w = im.shape[-2], im.shape[-1]
        return (p[..., :h, :w], p[..., :h, 1 : w + 1],
                p[..., 1 : h + 1, :w], p[..., 1 : h + 1, 1 : w + 1])

    a1, b1, c1, d1 = quads(im1)
    a2, b2, c2, d2 = quads(im2)
    fx = (a1 - b1 + c1 - d1 + a2 - b2 + c2 - d2) * 0.25
    fy = (a1 + b1 - c1 - d1 + a2 + b2 - c2 - d2) * 0.25
    ft = (a1 + b1 + c1 + d1 - a2 - b2 - c2 - d2) * 0.25
    return fx, fy, ft


def _corr3_sharded(z, kernel, mode, mesh):
    zp = exchange_halo(z, 1, mode, mesh)
    return correlate3x3_padded(zp, kernel, z.shape[-2], z.shape[-1])


def _global_sum(z, mesh, axes=_SPATIAL):
    # sum over the spatial (trailing) dims only, then all-reduce over the
    # spatial mesh axes: per-batch-element scalars stay separate
    return reduce_over(torch.sum(z, dim=(-2, -1)), mesh, axes)


def _flow_err(u, v, u0, v0, mesh, axes=_SPATIAL):
    """(‖u − u0‖_F + ‖v − v0‖_F) / (H·W) over the whole image."""
    npix = _global_sum(torch.ones_like(u), mesh, axes)
    return (torch.sqrt(_global_sum((u - u0) ** 2, mesh, axes))
            + torch.sqrt(_global_sum((v - v0) ** 2, mesh, axes))) / npix


def _hs_body(im1, im2, u0, v0, mesh, *, alpha, niter):
    fx, fy, ft = _hs_derivatives_local(im1, im2, mesh)
    a = np.float32(alpha)
    rdenom = 1.0 / (float(a * a) + fx * fx + fy * fy)
    h, w = im1.shape[-2], im1.shape[-1]

    def avg(z):
        return hs_avg3x3_padded(exchange_halo(z, 1, "mirror", mesh), h, w)

    u, v = u0, v0
    for _ in range(int(niter)):
        u_avg = avg(u)
        v_avg = avg(v)
        der = (fx * u_avg + fy * v_avg + ft) * rdenom
        u, v = u_avg - fx * der, v_avg - fy * der
    return u, v, _flow_err(u, v, u0, v0, mesh)


def _avg3x3_wrap(x):
    """Mirror-free 3x3 neighbour average with wraparound (copy of
    ``ops/pallas/hs_tiled.py:_avg3x3_wrap``): the wrapped cells are stale
    halo by construction and are cropped."""
    p = torch.roll(x, 1, dims=-1) + 2.0 * x + torch.roll(x, -1, dims=-1)
    q = torch.roll(p, 1, dims=-2) + 2.0 * p + torch.roll(p, -1, dims=-2)
    return (q - 4.0 * x) * float(np.float32(1.0 / 12.0))


def _hs_body_tblocked(im1, im2, u0, v0, mesh, *, alpha, niter, t_block):
    """Temporal-blocked variant of _hs_body: T Jacobi iterations per halo
    exchange instead of one.  Each outer step exchanges a T-deep halo (global
    borders synthesise a T-deep mirror ring -- the Jacobi operator preserves
    mirror symmetry, so the ring evolves like its interior image for T
    iterations), runs T wraparound stencil iterations on the padded tile
    (edge garbage creeps 1 px per iteration and never crosses the halo) and
    crops.  Exchanges drop from ``niter`` to ``ceil(niter / t_block)``."""
    fx, fy, ft = _hs_derivatives_local(im1, im2, mesh)
    a = np.float32(alpha)
    rd = 1.0 / (float(a * a) + fx * fx + fy * fy)
    t = int(t_block)
    # the constants are padded once (they do not evolve: no staleness)
    fxp, fyp, ftp, rdp = (exchange_halo(z, t, "mirror", mesh) for z in (fx, fy, ft, rd))
    h, w = im1.shape[-2], im1.shape[-1]

    u, v = u0, v0
    done = 0
    while done < niter:
        k = min(t, niter - done)
        up = exchange_halo(u, t, "mirror", mesh)
        vp = exchange_halo(v, t, "mirror", mesh)
        for _ in range(k):
            u_avg = _avg3x3_wrap(up)
            v_avg = _avg3x3_wrap(vp)
            der = (fxp * u_avg + fyp * v_avg + ftp) * rdp
            up, vp = u_avg - fxp * der, v_avg - fyp * der
        u = up[..., t : t + h, t : t + w]
        v = vp[..., t : t + h, t : t + w]
        done += k
    return u, v, _flow_err(u, v, u0, v0, mesh)


def hs_solve_sharded_tblocked(mesh, im1, im2, alpha, niter, u0, v0, t_block: int = 10):
    """Temporal-blocked spatially sharded Horn-Schunck on ("y", "x") tiles:
    the numerics of hs_solve_sharded (to f32 round-off) with t_block times
    fewer halo exchanges.  ``t_block`` must be below the local tile extent."""
    return _hs_body_tblocked(*_f32(im1, im2, u0, v0), mesh, alpha=alpha, niter=int(niter),
                             t_block=int(t_block))


def hs_solve_sharded(mesh, im1, im2, alpha, niter, u0, v0, impl: str = "auto",
                     t_block: int | None = None):
    """Spatially sharded Horn-Schunck on ("y", "x") tiles; same numerics as
    models.horn_schunck.hs_solve.  Returns this rank's (u, v) tiles and err."""
    if _pick(impl, im1) == "kernel":
        from opticalflow_ri_tpu_torch.parallel.sharded_kernel import hs_solve_sharded_kernel

        return hs_solve_sharded_kernel(mesh, im1, im2, alpha, niter, u0, v0, t_block=t_block)
    return _hs_body(*_f32(im1, im2, u0, v0), mesh, alpha=alpha, niter=int(niter))


# ---------------------------------------------------------------------------
# Liu-Shen
# ---------------------------------------------------------------------------

def _ls_fields_local(im1, im2, h_reg, corr, mesh, axes):
    """The 8 fields of models.liu_shen.liu_shen_precompute on local tiles,
    the images normalised by their global maxima; ``corr(z, kernel, mode)``
    is the 3x3 correlation with halos."""
    im1 = im1 / reduce_over(im1.max(), mesh, axes, "max")
    im2 = im2 / reduce_over(im2.max(), mesh, axes, "max")
    h = float(np.float32(h_reg))
    iix = im1 * corr(im1, ls._K_D1, "nearest")
    iiy = im1 * corr(im1, ls._K_D2, "nearest")
    ii = im1 * im1
    dt = im2 - im1
    ixt = im1 * corr(dt, ls._K_D1, "nearest")
    iyt = im1 * corr(dt, ls._K_D2, "nearest")
    cmtx = corr(torch.ones_like(im1), ls._K_H, "constant")
    a11 = im1 * (corr(im1, ls._K_D2ND, "nearest") - 2.0 * im1) - h * cmtx
    a22 = im1 * (corr(im1, ls._K_D2ND.T, "nearest") - 2.0 * im1) - h * cmtx
    a12 = im1 * corr(im1, ls._K_M, "nearest")
    det = a11 * a22 - a12 * a12
    return (iix, iiy, ii, ixt, iyt, a22 / det, -a12 / det, a11 / det)


def _ls_body(im1, im2, u0, v0, mesh, *, h_reg, max_iter, tol=1e-8):
    corr = lambda z, k, mode: _corr3_sharded(z, k, mode, mesh)  # noqa: E731
    iix, iiy, ii, ixt, iyt, b11, b12, b22 = _ls_fields_local(im1, im2, h_reg, corr, mesh,
                                                             _SPATIAL)
    h = float(np.float32(h_reg))

    def iteration(u, v):
        # 4 halo exchanges per iteration (one nearest + one zero-border apron
        # per field) instead of one per stencil; the stencil math is
        # models.liu_shen.liu_shen_iteration's
        oh, ow = u.shape[-2], u.shape[-1]
        du1, du2, fu1, _, mu = ls.ls_field_stencils(exchange_halo(u, 1, "nearest", mesh), oh, ow)
        dv1, dv2, _, fv2, mv = ls.ls_field_stencils(exchange_halo(v, 1, "nearest", mesh), oh, ow)
        ring_u = ls.ls_ring_sum(exchange_halo(u, 1, "constant", mesh), oh, ow)
        ring_v = ls.ls_ring_sum(exchange_halo(v, 1, "constant", mesh), oh, ow)
        bu = iix * (2.0 * du1 + dv2) + iiy * dv1 + ii * (fu1 + mv) + h * ring_u + ixt
        bv = iiy * (du1 + 2.0 * dv2) + iix * du2 + ii * (mu + fv2) + h * ring_v + iyt
        return -(b11 * bu + b12 * bv), -(b12 * bu + b22 * bv)

    tol = float(np.float32(tol))
    u, v, k = u0, v0, 0
    err = torch.zeros((), dtype=torch.float32, device=u0.device)
    last = float(np.float32(1e8))
    while last > tol and k < int(max_iter):
        un, vn = iteration(u, v)
        err = _flow_err(un, vn, u, v, mesh)
        last = float(err)   # one host read per iteration, as the plain loop
        u, v, k = un, vn, k + 1
    return u, v, err


def liu_shen_solve_sharded(mesh, im1, im2, h_reg, u0, v0, max_iter=60, impl: str = "auto",
                           t_block: int | None = None, tol: float = 1e-8):
    """Spatially sharded Liu-Shen fixed-point solve (internal component
    convention; see the models.liu_shen adapter for the swap) on ("y", "x")
    tiles.  The kernel path decomposes rows only: it takes a mesh whose x
    axis is 1, where these tiles are whole-width stripes
    (``sharded_kernel.liu_shen_solve_sharded_kernel``)."""
    if _pick(impl, im1) == "kernel":
        from opticalflow_ri_tpu_torch.parallel.mesh import axis_size
        from opticalflow_ri_tpu_torch.parallel.sharded_kernel import (
            liu_shen_solve_sharded_kernel,
        )

        if axis_size(mesh, "x") != 1:
            raise ValueError("the Liu-Shen kernel path shards rows only: use a mesh with x = 1, "
                             "or liu_shen_solve_sharded_kernel on ('y', None) stripes")
        return liu_shen_solve_sharded_kernel(mesh, im1, im2, h_reg, u0, v0, max_iter=max_iter,
                                             tol=tol, t_block=t_block)
    return _ls_body(*_f32(im1, im2, u0, v0), mesh, h_reg=h_reg, max_iter=int(max_iter), tol=tol)


# ---------------------------------------------------------------------------
# Batched end-to-end pipeline (dp over 'batch' + 2-D spatial decomposition)
# ---------------------------------------------------------------------------

def batched_hs_pipeline(mesh, im1, im2, alpha=21.0, niter=10, filter_sigma=3.4,
                        impl: str = "auto"):
    """One full flow step on a batch of image pairs: calibrated pre-filter +
    HS derivatives + Jacobi iterations + global error, SPMD over ("batch",
    "y", "x").  Takes this rank's (B_local, h, w) tiles of the
    ``distributed.SPEC_BATCH`` spec; returns its (u, v) tiles and err, one
    per local pair.  The kernel path runs the pairs one after another."""
    im1, im2 = _f32(im1, im2)
    if filter_sigma > 1e-3:
        im1 = prefilter_sharded(im1, filter_sigma, 3, mesh)
        im2 = prefilter_sharded(im2, filter_sigma, 3, mesh)
    z = torch.zeros_like(im1)
    if _pick(impl, im1) == "body":
        return _hs_body(im1, im2, z, z, mesh, alpha=alpha, niter=int(niter))
    from opticalflow_ri_tpu_torch.parallel.sharded_kernel import hs_solve_sharded_kernel

    outs = [hs_solve_sharded_kernel(mesh, im1[b], im2[b], alpha, niter, z[b], z[b])
            for b in range(im1.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))
