"""Sharded solves on the Hopper kernels (port of
``parallel/sharded_pallas.py``): Horn-Schunck and Liu-Shen with one T-deep
halo exchange per launch, and rows-sharded dense LK and Farneback (at the
end of the module).

Every rank runs the single-device kernel (``ops/cuda/hs_iter.py``,
``ops/cuda/liu_shen_iter.py``) on its tile, padded by T rows and columns of
its neighbours' data on each interior side.  The fields are padded once a
solve (``_pad_interior``); u and v stay padded from one launch to the next,
the kernel's padded output being the next launch's input, and between
launches the neighbours' T-deep slabs are written into its apron in place
(``halo.refresh_apron``).  The solve crops once, at its end; on a one-rank
mesh there is no apron and nothing is copied between launches.  On CPU
tiles the kernels' plain versions run the same schedule.

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
could be NaN), and err of the block's last step is taken on the owned rows
and all-reduced over y.  The stop test stays on the device, as JAX's
``lax.while_loop`` cond does: every block of the solve is enqueued, each
with the gate ``err of the block before > tol`` that K4/K5 reads on the
device (a gated block runs no step and returns its input), and a gated
block keeps the err before it.  No host read decides anything, so a
solve can be captured in a CUDA graph.  The one exception is gloo with
CUDA tiles, which stages err through host memory and is never captured:
there the loop reads the test and enqueues no block after the stop.  At
max_iter the result is the single-device solve's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_ri_tpu_torch.models import farneback as fb
from opticalflow_ri_tpu_torch.models import lucas_kanade as lk
from opticalflow_ri_tpu_torch.ops.cuda import (
    blur5_flow, hs_iter, liu_shen_iter, lk_build, lk_iter, tent_sample,
)
from opticalflow_ri_tpu_torch.ops.padding import pad2d
from opticalflow_ri_tpu_torch.ops.stencil import correlate3x3_padded
from opticalflow_ri_tpu_torch.parallel import halo
from opticalflow_ri_tpu_torch.parallel import sharded as _sh
from opticalflow_ri_tpu_torch.parallel.halo import (
    exchange_halo, gather_axis, reduce_over, refresh_apron,
)
from opticalflow_ri_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
from opticalflow_ri_tpu_torch.parallel.sharded_glue import (
    check_splits, pil_band, pil_resize_sharded,
)
from opticalflow_ri_tpu_torch.utils.timing import span

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


def on_stripes(mesh, solve, *args, **kw) -> list:
    """``solve``, a rows-only solver on ("y", None) stripes, on this rank's
    ("y", "x") tiles: the tensor arguments gathered along x into stripes
    with one gather for all of them (GSPMD's all-gather for JAX's
    ``in_specs=P("y", None)``; a mesh with x = 1 moves nothing), the solve,
    then the rank's x block of each output field.  A scalar output (an
    err) is returned as it is."""
    at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    w = args[at[0]].shape[-1]
    tiles = [args[i].to(torch.float32) for i in at]
    if axis_size(mesh, "x") > 1:
        tiles = gather_axis(torch.stack(tiles), mesh, "x", -1).unbind(0)
    args = list(args)
    for i, stripe in zip(at, tiles):
        args[i] = stripe
    c0 = axis_index(mesh, "x") * w
    return [z[..., c0:c0 + w].contiguous() if z.dim() >= 2 else z
            for z in solve(mesh, *args, **kw)]


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
    last) on u and v kept padded, their T-deep apron refreshed in place
    before each launch but the first."""
    fx, fy, ft = _sh._hs_derivatives_local(im1, im2, mesh)
    t = int(t_block)
    h, w = im1.shape[-2], im1.shape[-1]
    edges, apron = _border_sides(mesh)
    fxp, fyp, ftp = (_pad_interior(z, t, mesh, apron) for z in (fx, fy, ft))
    up, vp = (_pad_interior(z, t, mesh, apron) for z in (u0, v0))
    done = 0
    while done < niter:
        if done:
            refresh_apron(up, t, mesh, apron)
            refresh_apron(vp, t, mesh, apron)
        k = min(t, niter - done)
        up, vp = hs_iter.hs_iterate(fxp, fyp, ftp, up, vp, alpha, k, edges)
        done += k
    u, v = (_crop(z, h, w, t, apron).contiguous() for z in (up, vp))
    return u, v, _sh._flow_err(u, v, u0, v0, mesh)


def hs_solve_sharded_kernel(mesh, im1, im2, alpha, niter, u0, v0, t_block: int | None = None):
    """Spatially sharded Horn-Schunck on the Hopper kernel, ("y", "x") tiles;
    the contract of sharded.hs_solve_sharded.  ``t_block`` defaults to the
    kernel's iterations per launch."""
    t = hs_iter.STEPS_PER_LAUNCH if t_block is None else int(t_block)
    h_loc, w_loc = im1.shape[-2], im1.shape[-1]
    if not hs_shard_kernel_supported(h_loc, w_loc, t):
        raise ValueError(f"hs kernel-sharded path unsupported for local tile ({h_loc}, {w_loc}), "
                         f"t_block {t}: a tile needs at least {t + 2} cells a side")
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
    crop = lambda z: _crop(z, h_loc, w, t, apron)  # noqa: E731
    fields_p = tuple(pad(f) for f in fields)
    npix = float(h_loc * axis_size(mesh, "y") * w)

    def block(up, vp, k, gate):
        """k steps from the padded (up, vp) unless ``gate`` is 0 (then the
        input itself), and the err of the last step on the owned rows."""
        if k > 1:
            up, vp = liu_shen_iter.liu_shen_iterate(h_reg, fields_p, up, vp, k - 1, 0.0,
                                                    edges, stop=False, gate=gate)[:2]
        un, vn = liu_shen_iter.liu_shen_iterate(h_reg, fields_p, up, vp, 1, 0.0, edges,
                                                stop=False, gate=gate)[:2]
        sums = torch.stack([((crop(a) - crop(b)).double() ** 2).sum()
                            for a, b in ((un, up), (vn, vp))])
        sums = reduce_over(sums, mesh, _Y_ONLY)
        return un, vn, ((torch.sqrt(sums[0]) + torch.sqrt(sums[1])) / npix).to(torch.float32)

    # JAX's loop (sharded_pallas.py:266-290) as a fixed sequence of blocks:
    # each runs while the err before it exceeds tol (1e8 before the first),
    # the tail of rem steps under the same test (run_tail); a gated block
    # returns its input and keeps the err before it, 0 when no block ran.
    # Where the group stages CUDA tiles through host memory (gloo, never
    # captured), err has passed through the host already: there the test
    # is read and no block after the stop is enqueued, the same result.
    tol32 = float(np.float32(tol))
    read_stop = axis_size(mesh, "y") > 1 and halo._staged(axis_group(mesh, "y"), u0)
    up, vp = pad(u0), pad(v0)
    err = torch.zeros((), dtype=torch.float32, device=u0.device)
    last = torch.full((), 1e8, dtype=torch.float32, device=u0.device)
    n_full, rem = divmod(int(max_iter), t)
    for j, n in enumerate([t] * n_full + ([rem] if rem else [])):
        go = last > tol32
        if read_stop and not bool(go):
            break
        if j:
            refresh_apron(up, t, mesh, apron, _Y_ONLY)
            refresh_apron(vp, t, mesh, apron, _Y_ONLY)
        up, vp, e = block(up, vp, n, go.to(torch.int32))
        err, last = torch.where(go, e, err), torch.where(go, e, last)
    return crop(up).contiguous(), crop(vp).contiguous(), err


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
                         f"t_block {t}: a stripe needs more than {t or 4} rows and at least 2 "
                         f"columns")
    im1, im2, u0, v0 = _sh._f32(im1, im2, u0, v0)
    return _ls_body_shardkernel(im1, im2, u0, v0, mesh, h_reg=h_reg, max_iter=int(max_iter),
                                tol=tol, t_block=t)


# ---------------------------------------------------------------------------
# Rows-sharded dense Lucas-Kanade and Farneback
# ---------------------------------------------------------------------------
#
# Both decompose rows only, ("y", None): a rank holds a whole-width stripe,
# ranks along x hold replicas.  The kernels' sharded modes carry the border
# rule: on the image's border a kernel keeps its whole-image rule, on an
# interior side it reads the neighbour's rows the caller exchanged.  Given
# those rows every output pixel is the single-device one, so the sharded
# u, v (and LK's status) equal the port's lk_dense_solve and farneback_solve
# bit for bit.
#
# No fallback.  A stripe or level that the conditions refuse raises
# ValueError: nothing gathers the image or runs single-device in its place.
# (JAX falls back per level to its GSPMD XLA loop; the port has no
# partitioner to fall back to.)  The conditions are JAX's geometric ones,
# without its validated-kernel registry and TPU layout gates
# (sharded_pallas.py:340-367, 543-570): the port's kernels take any shape.

def pick_lk_shard_stripe(mesh, shape, half_window: int = 13,
                         max_shift: int = 5) -> int | None:
    """The stripe height of a rows-sharded LK solve of the global ``shape``
    on ``mesh``: ``h // my``, or None where ``h`` does not split over the y
    ranks or a stripe is thinner than its lk_pad(max_shift)-row apron (the
    halo would reach past the neighbour).  JAX stages a stripe in
    VMEM-sized pieces (``lk_striped_height``); the card needs no staging,
    so a rank runs its stripe as one."""
    my = axis_size(mesh, "y")
    h = shape[-2]
    if h % my:
        return None
    h_loc = h // my
    if my > 1 and h_loc < lk.lk_pad(max_shift):
        return None
    return h_loc


def lk_solve_sharded_kernel(mesh, im1, im2, u0, v0, half_window: int = 13, n_iter: int = 5,
                            asym=(0, 0, 0, 0), max_shift: int = 5):
    """Rows-sharded dense LK on K6 and K7: this rank's ("y", None) stripes
    in, its (u, v, status) stripes out; the contract of
    models.lucas_kanade.lk_dense_solve.  One "nearest" halo exchange per
    image of lk_pad(max_shift) rows (38 at R = 5), edge padding in x (the
    stripe is whole-width), then the solve fields, K6 on the stripe's slab
    and K7 in global rows (``row0``, ``img_h``).  No collective per
    iteration: every pixel's Gauss-Newton loop is independent.  The spans
    are ``lk_dense_solve``'s: ``ofri.precompute`` (the halo exchange
    included), ``ofri.planes`` and ``ofri.iterate``."""
    h_loc, w = im1.shape[-2], im1.shape[-1]
    my = axis_size(mesh, "y")
    if pick_lk_shard_stripe(mesh, (h_loc * my, w), half_window, max_shift) != h_loc:
        raise ValueError(f"lk kernel-sharded path unsupported for local stripe ({h_loc}, {w}) "
                         f"on y = {my}: a stripe needs {lk.lk_pad(max_shift)} rows")
    hw, R = int(half_window), int(max_shift)
    row0 = axis_index(mesh, "y") * h_loc
    pad = lk.lk_pad(R)

    def pad_full(z):
        zy = exchange_halo(z.to(torch.float32), ((pad, pad), (0, 0)), "nearest", mesh)
        return pad2d(zy, ((0, 0), (pad, pad)), "nearest")

    u0, v0 = _sh._f32(u0, v0)
    with span("precompute"):
        slab, g_pair, fields, runs_y, runs_x = lk.lk_kernel_inputs_padded(
            pad_full(im1), pad_full(im2), u0, v0, hw, asym, R, row0)
    with span("planes"):
        t1, t2 = lk_build.lk_build_planes(slab, g_pair, hw, R, runs_y, runs_x)
    with span("iterate"):
        px, py, status = lk_iter.lk_gn_iterate(t1, t2, *fields, n_iter, R, hw, row0=row0,
                                               img_h=h_loc * my, img_w=w)
        ok = fields[5] > 0
        jj, ii = lk.pixel_grid(h_loc, w, ok.device, row0)
        u = torch.where(ok, px + hw - jj, u0)
        v = torch.where(ok, py + hw - ii, v0)
        status = torch.where(ok, status, torch.zeros_like(status))
    return u, v, status


def fb_shard_supported(mesh, shape, window_size: int, R: int = 5) -> bool:
    """Can the rows-sharded Farneback iteration run a level of the global
    ``shape`` on ``mesh``?  JAX's conditions (``sharded_pallas.py:340``):
    the rows split over the y ranks, and with more than one a stripe holds
    the window blur's half + 1 rows and the sampler's R + 1."""
    my = axis_size(mesh, "y")
    h = shape[-2]
    if h % my:
        return False
    return my == 1 or h // my >= max(window_size // 2 + 1, R + 1)


_Y_EDGES = hs_iter.TOP | hs_iter.BOTTOM


def farneback_iterate_sharded(mesh, r0, r1, fx, fy, window_size: int, use_gaussian: bool,
                              n_iters: int, R: int = 5):
    """One Farneback level's iteration loop on this rank's stripes: R0, R1
    (5, h_loc, w), the flow (h_loc, w) in; the flow out.  R1's R-row apron
    is exchanged once (iteration-invariant), M's half-row apron once an
    iteration; K9 runs in stripe mode (global rows) and K12 with the y mask
    (a side with an apron reads it).  The flow needs no exchange: K9 is
    per-pixel.  The apron is exchanged in mode "constant" and dropped on
    the image's border sides, where the kernels apply their own rule."""
    h_loc, w = fx.shape[-2], fx.shape[-1]
    my = axis_size(mesh, "y")
    if not fb_shard_supported(mesh, (h_loc * my, w), window_size, R):
        raise ValueError(f"fb kernel-sharded path unsupported for local stripe ({h_loc}, {w}) "
                         f"on y = {my}, window {window_size}, R {R}: a stripe needs "
                         f"{max(window_size // 2 + 1, R + 1)} rows")
    taps, mode, scale = fb._window_blur_spec(window_size, use_gaussian)
    half = len(taps) // 2
    edges, apron = _border_sides(mesh, _Y_ONLY)
    top, bot = apron[0], apron[1]
    row0 = axis_index(mesh, "y") * h_loc
    r0, r1, fx, fy = _sh._f32(r0, r1, fx, fy)
    r1p = _pad_interior(r1, R, mesh, apron, _Y_ONLY)

    def um(u, v):
        return tent_sample.update_matrices(u, v, r0, r1p, R, row0=row0, img_rows=h_loc * my,
                                           apron=(R if top else 0, R if bot else 0))

    m = um(fx, fy)
    for i in range(int(n_iters)):
        fx, fy = blur5_flow.blur5_flow(_pad_interior(m, half, mesh, apron, _Y_ONLY), taps, mode,
                                       scale, edges & _Y_EDGES)
        if i < n_iters - 1:
            m = um(fx, fy)
    return fx, fy


def _fb_expansion_local(im, lvl, poly_n, poly_sigma, mesh):
    """The level's expansion of one image on this rank's stripe: the
    bit-exact blur (smooth // 2 "mirror" rows exchanged, 1 at level 0), the
    PIL-bilinear resize to the level across the stripes
    (``sharded_glue.pil_resize_sharded``, rows sharded), then the expansion
    (poly_n "nearest" rows exchanged)."""
    half = lvl["smooth"] // 2
    b = fb.gaussian_blur_padded(exchange_halo(im, ((half, half), (0, 0)), "mirror", mesh),
                                lvl["smooth"], lvl["sigma"])
    b = pil_resize_sharded(b, (lvl["height"], lvl["width"]), "bilinear", mesh, _Y_ONLY)
    return fb.poly_expansion_padded(exchange_halo(b, ((poly_n, poly_n), (0, 0)), "nearest",
                                                  mesh), poly_n, poly_sigma).contiguous()


def _fb_check_levels(mesh, plan, h_loc, window_size, R, poly_n):
    """Raise ``ValueError`` naming the first level whose stripes the
    iteration or the glue's halos refuse: the level's rows split over y,
    ``fb_shard_supported``, and with more than one rank the expansion's
    poly_n rows, the blur's smooth // 2 and the PIL-bilinear bands (the
    level's own, and the flow's from the level before) within the
    neighbour's stripe."""
    my = axis_size(mesh, "y")
    rows = h_loc * my
    prev = None
    for k, lvl in enumerate(plan):
        shape = (lvl["height"], lvl["width"])
        what = (f"farneback_solve_sharded level {len(plan) - 1 - k} (scale {lvl['scale']}), "
                f"shape {shape}, on y = {my}")
        lh = check_splits(shape, mesh, what, _Y_ONLY)[0]
        if not fb_shard_supported(mesh, shape, window_size, R):
            raise ValueError(f"{what}: a stripe of {lh} rows is refused; it needs "
                             f"{max(window_size // 2 + 1, R + 1)} (window {window_size}, R {R})")
        if my > 1 and (lh < poly_n or h_loc <= lvl["smooth"] // 2):
            raise ValueError(f"{what}: a stripe of {lh} rows (level 0: {h_loc}) is thinner than "
                             f"the expansion's {poly_n} rows or the blur's "
                             f"{lvl['smooth'] // 2}")
        try:
            pil_band(rows, shape[0], "bilinear", my)
            pil_band(prev or rows, shape[0], "bilinear", my)
        except ValueError as err:
            raise ValueError(f"{what}: {err}") from None
        prev = shape[0]


def farneback_solve_sharded(mesh, im1, im2, u0, v0, window_size=33, n_iters=5, poly_n=7,
                            poly_sigma=1.5, use_gaussian=True, pyr_scale=0.5, pyr_levels=1,
                            sample_max_shift: int = 5):
    """The Farneback pipeline on this rank's ("y", None) stripes; the
    contract of models.farneback.farneback_solve.  Each level's glue (blur,
    resize to the level, expansion, the flow's resize from the level
    before) runs on the stripes with halo exchanges, its iteration loop in
    ``farneback_iterate_sharded``.  Every level's conditions are checked
    before any work: a level they refuse raises ``ValueError``."""
    h_loc, w = im1.shape[-2], im1.shape[-1]
    my = axis_size(mesh, "y")
    plan = fb._level_plan(h_loc * my, w, pyr_scale, pyr_levels - 1)
    R = int(sample_max_shift)
    _fb_check_levels(mesh, plan, h_loc, window_size, R, poly_n)
    im1, im2, u0, v0 = _sh._f32(im1, im2, u0, v0)

    def resize(z, lvl):
        return pil_resize_sharded(z, (lvl["height"], lvl["width"]), "bilinear", mesh, _Y_ONLY)

    prev = None
    for lvl in plan:
        if prev is None:
            f = float(np.float32(lvl["scale"]))
            fx, fy = (resize(z, lvl) * f for z in (u0, v0))
        else:
            f = float(np.float32(1.0 / pyr_scale))
            fx, fy = (resize(z, lvl) * f for z in prev)
        ra, rb = (_fb_expansion_local(im, lvl, poly_n, poly_sigma, mesh) for im in (im1, im2))
        prev = farneback_iterate_sharded(mesh, ra, rb, fx.contiguous(), fy.contiguous(),
                                         window_size, use_gaussian, n_iters, R)
    return prev
