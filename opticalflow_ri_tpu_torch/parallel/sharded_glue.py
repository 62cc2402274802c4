"""The pyramid's glue on this rank's tiles: the counterparts of
``ops/resize.py``, ``ops/warp.py`` and the pre-filters for the sharded
pyramid (``auto_sharded_pipeline``'s route 2).

The JAX package traces the pyramid once and GSPMD partitions its resize,
warp and pre-filter ops across the mesh.  PyTorch has no partitioner, so
each op has a tile form here; ``TileGlue`` binds them to a mesh, and
``pyramid.py`` runs on it while ``context.kernel_sharded_solvers`` holds
one.  Every function takes and returns this rank's ("y", "x") tiles;
every rank of the mesh calls it with tiles of one shape.

  * ``pil_resize_sharded``: Pillow's matrix is banded.  Each rank exchanges
    the band's apron once (both axes, zeros beyond the image, whose weights
    are zero) and multiplies by its slice of the global matrix: its output
    rows, its input rows plus the apron.  The apron is the matrix's own
    nonzero extent over each rank's output rows, not a formula; one that
    reaches past a neighbour's tile raises.  Pillow's order is kept:
    horizontal, then vertical.
  * ``spline_upsample_sharded``: the FITPACK operator is dense.  The rows
    pass gathers the column of tiles along y and applies the rank's output
    rows of the row operator; the columns pass gathers the row of those
    along x and applies its output columns: the reference's rows-then-
    columns order.
  * ``symmetric_warp_pair_sharded``: an apron of ``max_shift`` cells of
    both images (mode "nearest"), then K3 in its caller-padded mode, which
    equals the whole-image warp cropped to the tile bit for bit.
  * ``prefilter_sharded`` (route 1's too): the calibrated Gaussian with
    symmetric halos, bit for bit the single-device one.
  * ``liu_shen_warp_sharded`` (``biLinear=False``): the scatter by the flow,
    which wraps around the whole image and has no reach bound, as one max
    all-reduce of an image-sized buffer of keys; then the residual's
    Gaussian with a 36-cell apron and the correction from a one-cell
    apron.  It equals the whole-image warp cropped to the tile bit for
    bit; a tile smaller than 36 cells a side raises ``ValueError``.

A matmul over a sliced or gathered K need not add in the single-device
order, so a resize on tiles may differ from the whole-image one in the last
bits; the warps and the pre-filters do not.

Every level's global shape must split over the mesh: a shape that does not
raises ``ValueError``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import warp_tent
from opticalflow_ri_tpu_torch.ops.gaussian import prepare_gaussian_kernel
from opticalflow_ri_tpu_torch.ops.resize import pil_resize_matrix, spline_resize_matrix
from opticalflow_ri_tpu_torch.ops.warp import LS_WARP_SIGMA, LS_WARP_TAPS, liu_shen_destinations
from opticalflow_ri_tpu_torch.parallel.halo import exchange_halo, gather_axis, reduce_over
from opticalflow_ri_tpu_torch.parallel.mesh import axis_index, axis_size
from opticalflow_ri_tpu_torch.utils.device import device_constant

_SPATIAL = ("y", "x")


def _split(mesh, axes) -> tuple:
    """((ranks, index) along y, (ranks, index) along x); an axis not in
    ``axes`` is whole on every rank."""
    return tuple((axis_size(mesh, a), axis_index(mesh, a)) if a in axes else (1, 0)
                 for a in _SPATIAL)


def global_shape(tile_shape, mesh, axes=_SPATIAL) -> tuple:
    """The (H, W) of the image whose tile of ``tile_shape`` this rank holds."""
    (my, _), (mx, _) = _split(mesh, axes)
    return int(tile_shape[-2]) * my, int(tile_shape[-1]) * mx


def check_splits(shape, mesh, what: str, axes=_SPATIAL) -> tuple:
    """This rank's (h, w) of the global ``shape``; ``ValueError`` naming
    ``what`` where the shape does not split over the mesh."""
    (my, _), (mx, _) = _split(mesh, axes)
    h, w = int(shape[-2]), int(shape[-1])
    if h % my or w % mx:
        raise ValueError(f"{what}: the shape ({h}, {w}) does not split over (y, x) = "
                         f"({my}, {mx}) ranks")
    return h // my, w // mx


@lru_cache(maxsize=None)
def pil_band(in_size: int, out_size: int, method: str, m: int) -> tuple:
    """(lo, hi): the apron, in input cells, that every rank of ``m`` needs
    before and after its input tile, from the nonzero extent of the PIL
    matrix over each rank's output rows."""
    mat = pil_resize_matrix(in_size, out_size, method)
    n_in, n_out = in_size // m, out_size // m
    lo = hi = 0
    for r in range(m):
        used = np.flatnonzero(mat[r * n_out:(r + 1) * n_out].any(axis=0))
        if used.size:
            lo = max(lo, r * n_in - int(used[0]))
            hi = max(hi, int(used[-1]) + 1 - (r + 1) * n_in)
    if m > 1 and max(lo, hi) > n_in:
        raise ValueError(f"pil_resize_sharded ({method}, {in_size} -> {out_size} over {m} ranks): "
                         f"the band reaches {max(lo, hi)} cells past a tile of {n_in}, beyond "
                         f"the neighbour's tile")
    return lo, hi


def _pil_slice(in_size: int, out_size: int, method: str, m: int, i: int) -> np.ndarray:
    """Rank ``i``'s (n_out, lo + n_in + hi) slice of the PIL matrix: its
    output rows, its input cells plus the apron, zero beyond the image."""
    lo, hi = pil_band(in_size, out_size, method, m)
    mat = pil_resize_matrix(in_size, out_size, method)
    n_in, n_out = in_size // m, out_size // m
    c0 = i * n_in - lo
    a, b = max(c0, 0), min((i + 1) * n_in + hi, in_size)
    out = np.zeros((n_out, lo + n_in + hi), np.float32)
    out[:, a - c0:b - c0] = mat[i * n_out:(i + 1) * n_out, a:b]
    return out


def pil_resize_sharded(tile: torch.Tensor, out_global_hw, method: str, mesh,
                       axes=_SPATIAL) -> torch.Tensor:
    """``ops.resize.pil_resize`` of the global image on this rank's tile:
    returns its tile of the (out_h, out_w) result.  ``axes`` names the
    sharded mesh axes (("y",) for a whole-width stripe)."""
    (my, iy), (mx, ix) = _split(mesh, axes)
    in_h, in_w = global_shape(tile.shape, mesh, axes)
    out_h, out_w = int(out_global_hw[0]), int(out_global_hw[1])
    if (in_h, in_w) == (out_h, out_w):
        return tile
    check_splits((in_h, in_w), mesh, "pil_resize_sharded input", axes)
    check_splits((out_h, out_w), mesh, "pil_resize_sharded output", axes)
    (ly, hy), (lx, hx) = pil_band(in_h, out_h, method, my), pil_band(in_w, out_w, method, mx)
    # on a one-rank axis the slice is the whole matrix and the apron 0
    rv = device_constant(_pil_slice, in_h, out_h, method, my, iy, device=tile.device)
    rh = device_constant(_pil_slice, in_w, out_w, method, mx, ix, device=tile.device)
    padded = tile
    if ly or hy or lx or hx:
        padded = exchange_halo(tile, ((ly, hy), (lx, hx)), "constant", mesh)
    return torch.matmul(rv, torch.matmul(padded, rh.T))


def spline_upsample_sharded(tile: torch.Tensor, out_global_hw, mesh) -> torch.Tensor:
    """``ops.resize.spline_upsample`` of the global field on this rank's
    tile: one gather along y for the rows pass, one along x for the columns
    pass."""
    (my, iy), (mx, ix) = _split(mesh, _SPATIAL)
    in_h, in_w = global_shape(tile.shape, mesh)
    out_h, out_w = int(out_global_hw[0]), int(out_global_hw[1])
    if (in_h, in_w) == (out_h, out_w):
        return tile
    oh, ow = check_splits((out_h, out_w), mesh, "spline_upsample_sharded output")
    rv = device_constant(spline_resize_matrix, in_h, out_h, device=tile.device)
    rh = device_constant(spline_resize_matrix, in_w, out_w, device=tile.device)
    rows = torch.matmul(rv[iy * oh:(iy + 1) * oh], gather_axis(tile, mesh, "y", -2))
    return torch.matmul(gather_axis(rows, mesh, "x", -1), rh[ix * ow:(ix + 1) * ow].T)


def symmetric_warp_pair_sharded(im1: torch.Tensor, im2: torch.Tensor, u: torch.Tensor,
                                v: torch.Tensor, mesh, max_shift: int = 8):
    """``ops.warp.symmetric_warp_pair`` on this rank's tiles: im1 by
    (-v/2, -u/2), im2 by (+v/2, +u/2).  One exchange of both images'
    ``max_shift``-cell apron, then K3 in its caller-padded mode."""
    (_, iy), (_, ix) = _split(mesh, _SPATIAL)
    img_h, img_w = global_shape(im1.shape, mesh)
    h, w = im1.shape[-2], im1.shape[-1]
    a = int(max_shift)
    p = exchange_halo(torch.stack([im1, im2]), a, "nearest", mesh)
    return warp_tent.warp_pair(p[0].contiguous(), p[1].contiguous(), -v / 2.0, -u / 2.0,
                               v / 2.0, u / 2.0, a, apron=a, row0=iy * h, col0=ix * w,
                               img_h=img_h, img_w=img_w)


def prefilter_sharded(im, sigma, ksize, mesh):
    """``ops.gaussian.gaussian_filter_px`` on this rank's tiles, bit for bit: rows then columns, every tap
    added in ``ops.stencil.separable_correlate``'s order, symmetric halos."""
    kernel = prepare_gaussian_kernel(sigma, ksize)
    half = ksize // 2
    p = exchange_halo(im, ((0, 0), (half, half)), "symmetric", mesh)
    w = im.shape[-1]
    out = None
    for j in range(ksize):
        t = p[..., :, j : j + w] * float(kernel[j])
        out = t if out is None else out + t
    p = exchange_halo(out, ((half, half), (0, 0)), "symmetric", mesh)
    h = im.shape[-2]
    out2 = None
    for i in range(ksize):
        t = p[..., i : i + h, :] * float(kernel[i])
        out2 = t if out2 is None else out2 + t
    return out2


def liu_shen_warp_sharded(im1, u, v, mesh):
    """``ops.warp.liu_shen_warp`` on this rank's tiles: the whole-image warp
    cropped to the tile, bit for bit, for every flow.

    The scatter has no reach bound (the flow sets how far a pixel moves,
    and a negative destination wraps to the image's far side), so it runs
    in the whole image's index space: each rank scatter-maxes its sources
    into an (H * W) buffer, one max all-reduce over y and x combines the
    ranks' buffers, and each rank keeps its own tile of it.  A source's key
    is its global row-major index in the high 32 bits and its intensity's
    bits in the low 32: the largest key at a destination is the last
    writer's and carries its pixel, so nothing else is fetched.  Then the
    residual flow's 73-tap Gaussian with a 36-cell symmetric apron
    (``prefilter_sharded``), and the correction from one cell of the lower
    and right neighbours, off on the image's last row and column.  Nothing
    is read on the host.  A tile shorter or narrower than the Gaussian's
    radius raises ``ValueError``."""
    (_, iy), (_, ix) = _split(mesh, _SPATIAL)
    img_h, img_w = global_shape(im1.shape, mesh)
    h, w = im1.shape[-2], im1.shape[-1]
    radius = LS_WARP_TAPS // 2
    if h < radius or w < radius:
        raise ValueError(f"liu_shen_warp (biLinear=False) on tiles: a tile of {(h, w)} is "
                         f"smaller than the residual Gaussian's radius, {radius} cells a side")
    dev = im1.device
    rows = (iy * h + torch.arange(h, device=dev))[:, None]
    cols = (ix * w + torch.arange(w, device=dev))[None, :]

    dst, ui, vi = liu_shen_destinations(rows, cols, u, v, img_h, img_w)
    bits = im1.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = ((rows * img_w + cols) << 32) | bits
    won = torch.full((img_h * img_w,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, dst.reshape(-1), key.reshape(-1), "amax")
    won = reduce_over(won, mesh, _SPATIAL, op="max").view(img_h, img_w)
    won = won[iy * h:(iy + 1) * h, ix * w:(ix + 1) * w]
    low = won & 0xFFFFFFFF
    pixel = (low - ((low >> 31) << 32)).to(torch.int32).view(torch.float32)
    shifted = torch.where(won >= 0, pixel, im1)

    du, dv = prefilter_sharded(torch.stack([u - ui, v - vi]), LS_WARP_SIGMA, LS_WARP_TAPS, mesh)
    p = exchange_halo(torch.stack([shifted, du, dv]), ((0, 1), (0, 1)), "constant", mesh)
    t_dx = p[0, :h, 1:] * p[1, :h, 1:] - shifted * du
    t_dy = p[0, 1:, :w] * p[2, 1:, :w] - shifted * dv
    inner = (rows < img_h - 1) & (cols < img_w - 1)
    return torch.where(inner, shifted + -(t_dx + t_dy), shifted)


class TileGlue:
    """The functions above bound to ``mesh``, with the interface of
    ``pyramid.py``'s single-device glue (``pyramid.DEVICE_GLUE``): the
    driver picks one of the two once a run."""

    def __init__(self, mesh):
        self.mesh = mesh

    def shape(self, tile_shape) -> tuple:
        return global_shape(tile_shape, self.mesh)

    def check_splits(self, shape, what: str) -> None:
        check_splits(shape, self.mesh, what)

    def resize(self, tile, out_global_hw, method):
        return pil_resize_sharded(tile, out_global_hw, method, self.mesh)

    def upsample(self, tile, out_global_hw):
        return spline_upsample_sharded(tile, out_global_hw, self.mesh)

    def warp_pair(self, im1, im2, u, v):
        return symmetric_warp_pair_sharded(im1, im2, u, v, self.mesh)

    def warp(self, im1, u, v):
        return liu_shen_warp_sharded(im1, u, v, self.mesh)

    def prefilter(self, im, sigma, ksize):
        return prefilter_sharded(im, sigma, ksize, self.mesh)
