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

A matmul over a sliced or gathered K need not add in the single-device
order, so a resize on tiles may differ from the whole-image one in the last
bits; the warp and the pre-filters do not.

Every level's global shape must split over the mesh: a shape that does not
raises ``ValueError``.  ``liu_shen_warp`` (``biLinear=False``) scatters by
the flow with wrap-around, a global operation: on a mesh of more than one
rank it raises ``NotImplementedError`` (no configuration uses it).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import warp_tent
from opticalflow_ri_tpu_torch.ops.gaussian import prepare_gaussian_kernel
from opticalflow_ri_tpu_torch.ops.resize import pil_resize_matrix, spline_resize_matrix
from opticalflow_ri_tpu_torch.parallel.halo import exchange_halo, gather_axis
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
    """``ops.warp.liu_shen_warp`` scatters by the flow with wrap-around: not
    ported to tiles (ROADMAP.md, Queue 1).  Raises on a mesh of more than
    one rank; a one-rank mesh runs the single-device warp."""
    if mesh.size() > 1:
        raise NotImplementedError(
            "liu_shen_warp (biLinear=False) on a mesh of more than one rank: the scatter by the "
            "flow wraps around the whole image and has no tile form yet (ROADMAP.md, Queue 1)")
    from opticalflow_ri_tpu_torch.ops.warp import liu_shen_warp

    return liu_shen_warp(im1, u, v)


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
