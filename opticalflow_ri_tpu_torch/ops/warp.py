"""Sub-pixel image warping for the pyramidal driver (port of ``ops/warp.py``).

  * ``symmetric_warp_pair`` — the driver's default "BiLinear" warp: im1
    backwards by half the flow, im2 forwards.  With ``max_shift`` set (the
    driver's R=8) it goes through the Hopper kernel ``warp_pair``
    (``ops/cuda/warp_tent.py``), whose plain version
    ``displacement_warp_tent`` is re-exported here.
  * ``bilinear_warp_rounded`` — the reference's round-to-nearest +
    signed-neighbour scheme, unclamped, for ``max_shift=None``.
  * ``liu_shen_warp`` — the optical-flow-equation warp of ``biLinear=False``:
    integer scatter shift plus a first-order intensity correction from the
    smoothed sub-pixel residual flow.  Duplicate destinations resolve as
    numpy's fancy assignment does (last writer in row-major source order),
    as a scatter-max of source linear indices followed by a gather.  No TPU
    kernel lies behind it: it is plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from opticalflow_ri_tpu_torch.ops.cuda import warp_tent
from opticalflow_ri_tpu_torch.ops.gaussian import gaussian_filter_px
from opticalflow_ri_tpu_torch.ops.cuda.warp_tent import displacement_warp_tent

__all__ = ["bilinear_warp_rounded", "displacement_warp_tent", "symmetric_warp_pair",
           "liu_shen_warp", "liu_shen_destinations"]

# liu_shen_warp's Gaussian of the residual flow: sigma 1.8 truncated at 20
# sigma (``ops/warp.py:167-168`` there), 73 taps, a radius of 36
LS_WARP_SIGMA = 0.6 * 3
LS_WARP_TAPS = 2 * int(4.0 / 0.6 * 3 * LS_WARP_SIGMA + 0.5) + 1


def bilinear_warp_rounded(img: torch.Tensor, coords_y: torch.Tensor,
                          coords_x: torch.Tensor) -> torch.Tensor:
    """Warp ``img`` sampling at (coords_y, coords_x) with the reference's
    round-to-nearest (half-even) + signed-neighbour bilinear scheme, taps
    clamped to the image (``ops/warp.py:35-66``)."""
    h, w = img.shape[-2], img.shape[-1]

    iy = torch.round(coords_y).to(torch.int64)
    ix = torch.round(coords_x).to(torch.int64)
    dy = coords_y - iy
    dx = coords_x - ix

    iyn = torch.where(dy < 0, iy - 1, iy + 1)
    ixn = torch.where(dx < 0, ix - 1, ix + 1)
    dy = dy.abs()
    dx = dx.abs()

    iy = iy.clamp(0, h - 1)
    iyn = iyn.clamp(0, h - 1)
    ix = ix.clamp(0, w - 1)
    ixn = ixn.clamp(0, w - 1)

    return (
        (1 - dy) * (1 - dx) * img[iy, ix]
        + (1 - dy) * dx * img[iy, ixn]
        + dy * (1 - dx) * img[iyn, ix]
        + dy * dx * img[iyn, ixn]
    ).to(torch.float32)


def symmetric_warp_pair(im1: torch.Tensor, im2: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor, max_shift: int | None = 8):
    """Symmetric half-displacement warp of an image pair: im1 by (-v/2, -u/2),
    im2 by (+v/2, +u/2) (``ops/warp.py:116-139``)."""
    if max_shift is not None:
        return warp_tent.warp_pair(im1, im2, -v / 2.0, -u / 2.0, v / 2.0, u / 2.0, max_shift)
    h, w = im1.shape[-2], im1.shape[-1]
    ys = torch.arange(h, dtype=torch.float32, device=im1.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=im1.device)[None, :].expand(h, w)
    w1 = bilinear_warp_rounded(im1, ys - v / 2.0, xs - u / 2.0)
    w2 = bilinear_warp_rounded(im2, ys + v / 2.0, xs + u / 2.0)
    return w1, w2


def liu_shen_destinations(rows: torch.Tensor, cols: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor, h: int, w: int):
    """(dst, ui, vi) of ``liu_shen_warp``'s scatter: the row-major index in
    the (h, w) image that the sources at (rows, cols) move to, by
    floor(d + 0.5), negative indices wrapping and the high end clipped, and
    the rounded flow itself."""
    ui = torch.floor(u + 0.5)
    vi = torch.floor(v + 0.5)
    xdst = cols + ui.to(torch.int64)
    ydst = rows + vi.to(torch.int64)
    xdst = torch.where(xdst < 0, xdst + w, xdst).clamp(0, w - 1)
    ydst = torch.where(ydst < 0, ydst + h, ydst).clamp(0, h - 1)
    return ydst * w + xdst, ui, vi


def liu_shen_warp(im1: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Optical-flow-equation warp of im1 by (u, v) (``ops/warp.py:142-174``):
    shift by floor(d + 0.5), negative indices wrapping and the high end
    clipped, then subtract the first-order correction of the residual flow
    smoothed by a 73-tap Gaussian (sigma 1.8)."""
    h, w = im1.shape[-2], im1.shape[-1]
    ys = torch.arange(h, device=im1.device)[:, None].expand(h, w)
    xs = torch.arange(w, device=im1.device)[None, :].expand(h, w)
    dst, ui, vi = liu_shen_destinations(ys, xs, u, v, h, w)
    # last writer wins: each destination takes its largest source index
    dst = dst.reshape(-1)
    src = torch.arange(h * w, device=im1.device)
    winner = torch.full((h * w,), -1, dtype=torch.int64, device=im1.device).scatter_reduce(
        0, dst, src, "amax")
    flat = im1.reshape(-1)
    shifted = torch.where(winner >= 0, flat[winner.clamp_min(0)], flat).reshape(h, w)

    du = gaussian_filter_px(u - ui, LS_WARP_SIGMA, LS_WARP_TAPS)
    dv = gaussian_filter_px(v - vi, LS_WARP_SIGMA, LS_WARP_TAPS)

    t_dx = shifted[:-1, 1:] * du[:-1, 1:] - shifted[:-1, :-1] * du[:-1, :-1]
    t_dy = shifted[1:, :-1] * dv[1:, :-1] - shifted[:-1, :-1] * dv[:-1, :-1]
    shifted[:-1, :-1] += -(t_dx + t_dy)  # shifted is a fresh tensor
    return shifted
