"""Sub-pixel image warping for the pyramidal driver (port of ``ops/warp.py``).

  * ``symmetric_warp_pair`` — the driver's default "BiLinear" warp: im1
    backwards by half the flow, im2 forwards.  With ``max_shift`` set (the
    driver's R=8) it goes through the Hopper kernel ``warp_pair``
    (``ops/cuda/warp_tent.py``), whose plain version
    ``displacement_warp_tent`` is re-exported here.
  * ``bilinear_warp_rounded`` — the reference's round-to-nearest +
    signed-neighbour scheme, unclamped, for ``max_shift=None``.
  * ``liu_shen_warp`` — not ported yet (Liu-Shen slice).
"""

from __future__ import annotations

import torch

from opticalflow_ri_tpu_torch.ops.cuda import warp_tent
from opticalflow_ri_tpu_torch.ops.cuda.warp_tent import displacement_warp_tent

__all__ = ["bilinear_warp_rounded", "displacement_warp_tent", "symmetric_warp_pair",
           "liu_shen_warp"]


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


def liu_shen_warp(im1: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Optical-flow-equation warp (``biLinear=False``); no HS config uses it."""
    raise NotImplementedError(
        "liu_shen_warp is not ported yet: it arrives with the Liu-Shen slice "
        "(ROADMAP.md Queue 1, item 4)")
