"""Liu-Shen's continuity-equation refiner in plain PyTorch: the MATLAB
stencils as correlations, "nearest" borders except the zero-padded
neighbour terms, both frames normalised by their own maxima, and the
fixed-point solve stopped per pair as soon as
(||du||_F + ||dv||_F) / (H W) <= tol, or after ``max_iter`` steps.
The solver's first component runs along rows; the adapter swaps."""

from __future__ import annotations

import numpy as np
import torch

from pivbench.reference.glue import correlate3x3, pad2d

K_D1 = np.array([[0, -1, 0], [0, 0, 0], [0, 1, 0]], np.float32) / 2.0
K_D2 = K_D1.T
K_M = np.array([[1, 0, -1], [0, 0, 0], [-1, 0, 1]], np.float32) / 4.0
K_D2ND = np.array([[0, 1, 0], [0, -2, 0], [0, 1, 0]], np.float32)
K_H = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]], np.float32)

STAGE = "ls_iterate"


def fields(im1, im2, h: float):
    """The eight fields the iteration reads: image products, right-hand-side
    constants and the per-pixel inverse of the 2x2 system."""
    def d1(x):
        return correlate3x3(x, K_D1, "nearest")

    def d2(x):
        return correlate3x3(x, K_D2, "nearest")

    dt = im2 - im1
    h = float(np.float32(h))
    cmtx = correlate3x3(torch.ones_like(im1), K_H, "constant")
    a11 = im1 * (correlate3x3(im1, K_D2ND, "nearest") - 2.0 * im1) - h * cmtx
    a22 = im1 * (correlate3x3(im1, K_D2ND.T, "nearest") - 2.0 * im1) - h * cmtx
    a12 = im1 * correlate3x3(im1, K_M, "nearest")
    det = a11 * a22 - a12 * a12
    return (im1 * d1(im1), im1 * d2(im1), im1 * im1, im1 * d1(dt), im1 * d2(dt),
            a22 / det, -a12 / det, a11 / det)


def _stencils(z):
    """(d1, d2, f1, f2, m) of one field, nearest border."""
    h, w = z.shape[-2:]
    zp = pad2d(z, 1, "nearest")

    def c(dy, dx):
        return zp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    rdiff = zp[..., :, 2:] - zp[..., :, :-2]
    return ((c(1, 0) - c(-1, 0)) * 0.5, (c(0, 1) - c(0, -1)) * 0.5,
            c(-1, 0) + c(1, 0), c(0, -1) + c(0, 1),
            (rdiff[..., 2:, :] - rdiff[..., :-2, :]) * 0.25)


def _ring(z):
    """The 8-neighbour sum, zeros beyond the border."""
    h, w = z.shape[-2:]
    zp = pad2d(z, 1, "constant")
    p = zp[..., :-2, :] + zp[..., 1:-1, :] + zp[..., 2:, :]
    q = p[..., :, :w] + p[..., :, 1:w + 1] + p[..., :, 2:w + 2]
    return q - zp[..., 1:h + 1, 1:w + 1]


def step(u, v, f, h: float):
    """One fixed-point update."""
    iix, iiy, ii, ixt, iyt, b11, b12, b22 = f
    h = float(np.float32(h))
    du1, du2, fu1, _, mu = _stencils(u)
    dv1, dv2, _, fv2, mv = _stencils(v)
    bu = iix * (2.0 * du1 + dv2) + iiy * dv1 + ii * (fu1 + mv) + h * _ring(u) + ixt
    bv = iiy * (du1 + 2.0 * dv2) + iix * du2 + ii * (mu + fv2) + h * _ring(v) + iyt
    return -(b11 * bu + b12 * bv), -(b12 * bu + b22 * bv)


def solve(im1, im2, h: float, u, v, max_iter: int, tol: float):
    """The stopped fixed-point solve of each pair of the block; returns
    (u, v, k), k the steps each pair ran."""
    im1 = im1 / im1.amax(dim=(-2, -1), keepdim=True)
    im2 = im2 / im2.amax(dim=(-2, -1), keepdim=True)
    f = fields(im1, im2, h)
    n = im1.shape[0]
    npix = float(im1.shape[-2] * im1.shape[-1])
    tol = float(np.float32(tol))
    k = torch.zeros(n, dtype=torch.int64, device=im1.device)
    active = torch.ones(n, dtype=torch.bool, device=im1.device)
    for _ in range(int(max_iter)):
        if not bool(active.any()):
            break
        un, vn = step(u, v, f, h)
        err = (torch.linalg.vector_norm(un - u, dim=(-2, -1))
               + torch.linalg.vector_norm(vn - v, dim=(-2, -1))) / npix
        keep = active[:, None, None]
        u, v = torch.where(keep, un, u), torch.where(keep, vn, v)
        k = k + active.long()
        active = active & (err > tol)
    return u, v, k


class Solver:
    """The adapter: the solve on (V, U), its result swapped back."""

    defaults = None

    def __init__(self, params: dict, levels: int, prec):
        self.h = float(params["h"])
        self.max_iter = int(params.get("max_iter", 60))
        self.tol = float(params.get("tol", 1e-8))

    def compute(self, im1, im2, u, v, tally: list):
        rows, cols, k = solve(im1, im2, self.h, v, u, self.max_iter, self.tol)
        tally.append({"stage": STAGE, "shape": tuple(im1.shape[-2:]),
                      "counts": k.tolist()})
        return cols, rows
