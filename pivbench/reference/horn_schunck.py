"""Horn-Schunck in plain PyTorch: 2x2 derivative stencils and Jacobi
relaxation with the 1/12 [[1,2,1],[2,0,2],[1,2,1]] neighbour average,
mirror borders; one alpha a level from the calibration table."""

from __future__ import annotations

import numpy as np
import torch

from pivbench.reference.glue import pad2d

# (bit depth, seeding) -> (alpha at the finest level, alpha at coarser
# levels), the upstream's calibration for ~3 px particles
H_TABLE = {
    ("Bits08", "Ni01"): (6, 40), ("Bits08", "Ni06"): (21, 45),
    ("Bits08", "Ni12"): (30, 61), ("Bits08", "Ni16"): (34, 75),
    ("Bits10", "Ni01"): (20, 450), ("Bits10", "Ni06"): (77, 450),
    ("Bits10", "Ni12"): (119, 450), ("Bits10", "Ni16"): (131, 500),
    ("Bits12", "Ni01"): (82, 500), ("Bits12", "Ni06"): (325, 920),
    ("Bits12", "Ni12"): (470, 1260), ("Bits12", "Ni16"): (550, 1460),
}

TWELFTH = float(np.float32(1.0 / 12.0))
STAGE = "hs_iterate"


def average(x: torch.Tensor) -> torch.Tensor:
    """The HS neighbour average, separable: ([1,2,1] x [1,2,1] - 4 delta) / 12."""
    h, w = x.shape[-2:]
    xp = pad2d(x, 1, "mirror")
    p = xp[..., :, :w] + 2.0 * xp[..., :, 1:w + 1] + xp[..., :, 2:w + 2]
    q = p[..., :h, :] + 2.0 * p[..., 1:h + 1, :] + p[..., 2:h + 2, :]
    return (q - 4.0 * xp[..., 1:h + 1, 1:w + 1]) * TWELFTH


def derivatives(im1: torch.Tensor, im2: torch.Tensor):
    """(fx, fy, ft) from the 2x2 quads at (y..y+1, x..x+1), mirror border at
    the bottom and right; ft = quad mean of im1 minus that of im2."""
    def quads(im):
        p = pad2d(im, ((0, 1), (0, 1)), "mirror")
        return p[..., :-1, :-1], p[..., :-1, 1:], p[..., 1:, :-1], p[..., 1:, 1:]

    a1, b1, c1, d1 = quads(im1)
    a2, b2, c2, d2 = quads(im2)
    fx = (a1 - b1 + c1 - d1 + a2 - b2 + c2 - d2) * 0.25
    fy = (a1 + b1 - c1 - d1 + a2 + b2 - c2 - d2) * 0.25
    ft = (a1 + b1 + c1 + d1 - a2 - b2 - c2 - d2) * 0.25
    return fx, fy, ft


def solve(im1, im2, alpha: float, niter: int, u, v):
    """``niter`` Jacobi iterations from (u, v)."""
    fx, fy, ft = derivatives(im1, im2)
    a = np.float32(alpha)
    rdenom = 1.0 / (float(a * a) + fx * fx + fy * fy)
    for _ in range(int(niter)):
        ua, va = average(u), average(v)
        der = (fx * ua + fy * va + ft) * rdenom
        u, v = ua - fx * der, va - fy * der
    return u, v


class Solver:
    """The adapter: one alpha a call, the coarsest level first; the alphas
    are ``alphas`` as given, or the table's for ``calibration`` (bits,
    seeding)."""

    defaults = {"warping": True, "biLinear": True, "scaling": True}

    def __init__(self, params: dict, levels: int, prec):
        if "alphas" in params:
            self.alphas = [float(a) for a in params["alphas"]]
        else:
            h1, hn = H_TABLE[tuple(params["calibration"])]
            self.alphas = [h1] + [hn] * (levels - 1)
        self.niter = int(params["niter"])

    def compute(self, im1, im2, u, v, tally: list):
        alpha = self.alphas.pop()
        u, v = solve(im1, im2, float(alpha), self.niter, u, v)
        n = im1.shape[0]
        tally.append({"stage": STAGE, "shape": tuple(im1.shape[-2:]),
                      "counts": [self.niter] * n})
        return u, v
