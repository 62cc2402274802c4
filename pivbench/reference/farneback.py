"""Farnebäck in plain PyTorch, on stacks of pairs: OpenCV's bit-exact
Gaussian taps, the polynomial expansion (nine separable correlations with
a replicate border and the Gram-inverse combination), updateMatrices (R1
sampled bilinearly at the displaced position, blended with R0, the border
ramp, the five products of M) and the window blur with the regularised
2x2 solve, over a plan of levels cropped at 32 pixels."""

from __future__ import annotations

from decimal import Decimal, getcontext
from functools import lru_cache

import numpy as np
import torch

from pivbench.reference.glue import correlate1d, exact, resize

STAGE = "fb_iterate"
BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472, 1.0], np.float32)
SAMPLE_MAX_SHIFT = 5
_BINOMIAL = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
             7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
             9: [4 / 256, 13 / 256, 30 / 256, 51 / 256, 60 / 256, 51 / 256, 30 / 256,
                 13 / 256, 4 / 256]}


@lru_cache(maxsize=None)
def opencv_gaussian(n: int, sigma: float) -> np.ndarray:
    """OpenCV's soft-float Gaussian taps: the binomial kernels for sigma <= 0
    and n <= 9; otherwise sigma = n 0.15 + 0.35 for any sigma >= 0 (OpenCV
    ignores a positive sigma here), taps exp(-x^2 / (8 sigma^2)) at the
    doubled offsets, normalised in 28-digit decimals."""
    if sigma <= 0 and n in _BINOMIAL:
        return np.float32(_BINOMIAL[n])
    getcontext().prec = 28
    s = Decimal(sigma) if sigma < 0 else Decimal(n) * Decimal("0.15") + Decimal("0.35")
    c = Decimal("-0.125") / (s * s)
    half = (n - 1) // 2
    tail = [(Decimal(x * x) * c).exp() for x in range(1 - n, 1 - n + 2 * half, 2)]
    inv = Decimal(1) / (sum(tail, Decimal(0)) * 2 + 1 + (1 if n % 2 == 0 else 0))
    k = [t * inv for t in tail]
    centre = [inv] * (2 if n % 2 == 0 else 1)
    return np.float32([float(t) for t in k + centre + k[::-1]])


@lru_cache(maxsize=None)
def poly_basis(n: int, sigma: float):
    """g, xg, xxg and the four Gram-inverse constants of the expansion."""
    if sigma < 1.1920928955078125e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-x * x / (2 * sigma * sigma))
    g = np.float32(g / g.sum())
    gd = g.astype(np.float64)
    gram = np.zeros((6, 6))
    for yy in range(-n, n + 1):
        for xx in range(-n, n + 1):
            wt = gd[yy + n] * gd[xx + n]
            gram[0, 0] += wt
            gram[1, 1] += wt * xx * xx
            gram[3, 3] += wt * xx**4
            gram[5, 5] += wt * xx * xx * yy * yy
    gram[2, 2] = gram[0, 3] = gram[0, 4] = gram[3, 0] = gram[4, 0] = gram[1, 1]
    gram[4, 4] = gram[3, 3]
    gram[3, 4] = gram[4, 3] = gram[5, 5]
    inv = np.linalg.inv(gram)
    return (g, np.float32(x * g), np.float32(x * x * g),
            tuple(float(np.float32(inv[i, j])) for i, j in ((1, 1), (0, 3), (3, 3), (5, 5))))


def expand(src: torch.Tensor, n: int, sigma: float, operand=exact) -> torch.Tensor:
    """(..., H, W) -> (..., 5, H, W) polynomial expansion."""
    g, xg, xxg, (i11, i03, i33, i55) = poly_basis(n, float(sigma))

    def corr(x, k, axis):
        return correlate1d(x, k, axis, "nearest", operand)

    ve, vo, vx2 = (corr(src, k, -2) for k in (g, xg, xxg))
    b1, b2, b4 = (corr(ve, k, -1) for k in (g, xg, xxg))
    b3, b6 = (corr(vo, k, -1) for k in (g, xg))
    b5 = corr(vx2, g, -1)
    return torch.stack([b3 * i11, b2 * i11, b1 * i03 + b5 * i33, b1 * i03 + b4 * i33,
                        b6 * i55], dim=-3)


def _ramp(rows: int, cols: int, like: torch.Tensor) -> torch.Tensor:
    xi, yi = np.arange(cols), np.arange(rows)
    rx = BORDER_RAMP[np.minimum(xi, 5)][None, :]
    ry = BORDER_RAMP[np.minimum(yi, 5)][:, None]
    rcx = BORDER_RAMP[np.minimum(cols - xi - 1, 5)][None, :]
    rcy = BORDER_RAMP[np.minimum(rows - yi - 1, 5)][:, None]
    return torch.from_numpy(rx * ry * rcx * rcy).to(like.device)


def update_matrices(fx, fy, r0, r1):
    """M (..., 5, H, W) from the flow (..., H, W) and the expansions R0, R1."""
    n, _, rows, cols = r0.shape
    dev = r0.device
    ys = torch.arange(rows, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(cols, dtype=torch.float32, device=dev)[None, :]
    x1 = torch.floor(xs + fx)
    y1 = torch.floor(ys + fy)
    inside = (x1 >= 0) & (y1 >= 0) & (x1 < cols - 1) & (y1 < rows - 1)
    r = SAMPLE_MAX_SHIFT
    hi = float(np.float32(r - 1e-3))
    dx, dy = fx.clamp(-float(r), hi), fy.clamp(-float(r), hi)
    sx, sy = torch.floor(dx), torch.floor(dy)
    wx, wy = dx - sx, dy - sy
    y0 = (ys.long() + sy.long()).clamp(0, rows - 1)
    y1i = (ys.long() + sy.long() + 1).clamp(0, rows - 1)
    x0 = (xs.long() + sx.long()).clamp(0, cols - 1)
    x1i = (xs.long() + sx.long() + 1).clamp(0, cols - 1)
    flat = r1.reshape(n, 5, rows * cols)

    def at(iy, ix):
        idx = (iy * cols + ix).reshape(n, 1, rows * cols).expand(n, 5, rows * cols)
        return flat.gather(2, idx).reshape(n, 5, rows, cols)

    s = ((1.0 - wy) * (1.0 - wx))[:, None] * at(y0, x0) \
        + ((1.0 - wy) * wx)[:, None] * at(y0, x1i) \
        + (wy * (1.0 - wx))[:, None] * at(y1i, x0) \
        + (wy * wx)[:, None] * at(y1i, x1i)
    ins = inside
    r2 = torch.where(ins, s[:, 0], 0.0)
    r3 = torch.where(ins, s[:, 1], 0.0)
    r4 = torch.where(ins, (r0[:, 2] + s[:, 2]) * 0.5, r0[:, 2])
    r5 = torch.where(ins, (r0[:, 3] + s[:, 3]) * 0.5, r0[:, 3])
    r6 = torch.where(ins, (r0[:, 4] + s[:, 4]) * 0.25, r0[:, 4] * 0.5)
    r2 = (r0[:, 0] - r2) * 0.5
    r3 = (r0[:, 1] - r3) * 0.5
    r2 = r2 + r4 * fy + r6 * fx
    r3 = r3 + r6 * fy + r5 * fx
    scale = _ramp(rows, cols, r0)
    r2, r3, r4, r5, r6 = (t * scale for t in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=1)


def blur_solve(m, taps, mode: str, scale: float, operand=exact):
    """Window-blur the five planes of M (rows, then columns), then the
    regularised 2x2 solve for the flow."""
    out = correlate1d(correlate1d(m, taps, -2, mode, operand), taps, -1, mode, operand)
    if scale != 1.0:
        out = out * float(np.float32(scale))
    g11, g12, g22, h1, h2 = out.unbind(1)
    det_inv = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * det_inv, (g22 * h1 - g12 * h2) * det_inv


def level_plan(rows: int, cols: int, pyr_scale: float, levels: int) -> list:
    """(scale, sigma, smooth, height, width) of each level, coarsest first,
    no level under 32 pixels."""
    s, final = 1.0, 0
    while final < levels:
        s *= pyr_scale
        if cols * s < 32 or rows * s < 32:
            break
        final += 1
    plan = []
    for k in range(final, -1, -1):
        sc = pyr_scale**k
        sigma = (1.0 / sc - 1.0) * 0.5
        plan.append((sc, sigma, max(int(round(sigma * 5)) | 1, 3),
                     int(round(rows * sc)), int(round(cols * sc))))
    return plan


def solve(im1, im2, u, v, p: dict, prec, tally: list):
    """The whole Farnebäck solve of a block of pairs from the flow (u, v)."""
    mm, rnd = prec.matmul, prec.operand
    window, n_iters = int(p["window"]), int(p["iterations"])
    if p.get("gaussian", True):
        taps, mode, post = opencv_gaussian(window, window / 2 * 0.3), "mirror", 1.0
    else:
        half = window // 2
        taps, mode, post = np.ones(2 * half + 1, np.float32), "nearest", 1.0 / (2 * half + 1) ** 2
    rows, cols = im1.shape[-2:]
    plan = level_plan(rows, cols, float(p.get("pyr_scale", 0.5)), int(p.get("levels", 1)) - 1)
    prev = None
    for sc, sigma, smooth, h, w in plan:
        src, f = ((u, v), sc) if prev is None else (prev, 1.0 / float(p.get("pyr_scale", 0.5)))
        f = float(np.float32(f))
        fx, fy = (resize(t, (h, w), "bilinear", mm) * f for t in src)
        ra, rb = (expand(resize(_blur(im, smooth, sigma, rnd), (h, w), "bilinear", mm),
                         int(p["poly_n"]), float(p["poly_sigma"]), rnd) for im in (im1, im2))
        for _ in range(n_iters):
            fx, fy = blur_solve(update_matrices(fx, fy, ra, rb), taps, mode, post, rnd)
        tally.append({"stage": STAGE, "shape": (h, w), "counts": [n_iters] * im1.shape[0],
                      "params": {"taps": int(np.asarray(taps).size)}})
        prev = (fx, fy)
    return prev


def _blur(im, n: int, sigma: float, operand=exact):
    """OpenCV's separable Gaussian of the frame, reflect-101 border."""
    k = opencv_gaussian(n, sigma)
    return correlate1d(correlate1d(im, k, -2, "mirror", operand), k, -1, "mirror", operand)


class Solver:
    """The adapter: the Farnebäck solve from the driver's flow."""

    defaults = {"warping": False, "scaling": True}

    def __init__(self, params: dict, levels: int, prec):
        self.p, self.prec = dict(params), prec

    def compute(self, im1, im2, u, v, tally: list):
        return solve(im1, im2, u, v, self.p, self.prec, tally)
