"""Dense windowed Lucas-Kanade in plain PyTorch, on stacks of pairs: the
semantics of the OpenCL kernel ``src/pyrlkDenseLargeW.cl`` of the upstream
(alexlib/OpticalFlow-RI), as its literal per-pixel form writes them down:

  * both frames replicate-padded (the sampler's CLAMP_TO_EDGE);
  * gradients of the first frame with the weights 3/10/3;
  * 0/1 window weights over the kernel's 32-sample grid (``window_length``,
    the kernel's tile rules for a symmetric window; halfWindow 13 gives the
    27 offsets -13..13);
  * the structure tensor A over the window, and a window whose
    det A < 1.192092896e-7 keeps the input flow;
  * up to ``n_iter`` Gauss-Newton steps a pixel, delta = -A^-1 b x 32 with
    b the window sum of (J sampled bilinearly at the displaced window - I)
    times the gradient, a pixel leaving the loop when both |delta| < 0.01
    or when its window origin leaves [-halfWindow, W) x [-halfWindow, H).

Two departures from that per-pixel loop, each written where it is made:

  * **Shift planes.**  The window is separable and its bilinear weights are
    the same at every sample of it, so the window sum of the sampled J
    times a gradient g is the bilinear blend, at the pixel's displacement,
    of the four planes T_g[s] = sum_window J(. + s) g at the enclosing
    integer shifts s.  The planes of every shift in [-R, R]^2 are built
    once a solve with plain separable box sums (the window's columns, then
    its rows), and each step blends four of them, rows first, with tent
    weights.  This is the per-pixel loop's arithmetic reordered; the tests
    hold it against the literal form at float32 round-off.  The order is
    fixed down to the last add: each window sum is a ladder of partial
    sums (27 = 3 x 3 x 3 samples: ``ladder``), the order of the program's
    dense-LK kernels.  A pixel whose Gauss-Newton steps run away (a step
    of tens of px, then the clamp below) turns a last-bit difference of
    its sums into px of flow, which the Liu-Shen refiner then spreads over
    its neighbours: summed tap after tap, one such pixel in 768 pairs of
    1 MP moved the refined flow by 0.045 px.
  * **The clamp.**  The displacement is clamped to [-R, R - 1e-3] before
    its integer shift is taken (R = ``max_shift`` = 5), so a flow beyond R
    px reads the planes of the last shift where the per-pixel loop samples
    further out.

Every constant is computed here from its definition; nothing comes from
the program under test.  The tally gives two entries a level: ``lk_build``
(one plane build a pair) and ``lk_iterate`` (the Gauss-Newton steps a
pixel ran, the pair's mean over the level: a step counts where the pixel
was still in the loop after the window test).
"""

from __future__ import annotations

import numpy as np
import torch

from pivbench.reference.glue import exact, pad2d

GRID = 32
DET_EPS = float(np.float32(1.192092896e-07))
STEP_EPS = float(np.float32(0.01))
STAGE_BUILD = "lk_build"
STAGE_ITERATE = "lk_iterate"


def window_length(half_window: int) -> int:
    """The window's samples along each axis.  The kernel weighs the 32 grid
    columns in tiles of 8: the first tile and the first column of the
    second are always on (no side of the window is cut), the others below
    2 halfWindow + 1; the ones run from the first column."""
    win = 2 * int(half_window) + 1
    return min(max(win, 9), GRID)


def ladder(length: int) -> list:
    """The factors (2, 3 or 5, ascending) of the longest partial window that
    a ladder of sums builds for a window of ``length`` samples: the
    factorisation whose adds, f - 1 a factor plus one a sample left over,
    are fewest (ties to the longer)."""
    best = (length - 1, [])
    for part in range(length, 0, -1):
        m, factors = part, []
        for f in (2, 3, 5):
            while m % f == 0:
                m //= f
                factors.append(f)
        adds = sum(f - 1 for f in factors) + length - part
        if m == 1 and adds < best[0]:
            best = (adds, factors)
    return best[1]


def window_sum(x: torch.Tensor, length: int, out_len: int, dim: int) -> torch.Tensor:
    """sum_{k < length} x[i + k] along ``dim`` for i < ``out_len``, built as
    a ladder, S_{m f}(i) = S_m(i) + S_m(i + m) + ... + S_m(i + (f - 1) m)
    from S_1 = x over ``ladder(length)``'s factors, plus the samples past
    its length one by one."""
    s, m = x, 1
    for f in ladder(length):
        n = s.shape[dim] - (f - 1) * m
        acc = s.narrow(dim, 0, n)
        for j in range(1, f):
            acc = acc + s.narrow(dim, j * m, n)
        s, m = acc, m * f
    out = s.narrow(dim, 0, out_len)
    for k in range(m, length):
        out = out + x.narrow(dim, k, out_len)
    return out


def box(x: torch.Tensor, length: int, h: int, w: int) -> torch.Tensor:
    """The window sums of x for the (h, w) pixels, the columns' pass first;
    ``x`` covers the grid's offsets from each pixel, its index 0 the offset
    -halfWindow."""
    return window_sum(window_sum(x, length, w, -1), length, h, -2)


def gradients(p: torch.Tensor) -> tuple:
    """(gx, gy) of a padded frame at its interior samples, weights 3/10/3."""
    gx = 3.0 * (p[..., :-2, 2:] + p[..., 2:, 2:] - p[..., :-2, :-2] - p[..., 2:, :-2]) + 10.0 * (
        p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
    gy = 3.0 * (p[..., 2:, :-2] + p[..., 2:, 2:] - p[..., :-2, :-2] - p[..., :-2, 2:]) + 10.0 * (
        p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
    return gx, gy


def solve(im1, im2, u0, v0, half_window: int = 13, n_iter: int = 5, max_shift: int = 5,
          operand=exact):
    """Dense LK of each pair of the (N, H, W) block from the start flow
    (u0, v0); returns (u, v, steps), steps the (N,) mean over the pixels of
    the Gauss-Newton steps each ran.  ``operand`` rounds the operands of the
    window sums' products (the control's lower precision)."""
    hw, R = int(half_window), int(max_shift)
    n, h, w = im1.shape
    length = window_length(hw)
    pad = GRID + R + 1
    ipad = pad2d(im1.to(torch.float32), pad, "nearest")
    jpad = pad2d(im2.to(torch.float32), pad, "nearest")
    ch, cw = h + GRID - 1, w + GRID - 1      # the grid's offsets -hw .. 31 - hw of every pixel
    o = pad - hw                             # where offset -hw lies in the padded frames
    gx, gy = (operand(g[..., o - 1:o - 1 + ch, o - 1:o - 1 + cw]) for g in gradients(ipad))
    icore = operand(ipad[..., o:o + ch, o:o + cw])

    a11, a12, a22 = (box(gx * gx, length, h, w), box(gx * gy, length, h, w),
                     box(gy * gy, length, h, w))
    c1, c2 = box(icore * gx, length, h, w), box(icore * gy, length, h, w)
    det = a11 * a22 - a12 * a12
    ok = det >= DET_EPS
    det = torch.where(ok, det, torch.ones_like(det))
    ia11, ia12, ia22 = a11 / det, a12 / det, a22 / det

    # T_g[s] for s = (sy, sx) in [-R, R]^2, sy-major: (N, (2R+1)^2, H, W) a gradient
    nshift = 2 * R + 1
    g = torch.stack([gx, gy], dim=1)[:, None]                      # (N, 1, 2, ch, cw)
    t1 = torch.empty((n, nshift * nshift, h, w), dtype=torch.float32, device=im1.device)
    t2 = torch.empty_like(t1)
    for a, sy in enumerate(range(-R, R + 1)):
        rows = jpad[..., o + sy:o + sy + ch, :]
        js = torch.stack([operand(rows[..., o + sx:o + sx + cw]) for sx in range(-R, R + 1)],
                         dim=1)                                      # (N, 2R+1, ch, cw)
        planes = box(js[:, :, None] * g, length, h, w)               # (N, 2R+1, 2, H, W)
        t1[:, a * nshift:(a + 1) * nshift] = planes[:, :, 0]
        t2[:, a * nshift:(a + 1) * nshift] = planes[:, :, 1]
        del js, planes

    u0, v0 = u0.to(torch.float32), v0.to(torch.float32)
    px, py, steps = gauss_newton(t1, t2, c1, c2, ia11, ia12, ia22, ok, u0, v0, hw, n_iter, R)
    jj, ii = pixel_grid(h, w, im1.device)
    u = torch.where(ok, px + hw - jj, u0)
    v = torch.where(ok, py + hw - ii, v0)
    return u, v, steps.mean(dim=(-2, -1))


def pixel_grid(h: int, w: int, device) -> tuple:
    """The columns and rows of an (h, w) field, float32, broadcast over pairs."""
    return (torch.arange(w, dtype=torch.float32, device=device)[None, None, :],
            torch.arange(h, dtype=torch.float32, device=device)[None, :, None])


def tent(d: torch.Tensor) -> torch.Tensor:
    """The bilinear weight max(0, 1 - |d|) of a shift at distance d."""
    return (1.0 - d.abs()).clamp_min(0.0)


def gauss_newton(t1, t2, c1, c2, ia11, ia12, ia22, ok, u0, v0, hw: int, n_iter: int, R: int):
    """The per-pixel loop on the planes: (px, py, steps), the final window
    origins and the steps each pixel ran (a step counts where the pixel is
    still in the loop after the window test)."""
    n, _, h, w = t1.shape
    nshift = 2 * R + 1
    jj, ii = pixel_grid(h, w, t1.device)
    px, py = jj + u0 - hw, ii + v0 - hw                              # the window's origin
    active = ok.clone()
    steps = torch.zeros((n, h, w), dtype=torch.float32, device=t1.device)
    lo, hi = float(-R), float(np.float32(R - 1e-3))
    for _ in range(int(n_iter)):
        active &= ~((px < -hw) | (px >= w) | (py < -hw) | (py >= h))
        if not bool(active.any()):
            break
        steps += active.to(torch.float32)
        du = (px + hw - jj).clamp(lo, hi)
        dv = (py + hw - ii).clamp(lo, hi)
        sx, sy = torch.floor(du), torch.floor(dv)
        wx0, wx1 = tent(du - sx), tent(du - (sx + 1.0))
        wy0, wy1 = tent(dv - sy), tent(dv - (sy + 1.0))
        s00 = ((sy + R) * nshift + (sx + R)).long()[:, None]

        def blend(t):
            q00, q01 = t.gather(1, s00)[:, 0], t.gather(1, s00 + 1)[:, 0]
            q10, q11 = t.gather(1, s00 + nshift)[:, 0], t.gather(1, s00 + nshift + 1)[:, 0]
            return wx0 * (wy0 * q00 + wy1 * q10) + wx1 * (wy0 * q01 + wy1 * q11)

        b1, b2 = blend(t1) - c1, blend(t2) - c2
        dx = (ia12 * b2 - ia22 * b1) * 32.0
        dy = (ia12 * b1 - ia11 * b2) * 32.0
        px = torch.where(active, px + dx, px)
        py = torch.where(active, py + dy, py)
        active &= ~((dx.abs() < STEP_EPS) & (dy.abs() < STEP_EPS))
    return px, py, steps


class Solver:
    """The adapter: its pyramid defaults (no warping, the flow scaled
    between levels but the last) and the solve from the driver's flow."""

    defaults = {"warping": False, "intermediateScaling": True, "scaling": False}

    def __init__(self, params: dict, levels: int, prec):
        self.half_window = int(params.get("half_window", 13))
        self.n_iter = int(params.get("n_iter", 5))
        self.max_shift = int(params.get("max_shift", 5))
        self.operand = prec.operand

    def compute(self, im1, im2, u, v, tally: list):
        u, v, steps = solve(im1, im2, u, v, self.half_window, self.n_iter, self.max_shift,
                            self.operand)
        shape = tuple(im1.shape[-2:])
        tally.append({"stage": STAGE_BUILD, "shape": shape, "counts": [1] * im1.shape[0]})
        tally.append({"stage": STAGE_ITERATE, "shape": shape, "counts": steps.tolist()})
        return u, v
