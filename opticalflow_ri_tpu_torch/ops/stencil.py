"""3x3 correlation, Horn-Schunck stencils and separable 1-D correlation (port
of ``ops/stencil.py``).

Every sum keeps the association order of the JAX package, e.g.
``(l + 2·c) + r`` and then ``(q − 4x)·(1/12)``: float32 round-off then agrees
with the reference to ~1e-6, and the Hopper HS kernel (``csrc/hs_jacobi.cu``)
reproduces this order exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.padding import pad2d

TWELFTH = float(np.float32(1.0 / 12.0))


def correlate3x3(x: torch.Tensor, k: np.ndarray, mode: str) -> torch.Tensor:
    """Correlate the trailing 2 dims of ``x`` with a static 3x3 kernel ``k``,
    out(y,x) = sum_ij k[i,j]·in[y+i-1, x+j-1]; zero taps are skipped and the
    others added in row-major order (``ops/stencil.py:31-48``)."""
    k = np.asarray(k, dtype=np.float32)
    if k.shape != (3, 3):
        raise ValueError(f"correlate3x3 takes a 3x3 kernel, got {k.shape}")
    xp = pad2d(x, 1, mode)
    h, w = x.shape[-2], x.shape[-1]
    out = None
    for i in range(3):
        for j in range(3):
            wt = float(k[i, j])
            if wt == 0.0:
                continue
            term = xp[..., i : i + h, j : j + w] * wt
            out = term if out is None else out + term
    return torch.zeros_like(x) if out is None else out


def hs_avg3x3(x: torch.Tensor, mode: str = "mirror") -> torch.Tensor:
    """Horn-Schunck neighbour average 1/12·[[1,2,1],[2,0,2],[1,2,1]] in the
    separable form ([1,2,1]⊗[1,2,1] − 4·δ)/12 (``ops/stencil.py:51-66``)."""
    xp = pad2d(x, 1, mode)
    p = xp[..., :, :-2] + 2.0 * xp[..., :, 1:-1] + xp[..., :, 2:]
    q = p[..., :-2, :] + 2.0 * p[..., 1:-1, :] + p[..., 2:, :]
    return (q - 4.0 * x) * TWELFTH


def hs_derivatives(im1: torch.Tensor, im2: torch.Tensor):
    """Horn-Schunck 2x2 derivative stencils (``ops/stencil.py:99-129``).

    ndimage's even-kernel origin: out(y,x) combines in[y..y+1, x..x+1] with
    the flipped kernel, mirror border at the bottom/right edge.  Callers pass
    (im1=frame_t0, im2=frame_t1) and receive ft = avg(frame_t0) - avg(frame_t1)
    (the reference's frame-role swap folded in).
    """

    def quads(im):
        p = pad2d(im, ((0, 1), (0, 1)), "mirror")
        return p[..., :-1, :-1], p[..., :-1, 1:], p[..., 1:, :-1], p[..., 1:, 1:]

    a1, b1, c1, d1 = quads(im1)
    a2, b2, c2, d2 = quads(im2)
    fx = (a1 - b1 + c1 - d1 + a2 - b2 + c2 - d2) * 0.25
    fy = (a1 + b1 - c1 - d1 + a2 + b2 - c2 - d2) * 0.25
    ft = (a1 + b1 + c1 + d1 - a2 - b2 - c2 - d2) * 0.25
    return fx, fy, ft


def correlate1d(x: torch.Tensor, kernel: np.ndarray, axis: int, mode: str) -> torch.Tensor:
    """1-D correlation along ``axis`` (one of the trailing two dims) with a
    static kernel centred at len//2, as ``scipy.ndimage.correlate1d``
    (``ops/stencil.py:132-159``)."""
    kernel = np.asarray(kernel, dtype=np.float32)
    n = kernel.shape[0]
    centre = n // 2
    axis = axis % x.ndim
    if axis < x.ndim - 2:
        raise ValueError(f"axis {axis} is not one of the trailing two dims")
    size = x.shape[axis]
    last = axis == x.ndim - 1
    pw = ((0, 0), (centre, n - 1 - centre)) if last else ((centre, n - 1 - centre), (0, 0))
    xp = pad2d(x, pw, mode)
    out = None
    for j in range(n):
        w = float(kernel[j])
        if w == 0.0:
            continue
        term = (xp[..., :, j : j + size] if last else xp[..., j : j + size, :]) * w
        out = term if out is None else out + term
    return torch.zeros_like(x) if out is None else out


def separable_correlate(x: torch.Tensor, kernel: np.ndarray, mode: str) -> torch.Tensor:
    """Separable 1-D correlation along rows then columns of the trailing 2 dims
    (``ops/stencil.py:162-187``); every tap is applied, zero weights included,
    so the sums round exactly as the reference's."""
    kernel = np.asarray(kernel, dtype=np.float32)
    n = kernel.shape[0]
    half = n // 2
    h, w = x.shape[-2], x.shape[-1]

    xp = pad2d(x, ((0, 0), (half, half)), mode)
    out = None
    for j in range(n):
        term = xp[..., :, j : j + w] * float(kernel[j])
        out = term if out is None else out + term

    xp = pad2d(out, ((half, half), (0, 0)), mode)
    out2 = None
    for i in range(n):
        term = xp[..., i : i + h, :] * float(kernel[i])
        out2 = term if out2 is None else out2 + term
    return out2
