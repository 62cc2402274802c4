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
    out(y,x) = sum_ij k[i,j]·in[y+i-1, x+j-1], the border by ``mode``
    (``ops/stencil.py:31-48``)."""
    return correlate3x3_padded(pad2d(x, 1, mode), k, x.shape[-2], x.shape[-1])


def correlate3x3_padded(xp: torch.Tensor, k: np.ndarray, out_h: int, out_w: int) -> torch.Tensor:
    """``correlate3x3`` on an array already padded by one cell, its halo a
    border rule's or a neighbour exchange's; zero taps are skipped and the
    others added in row-major order (``ops/stencil.py:79-96``)."""
    k = np.asarray(k, dtype=np.float32)
    if k.shape != (3, 3):
        raise ValueError(f"correlate3x3 takes a 3x3 kernel, got {k.shape}")
    out = None
    for i in range(3):
        for j in range(3):
            wt = float(k[i, j])
            if wt == 0.0:
                continue
            term = xp[..., i : i + out_h, j : j + out_w] * wt
            out = term if out is None else out + term
    return torch.zeros_like(xp[..., :out_h, :out_w]) if out is None else out


def hs_avg3x3(x: torch.Tensor, mode: str = "mirror") -> torch.Tensor:
    """Horn-Schunck neighbour average 1/12·[[1,2,1],[2,0,2],[1,2,1]], the
    border by ``mode`` (``ops/stencil.py:51-66``)."""
    return hs_avg3x3_padded(pad2d(x, 1, mode), x.shape[-2], x.shape[-1])


def hs_avg3x3_padded(xp: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``hs_avg3x3`` on an array already padded by one cell (or more: the
    first out_h + 2 rows and out_w + 2 columns are read), in the separable
    form ([1,2,1]⊗[1,2,1] − 4·δ)/12 (``ops/stencil.py:69-76``)."""
    p = xp[..., :, :out_w] + 2.0 * xp[..., :, 1 : out_w + 1] + xp[..., :, 2 : out_w + 2]
    q = p[..., :out_h, :] + 2.0 * p[..., 1 : out_h + 1, :] + p[..., 2 : out_h + 2, :]
    return (q - 4.0 * xp[..., 1 : out_h + 1, 1 : out_w + 1]) * TWELFTH


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
    last = axis == x.ndim - 1
    pw = ((0, 0), (centre, n - 1 - centre)) if last else ((centre, n - 1 - centre), (0, 0))
    return correlate1d_padded(pad2d(x, pw, mode), kernel, axis, x.shape[axis])


def correlate1d_padded(xp: torch.Tensor, kernel: np.ndarray, axis: int, size: int) -> torch.Tensor:
    """``correlate1d`` on an array already padded along ``axis`` by len//2
    before and len - 1 - len//2 after (by the border rule, or by a
    neighbour's rows: the sharded solvers' halo): the ``size`` outputs,
    every non-zero tap added in order."""
    kernel = np.asarray(kernel, dtype=np.float32)
    axis = axis % xp.ndim
    last = axis == xp.ndim - 1
    out = None
    for j in range(kernel.shape[0]):
        w = float(kernel[j])
        if w == 0.0:
            continue
        term = (xp[..., :, j : j + size] if last else xp[..., j : j + size, :]) * w
        out = term if out is None else out + term
    if out is None:
        shape = list(xp.shape)
        shape[axis] = size
        return xp.new_zeros(shape)
    return out


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
