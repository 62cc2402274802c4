"""Resampling with exact reference parity (port of ``ops/resize.py``).

PIL BICUBIC/BILINEAR and scipy's RectBivariateSpline are linear, separable
operators.  Their exact per-axis coefficient matrices are built on the host
(numpy/scipy copies of the JAX package's builders) and applied as two float32
matrix products, in the same order as the reference: horizontal then
vertical for PIL, rows then columns for the spline.  The package pins these
products to full float32 (no TF32) at import.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.utils.device import device_constant


def _bilinear_filter(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic_filter(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


_PIL_FILTERS = {
    "bilinear": (_bilinear_filter, 1.0),
    "bicubic": (_bicubic_filter, 2.0),
}


@lru_cache(maxsize=None)
def pil_resize_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) float32 coefficient matrix replicating Pillow's
    ``precompute_coeffs`` (copy of ``ops/resize.py:60-88``)."""
    filt, support0 = _PIL_FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ss = 1.0 / filterscale

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = int(center - support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        w = np.array(
            [filt((x - center + 0.5) * ss) for x in range(xmin, xmax)],
            dtype=np.float64,
        )
        total = w.sum()
        if total != 0.0:
            w /= total
        mat[o, xmin:xmax] = w
    return mat.astype(np.float32)


def pil_resize(img: torch.Tensor, out_hw: tuple, method: str) -> torch.Tensor:
    """PIL-equivalent resize of the trailing 2 dims to ``(out_h, out_w)``:
    horizontal pass, then vertical, as Pillow does."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = img.shape[-2], img.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return img
    rv = device_constant(pil_resize_matrix, in_h, out_h, method, device=img.device)
    rh = device_constant(pil_resize_matrix, in_w, out_w, method, device=img.device)
    return torch.matmul(rv, torch.matmul(img, rh.T))


@lru_cache(maxsize=None)
def spline_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) operator of the interpolating cubic FITPACK spline
    on the reference's normalised grids (copy of ``ops/resize.py:115-130``)."""
    from scipy.interpolate import RectBivariateSpline

    pos_in = np.arange(in_size) / np.float32(in_size)
    pos_out = np.arange(out_size) / np.float32(out_size)
    sp = RectBivariateSpline(pos_in, pos_in, np.eye(in_size))
    return np.float32(sp(pos_out, pos_in))


def spline_upsample(field: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Upsample a flow field exactly as the reference's spline interpolation:
    rows, then columns."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = field.shape[-2], field.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return field
    rv = device_constant(spline_resize_matrix, in_h, out_h, device=field.device)
    rh = device_constant(spline_resize_matrix, in_w, out_w, device=field.device)
    return torch.matmul(torch.matmul(rv, field), rh.T)
