"""Calibrated separable Gaussian pre-filter (port of ``ops/gaussian.py``).

A float32 sampled-Gaussian kernel, renormalised, applied as a separable
direct correlation with a *symmetric* border (edge pixel repeated).  The
driver deliberately truncates it (sigma=3.4 with a 3-px kernel); the weights
are reproduced bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.stencil import separable_correlate


def prepare_gaussian_kernel(sigma: float, kernel_size_px: int) -> np.ndarray:
    """Float32 sampled-Gaussian kernel (copy of ``ops/gaussian.py:25-35``):
    taps at arange(-n/2, n/2) cast to int, float32 Gaussian formula,
    renormalised to unit sum in float32."""
    xs = np.arange(-kernel_size_px / 2, kernel_size_px / 2, 1, dtype=int)
    kernel = np.empty(kernel_size_px, dtype=np.float32)
    kernel[:] = (
        1.0 / np.sqrt(2.0 * np.pi * sigma**2) * np.exp(-(xs**2) / (2.0 * sigma**2))
    )
    kernel /= np.sum(kernel)
    return kernel


def gaussian_filter_px(image: torch.Tensor, sigma: float, kernel_size_px: int) -> torch.Tensor:
    """Separable Gaussian with an explicit kernel size in pixels."""
    kernel = prepare_gaussian_kernel(sigma, kernel_size_px)
    return separable_correlate(image, kernel, "symmetric")


def gaussian_filter(image: torch.Tensor, sigma: float, truncate: float) -> torch.Tensor:
    """Separable Gaussian with scipy-style truncation radius."""
    kernel_size_px = 2 * int(truncate * sigma + 0.5) + 1
    return gaussian_filter_px(image, sigma, kernel_size_px)
