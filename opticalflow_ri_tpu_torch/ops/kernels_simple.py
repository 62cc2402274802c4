"""Simple (non-bit-exact) 1-D Gaussian kernel generator (a copy of the JAX
package's ``ops/kernels_simple.py``, NumPy only; tests/test_torch_helpers.py
holds the two equal).

Equivalent of the reference's alternative kernel generator
(ref: src/SimpleGaussianKernel.py:53-124 — dead code there, imported nowhere;
provided here for API completeness).  Semantics:

  * taps at x = 1-n, 3-n, ..., n-1 (half-pixel lattice, so the weight at
    integer offset k from the centre is exp(-k^2 / (2 sigma^2)));
  * odd n gets an explicit centre weight of 1;
  * the kernel is normalised to unit sum; returns (sum_after_normalisation,
    values) like the reference (the sum is 1 up to rounding).

``simple_gaussian_kernel_decimal`` mirrors the Decimal soft-float variant:
for sigma <= 0 it returns the hardcoded binomial kernels (the reference
stores them as IEEE-754 bit patterns; they are exact dyadic fractions), and
otherwise evaluates the same expression in ``decimal.Decimal`` arithmetic.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

# Exact values of the reference's hex-encoded float64 constants
# (ref: src/SimpleGaussianKernel.py:77-110).
_BINOMIAL = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    9: [4 / 256, 13 / 256, 30 / 256, 51 / 256, 60 / 256, 51 / 256,
        30 / 256, 13 / 256, 4 / 256],
}


def simple_gaussian_kernel(n: int, sigma: float):
    """float64 variant (ref: src/SimpleGaussianKernel.py:53-68)."""
    values = np.zeros(n, np.float64)
    n2 = (n - 1) // 2
    x = 1 - n
    for i in range(n2):
        values[i] = np.exp(-x * x * 0.125 / (sigma * sigma))
        values[n - i - 1] = values[i]
        x += 2
    if n & 1:
        values[n2] = 1.0
    values /= values.sum()
    return values.sum(), values


def simple_gaussian_kernel_decimal(n: int, sigma: float):
    """Decimal soft-float variant with binomial fast paths for sigma <= 0
    (ref: src/SimpleGaussianKernel.py:70-124)."""
    if sigma <= 0:
        if n not in _BINOMIAL:
            raise ValueError(f"no binomial kernel for n={n} with sigma<=0")
        return Decimal(1), np.array(_BINOMIAL[n], np.float64)

    values = np.zeros(n, object)
    n2 = (n - 1) // 2
    x = 1 - n
    for i in range(n2):
        values[i] = Decimal(np.exp(-Decimal(x * x) * Decimal(0.125) / Decimal(sigma * sigma)))
        values[n - i - 1] = values[i]
        x += 2
    if n & 1:
        values[n2] = Decimal(1)
    total = sum(values)
    values = values / total
    return sum(values), values
