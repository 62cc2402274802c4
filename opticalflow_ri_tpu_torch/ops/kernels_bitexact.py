"""OpenCV-compatible bit-exact 1-D Gaussian kernel generation (host-side; a
copy of the JAX package's ``ops/kernels_bitexact.py``, numpy and ``decimal``
only).

Reproduces the semantics of the reference's soft-float kernel generator
(ref: src/GaussianKernelBitExact.py:55-144), which the Farneback solver uses
for every blur kernel (ref: src/Farneback_PyCL.py:199-209):

  * sigma <= 0 with n in {1,3,5,7,9}  -> fixed binomial kernels (exactly
    representable in binary floating point, written as literals here).
  * otherwise -> kernel computed in decimal soft-float arithmetic with
        sigma_eff = |sigma|            if sigma < 0
        sigma_eff = n*0.15 + 0.35      if sigma >= 0   (positive sigma is
                                       IGNORED — a reference quirk we keep,
                                       ref: src/GaussianKernelBitExact.py:102-107)
    and taps exp(-0.125 * x^2 / sigma_eff^2) at the doubled offsets
    x = 1-n, 3-n, ... left of the centre, mirrored to the right.

Kernels are generated once on the host and passed to the blurs as constants,
so the bit-exactness costs nothing on the device.
"""

from __future__ import annotations

from decimal import Decimal, getcontext
from functools import lru_cache

import numpy as np

# Binomial smoothing kernels used by OpenCV when sigma <= 0 for the small odd
# sizes.  All values are exact dyadic rationals.
_FIXED_KERNELS = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    9: [
        4.0 / 256,
        13.0 / 256,
        30.0 / 256,
        51.0 / 256,
        60.0 / 256,
        51.0 / 256,
        30.0 / 256,
        13.0 / 256,
        4.0 / 256,
    ],
}


@lru_cache(maxsize=None)
def _get_kernel_cached(n: int, sigma_key: str):
    sigma = float(sigma_key)
    if sigma <= 0 and n in _FIXED_KERNELS:
        return 1.0, np.asarray(_FIXED_KERNELS[n], dtype=np.float64)

    getcontext().prec = 28
    if sigma < 0:
        sigma_eff = Decimal(sigma)
    else:
        sigma_eff = Decimal(n) * Decimal("0.15") + Decimal("0.35")
    scale2x = Decimal("-0.125") / (sigma_eff * sigma_eff)

    half = (n - 1) // 2
    # Tap offsets relative to the kernel centre, doubled: x = 2*i - (n-1) for
    # the taps strictly left of centre; the centre tap is exp(0) == 1.
    tail = []
    acc = Decimal(0)
    x = 1 - n
    for _ in range(half):
        t = (Decimal(x * x) * scale2x).exp()
        tail.append(t)
        acc += t
        x += 2

    total = acc * Decimal(2) + Decimal(1)
    if n % 2 == 0:
        total += Decimal(1)

    inv = Decimal(1) / total
    kernel = np.zeros(n, dtype=object)
    ksum = Decimal(0)
    for i, t in enumerate(tail):
        v = t * inv
        kernel[i] = v
        kernel[n - 1 - i] = v
        ksum += v
    ksum *= Decimal(2)
    centre = Decimal(1) * inv
    kernel[half] = centre
    ksum += centre
    if n % 2 == 0:
        kernel[half + 1] = centre
        ksum += centre
    return float(ksum), kernel.astype(np.float64)


def get_gaussian_kernel_bit_exact(n: int, sigma: float):
    """Return ``(sum, kernel)`` matching the reference generator for size ``n``."""
    assert n > 0
    return _get_kernel_cached(int(n), repr(float(sigma)))
