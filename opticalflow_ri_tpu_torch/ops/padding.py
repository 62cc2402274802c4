"""Border padding modes used across the engine (port of ``ops/padding.py``).

The reference mixes four boundary conventions (scipy.ndimage names):
  - "mirror"    : reflect about the edge pixel centre, edge NOT repeated
                  (a b c | b a) — HS averaging/derivatives
  - "symmetric" : reflect, edge repeated (a b c | c b) — calibrated Gaussian
  - "nearest"   : replicate edge (a b c | c c) — Liu-Shen stencils
  - "constant"  : zero pad — Liu-Shen H-kernel terms

torch's ``F.pad`` names differ ("reflect" is ndimage "mirror", "replicate" is
"nearest"), it has no "symmetric" at all, and its reflect/replicate modes want
a batch/channel dimension.  So the three index-based modes are built here as
one row gather and one column gather from numpy index vectors, which also
covers any number of leading dimensions and pads wider than the image
(repeated reflection, as ``jnp.pad``/``np.pad`` do).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from opticalflow_ri_tpu_torch.utils.device import device_constant

_MODES = ("mirror", "symmetric", "nearest", "constant")


@lru_cache(maxsize=None)
def _pad_index(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    """Source index of every position of an axis of length ``n`` padded by
    (lo, hi) under ``mode``."""
    i = np.arange(-lo, n + hi)
    if mode == "nearest" or n == 1:
        return np.clip(i, 0, n - 1)
    if mode == "mirror":
        m = np.mod(i, 2 * (n - 1))
        return np.where(m > n - 1, 2 * (n - 1) - m, m)
    m = np.mod(i, 2 * n)  # symmetric
    return np.where(m >= n, 2 * n - 1 - m, m)


def pad2d(x: torch.Tensor, pad: int | tuple, mode: str) -> torch.Tensor:
    """Pad the trailing two dims of ``x`` by ``pad`` using a reference border mode.

    ``pad`` may be an int (all sides) or ((top, bottom), (left, right)).
    """
    if isinstance(pad, int):
        (top, bottom), (left, right) = (pad, pad), (pad, pad)
    else:
        (top, bottom), (left, right) = pad
    if mode not in _MODES:
        raise ValueError(f"unknown border mode {mode!r}; expected one of {_MODES}")
    if mode == "constant":
        return F.pad(x, (left, right, top, bottom), mode="constant", value=0.0)
    h, w = x.shape[-2], x.shape[-1]
    rows = device_constant(_pad_index, h, top, bottom, mode, device=x.device)
    cols = device_constant(_pad_index, w, left, right, mode, device=x.device)
    return x.index_select(-2, rows).index_select(-1, cols)
