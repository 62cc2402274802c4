"""Masked separable window sums (port of ``ops/window_sums.py``).

The LK window weights are 0/1 masks over the 32-sample grid; a masked window
sum decomposes into maximal runs of ones, and each run is summed in one of
three static forms, chosen per call site exactly as the JAX package does:

  * direct (``hierarchical=False``): the plain L-tap slice sum;
  * two-level (``hierarchical=True``): a base box of width a ~= sqrt(L)
    reused by L // a strided slices, plus remainder taps;
  * ``"ladder"``: a 2/3/5-smooth factor ladder, S_{m*f}(c) =
    sum_{j<f} S_m(c + j*m), plus remainder taps (6 adds for L = 27).

Every form is plain tensor slices and adds in the JAX package's order, so
the sums round exactly as the reference's.  The LK build kernel
(``csrc/lk_build.cu``) reproduces the ladder order and the fused LK kernel
(``csrc/lk_iter.cu``) the two-level order.
"""

from __future__ import annotations

import numpy as np
import torch


def runs_from_mask(mask: np.ndarray):
    """Decompose a static 0/1 weight vector into maximal runs of ones."""
    runs = []
    start = None
    for idx, m in enumerate(mask.tolist() + [0.0]):
        if m != 0.0 and start is None:
            start = idx
        elif m == 0.0 and start is not None:
            runs.append((start, idx - 1))
            start = None
    return tuple(runs)


def _smooth_factorization(L: int):
    """Min-cost 2/3/5-smooth decomposition: the smooth L' <= L (returned as
    its factor list, plus the remainder L - L') minimising total sliding-sum
    adds = sum(f - 1 for f in factors) + (L - L').  Note this is NOT simply
    the largest smooth L' <= L — e.g. L=26 picks 24 (cost 6+2) over 25
    (cost 8+1)."""
    best = (L - 1, [], L)  # (adds, factors, remainder) — all-direct fallback
    for lp in range(L, 0, -1):
        m, factors = lp, []
        for f in (2, 3, 5):
            while m % f == 0:
                m //= f
                factors.append(f)
        if m != 1:
            continue
        adds = sum(f - 1 for f in factors) + (L - lp)
        if adds < best[0]:
            best = (adds, sorted(factors), L - lp)
    return best[1], best[2]


def base_width(L: int) -> int:
    """The two-level form's base box width for a run of length L."""
    return max(1, int(round(L ** 0.5)))


def _slice(x: torch.Tensor, start: int, stop: int, axis: int) -> torch.Tensor:
    return x.narrow(axis, start, stop - start)


def _ladder_run(x, lo, L, size, axis, out_len):
    """Width-L sliding sum starting at offset ``lo`` via a factor ladder
    (``ops/window_sums.py:63-79``)."""
    factors, _ = _smooth_factorization(L)
    s, m = x, 1
    for f in factors:
        n = s.shape[axis]
        nxt = None
        for j in range(f):
            t = _slice(s, j * m, n - (f - 1) * m + j * m, axis)
            nxt = t if nxt is None else nxt + t
        s, m = nxt, m * f
    term = _slice(s, lo, lo + out_len, axis)
    for k in range(lo + m, lo + L):
        term = term + _slice(x, k, k + out_len, axis)
    return term


def windowed_sum_axis(x, runs, half_window, axis, out_len, hierarchical=False):
    """sum_k mask[k] * x[p + k - half_window] along ``axis``; ``x`` covers
    positions [-hw, out_len-1+GRID-1-hw] relative to the output origin
    (``ops/window_sums.py:82-116``)."""
    axis = axis % x.ndim
    size = x.shape[axis]
    out = None
    for lo, hi in runs:
        L = hi - lo + 1
        if hierarchical == "ladder":
            term = _ladder_run(x, lo, L, size, axis, out_len)
            out = term if out is None else out + term
            continue
        a = base_width(L) if hierarchical else 1
        b = L // a
        if a == 1:
            base = x
        else:
            base = None
            for i in range(a):
                t = _slice(x, i, size - a + 1 + i, axis)
                base = t if base is None else base + t
        term = None
        for j in range(b):
            s = lo + a * j
            t = _slice(base, s, s + out_len, axis)
            term = t if term is None else term + t
        for k in range(lo + a * b, hi + 1):
            t = _slice(x, k, k + out_len, axis)
            term = t if term is None else term + t
        out = term if out is None else out + term
    return out


def wsum2d(x, runs_y, runs_x, hw, out_h, out_w, hierarchical=False):
    """Separable masked window sum of ``x`` (covering the padded off-domain)
    down to the (out_h, out_w) pixel grid, the x-axis pass first."""
    t = windowed_sum_axis(x, runs_x, hw, x.ndim - 1, out_w, hierarchical)
    return windowed_sum_axis(t, runs_y, hw, x.ndim - 2, out_h, hierarchical)
