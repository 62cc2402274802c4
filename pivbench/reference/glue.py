"""The pyramid's image operations in plain PyTorch, on stacks of pairs.

Every array is (..., H, W): the reference runs a block of pairs at once.
Every constant (border indices, Gaussian taps, the PIL and spline resize
matrices) is computed here from its definition; nothing comes from the
program under test.

The resize matrices are applied by ``mm``, the reference's matrix product:
``matmul_fp32`` runs it in float32 with TF32 off, ``matmul_tf32`` in TF32
(on a CPU, where PyTorch has no TF32, both operands are rounded to TF32's
10-bit mantissa first, which is what the card's tensor cores do to them).
The Farnebäck correlations round their operands likewise in TF32, and sum
in float32.  ``PRECISIONS`` names the reference's precision and the
control's lower one.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for float32 matrix products on the card on or off inside the block,
    the process's settings restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    torch.set_float32_matmul_precision("high" if enabled else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32)


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with tf32(False):
        return torch.matmul(a, b)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        with tf32(True):
            return torch.matmul(a, b)
    return torch.matmul(round_tf32(a), round_tf32(b))


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclass(frozen=True)
class Precision:
    """How the reference computes: ``matmul`` for the resize products,
    ``operand`` rounds the operands of the Farnebäck correlations (the
    expansion and the blurs; the frames or planes, and the taps)."""
    matmul: Callable
    operand: Callable


PRECISIONS = {
    "fp32": Precision(matmul_fp32, exact),        # what the configurations state
    "tf32": Precision(matmul_tf32, round_tf32),   # the control: TF32 products
}


# --- borders ------------------------------------------------------------------

@lru_cache(maxsize=None)
def pad_index(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    """Source index of each position of a length-n axis padded by (lo, hi):
    "mirror" reflects about the edge pixel (a b c | b a), "symmetric"
    repeats it (a b c | c b), "nearest" replicates it (a b c | c c)."""
    i = np.arange(-lo, n + hi)
    if mode == "nearest" or n == 1:
        return np.clip(i, 0, n - 1)
    if mode == "mirror":
        m = np.mod(i, 2 * (n - 1))
        return np.where(m > n - 1, 2 * (n - 1) - m, m)
    if mode != "symmetric":
        raise ValueError(f"unknown border mode {mode!r}")
    m = np.mod(i, 2 * n)
    return np.where(m >= n, 2 * n - 1 - m, m)


def pad2d(x: torch.Tensor, pad, mode: str) -> torch.Tensor:
    """Pad the last two axes by ``pad`` (an int, or ((top, bottom), (left,
    right))) under a border rule; "constant" pads zeros."""
    (top, bottom), (left, right) = ((pad, pad), (pad, pad)) if isinstance(pad, int) else pad
    if mode == "constant":
        return F.pad(x, (left, right, top, bottom))
    h, w = x.shape[-2:]
    rows = torch.from_numpy(pad_index(h, top, bottom, mode)).to(x.device)
    cols = torch.from_numpy(pad_index(w, left, right, mode)).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


# --- correlations -------------------------------------------------------------

def correlate1d(x: torch.Tensor, taps, axis: int, mode: str,
                operand: Callable = exact) -> torch.Tensor:
    """``scipy.ndimage.correlate1d`` along one of the last two axes, the kernel
    centred at len // 2, zero taps skipped; the input and the taps rounded
    by ``operand``, the products summed in float32."""
    taps = operand(torch.from_numpy(np.asarray(taps, np.float32))).numpy()
    x = operand(x.to(torch.float32))
    n = taps.size
    c = n // 2
    last = axis % x.ndim == x.ndim - 1
    size = x.shape[axis]
    xp = pad2d(x, ((0, 0), (c, n - 1 - c)) if last else ((c, n - 1 - c), (0, 0)), mode)
    out = None
    for j, t in enumerate(taps.tolist()):
        if t == 0.0:
            continue
        term = (xp[..., :, j:j + size] if last else xp[..., j:j + size, :]) * t
        out = term if out is None else out + term
    return out


def separable_correlate(x: torch.Tensor, taps, mode: str) -> torch.Tensor:
    """Rows then columns, every tap applied (zero weights included)."""
    taps = np.asarray(taps, np.float32)
    half = taps.size // 2
    h, w = x.shape[-2:]
    xp = pad2d(x, ((0, 0), (half, half)), mode)
    out = None
    for j, t in enumerate(taps.tolist()):
        term = xp[..., :, j:j + w] * t
        out = term if out is None else out + term
    xp = pad2d(out, ((half, half), (0, 0)), mode)
    out = None
    for i, t in enumerate(taps.tolist()):
        term = xp[..., i:i + h, :] * t
        out = term if out is None else out + term
    return out


def correlate3x3(x: torch.Tensor, k, mode: str) -> torch.Tensor:
    """out(y, x) = sum_ij k[i, j] in[y + i - 1, x + j - 1], zero taps skipped,
    the others added in row-major order."""
    k = np.asarray(k, np.float32)
    h, w = x.shape[-2:]
    xp = pad2d(x, 1, mode)
    out = None
    for i in range(3):
        for j in range(3):
            t = float(k[i, j])
            if t == 0.0:
                continue
            term = xp[..., i:i + h, j:j + w] * t
            out = term if out is None else out + term
    return out


@lru_cache(maxsize=None)
def gaussian_taps(sigma: float, n: int) -> np.ndarray:
    """The driver's prefilter: a float32 sampled Gaussian at the integer
    offsets arange(-n/2, n/2), renormalised to a unit sum."""
    xs = np.arange(-n / 2, n / 2, 1, dtype=int)
    k = np.empty(n, np.float32)
    k[:] = 1.0 / np.sqrt(2.0 * np.pi * sigma**2) * np.exp(-(xs**2) / (2.0 * sigma**2))
    k /= np.sum(k)
    return k


def prefilter(x: torch.Tensor, sigma: float, n: int) -> torch.Tensor:
    """The calibrated Gaussian with an n-pixel kernel, symmetric border."""
    return separable_correlate(x, gaussian_taps(float(sigma), int(n)), "symmetric")


# --- resampling ---------------------------------------------------------------

def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


@lru_cache(maxsize=None)
def pil_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_out, n_in) coefficients of Pillow's resampling along one axis
    (its ``precompute_coeffs``: support widened by the scale, taps
    normalised to a unit sum)."""
    filt, support = _FILTERS[method]
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support *= fscale
    mat = np.zeros((n_out, n_in), np.float64)
    for o in range(n_out):
        centre = (o + 0.5) * scale
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), n_in)
        wts = np.array([filt((x - centre + 0.5) / fscale) for x in range(lo, hi)])
        if wts.sum() != 0.0:
            wts /= wts.sum()
        mat[o, lo:hi] = wts
    return mat.astype(np.float32)


@lru_cache(maxsize=None)
def spline_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) operator of scipy's interpolating bicubic
    RectBivariateSpline on the grids arange(n) / n, evaluated at the
    output grid along one axis."""
    from scipy.interpolate import RectBivariateSpline

    pos_in = np.arange(n_in) / np.float32(n_in)
    pos_out = np.arange(n_out) / np.float32(n_out)
    sp = RectBivariateSpline(pos_in, pos_in, np.eye(n_in))
    return np.float32(sp(pos_out, pos_in))


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def resize(x: torch.Tensor, out_hw, method: str, mm) -> torch.Tensor:
    """Pillow's resize of the last two axes: the horizontal pass, then the
    vertical one."""
    (h, w), (oh, ow) = x.shape[-2:], out_hw
    if (h, w) == (oh, ow):
        return x
    rv = _const(pil_matrix(h, oh, method), x)
    rh = _const(pil_matrix(w, ow, method), x)
    return mm(rv, mm(x, rh.T))


def upsample(field: torch.Tensor, out_hw, mm) -> torch.Tensor:
    """The driver's spline upsampling of a flow: rows, then columns."""
    (h, w), (oh, ow) = field.shape[-2:], out_hw
    if (h, w) == (oh, ow):
        return field
    rv = _const(spline_matrix(h, oh), field)
    rh = _const(spline_matrix(w, ow), field)
    return mm(mm(rv, field), rh.T)


def _gather(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img[n, iy, ix] for (N, H, W) index arrays."""
    n, h, w = img.shape
    idx = (iy * w + ix).reshape(n, -1)
    return img.reshape(n, -1).gather(1, idx).reshape(iy.shape)


def warp(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, max_shift: int = 8):
    """Bilinear sample of (N, H, W) images at (y + dy, x + dx), the
    displacement clipped to [-R, R - 1e-3] and the taps clamped to the
    image (edge border)."""
    h, w = img.shape[-2:]
    hi = float(np.float32(max_shift - 1e-3))
    dy = dy.clamp(-float(max_shift), hi)
    dx = dx.clamp(-float(max_shift), hi)
    sy, sx = torch.floor(dy), torch.floor(dx)
    fy, fx = dy - sy, dx - sx
    y0 = torch.arange(h, device=img.device)[:, None] + sy.long()
    x0 = torch.arange(w, device=img.device)[None, :] + sx.long()
    y0c, y1c = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    x0c, x1c = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    return ((1.0 - fy) * (1.0 - fx) * _gather(img, y0c, x0c)
            + (1.0 - fy) * fx * _gather(img, y0c, x1c)
            + fy * (1.0 - fx) * _gather(img, y1c, x0c)
            + fy * fx * _gather(img, y1c, x1c))


def warp_pair(im1, im2, u, v, max_shift: int = 8):
    """The driver's symmetric warp: im1 back by half the flow, im2 forward."""
    return (warp(im1, -v / 2.0, -u / 2.0, max_shift),
            warp(im2, v / 2.0, u / 2.0, max_shift))
