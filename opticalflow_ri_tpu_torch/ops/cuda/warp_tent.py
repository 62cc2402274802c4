"""Driver warp of an image pair: the Hopper kernel and its plain version.

``warp_pair`` replaces the TPU kernel
``ops/pallas/warp_tent.py:warp_pair_tent_pallas`` with a direct 4-tap gather
(``csrc/warp_pair.cu``).  ``displacement_warp_tent`` is the plain PyTorch
version, the same 4-tap form, which equals the JAX package's 289-shift tent
contraction (``ops/warp.py:69-93``) bit for bit: the tent weight
max(0, 1-|d-s|) is non-zero only at s = floor(d) and floor(d)+1, and those
two taps per axis are added in the contraction's sy-major order.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build

_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
    + [ctypes.c_int, ctypes.c_void_p]
)


@lru_cache(maxsize=None)
def _entry():
    entry = build.load_library().ofri_warp_pair
    entry.argtypes = _ARGTYPES
    entry.restype = ctypes.c_int
    return entry


def _clip_bounds(max_shift: int) -> tuple[float, float]:
    """[-R, R - 1e-3] with the upper bound rounded to float32, as JAX does."""
    r = int(max_shift)
    return float(-r), float(np.float32(r - 1e-3))


def displacement_warp_tent(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                           max_shift: int = 8) -> torch.Tensor:
    """Bilinear warp of an (H, W) image by a per-pixel displacement, sampled
    at (y + dy, x + dx) with edge border; displacements beyond ``max_shift``
    sample clamped, as in the reference's tent contraction."""
    if img.dim() != 2:
        raise ValueError(f"displacement_warp_tent takes an (H, W) image, got {tuple(img.shape)}")
    h, w = img.shape
    lo, hi = _clip_bounds(max_shift)
    dyc = dy.clamp(lo, hi)
    dxc = dx.clamp(lo, hi)
    sy = torch.floor(dyc)
    sx = torch.floor(dxc)
    wy0 = (1.0 - (dyc - sy).abs()).clamp_min(0.0)
    wy1 = (1.0 - (dyc - (sy + 1.0)).abs()).clamp_min(0.0)
    wx0 = (1.0 - (dxc - sx).abs()).clamp_min(0.0)
    wx1 = (1.0 - (dxc - (sx + 1.0)).abs()).clamp_min(0.0)
    y0 = torch.arange(h, device=img.device)[:, None] + sy.long()
    x0 = torch.arange(w, device=img.device)[None, :] + sx.long()
    iy0, iy1 = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    ix0, ix1 = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    out = torch.zeros_like(img)
    out = out + (wy0 * wx0) * img[iy0, ix0]
    out = out + (wy0 * wx1) * img[iy0, ix1]
    out = out + (wy1 * wx0) * img[iy1, ix0]
    out = out + (wy1 * wx1) * img[iy1, ix1]
    return out


def warp_pair_plain(im1, im2, dy1, dx1, dy2, dx2, max_shift: int = 8):
    """``warp_pair`` as two ``displacement_warp_tent`` calls."""
    return (displacement_warp_tent(im1, dy1, dx1, max_shift),
            displacement_warp_tent(im2, dy2, dx2, max_shift))


def warp_pair(im1, im2, dy1, dx1, dy2, dx2, max_shift: int = 8):
    """Warp im1 by (dy1, dx1) and im2 by (dy2, dx2); returns (w1, w2).

    CPU tensors run ``warp_pair_plain``; CUDA tensors launch the kernel,
    both images in one launch.
    """
    if im1.device.type == "cpu":
        return warp_pair_plain(im1, im2, dy1, dx1, dy2, dx2, max_shift)
    build.check_fields("warp_pair", im1, im2, dy1, dx1, dy2, dx2)
    h, w = im1.shape
    out1 = torch.empty((h, w), dtype=torch.float32, device=im1.device)
    out2 = torch.empty((h, w), dtype=torch.float32, device=im1.device)
    lo, hi = _clip_bounds(max_shift)
    entry = _entry()
    stream = torch.cuda.current_stream(im1.device).cuda_stream
    warp_pair.launches += 1
    rc = entry(im1.data_ptr(), im2.data_ptr(), dy1.data_ptr(), dx1.data_ptr(), dy2.data_ptr(),
               dx2.data_ptr(), out1.data_ptr(), out2.data_ptr(), h, w, lo, hi,
               im1.device.index or 0, stream)
    build.check(rc, "warp_pair")
    return out1, out2


warp_pair.launches = 0
