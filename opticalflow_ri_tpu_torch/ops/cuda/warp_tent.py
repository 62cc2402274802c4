"""Driver warp of an image pair: the Hopper kernel and its plain version.

``warp_pair`` replaces the TPU kernel
``ops/pallas/warp_tent.py:warp_pair_tent_pallas`` with a direct 4-tap gather
(``csrc/warp_pair.cu``).  ``displacement_warp_tent`` is the plain PyTorch
version, the same 4-tap form, which equals the JAX package's 289-shift tent
contraction (``ops/warp.py:69-93``) bit for bit: the tent weight
max(0, 1-|d-s|) is non-zero only at s = floor(d) and floor(d)+1, and those
two taps per axis are added in the contraction's sy-major order.

The caller-padded mode warps one tile of a sharded image (the sharded
pyramid's warp, ``parallel/sharded_glue.py``): each image comes with an
apron of ``apron`` cells on every side, the flows are the tile's own, and
``row0``, ``col0``, ``img_h``, ``img_w`` place the tile in the image.  A
tap's global index is clamped into the image as in the whole-image call and
then read from the padded tile, so the padded call equals the whole-image
call cropped to the tile, bit for bit, once every interior side's apron
holds ``max_shift`` cells of the neighbours (``floor(d)`` reaches -R and
R - 1, the second tap R).  The TPU kernel has no such mode: GSPMD runs the
JAX package's sharded warp as XLA.
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


_ARGTYPES_PADDED = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
    + [ctypes.c_int] * 6 + [ctypes.c_void_p]
)


@lru_cache(maxsize=None)
def _entry(padded: bool = False):
    lib = build.load_library()
    entry = lib.ofri_warp_pair_padded if padded else lib.ofri_warp_pair
    entry.argtypes = _ARGTYPES_PADDED if padded else _ARGTYPES
    entry.restype = ctypes.c_int
    return entry


def _clip_bounds(max_shift: int) -> tuple[float, float]:
    """[-R, R - 1e-3] with the upper bound rounded to float32, as JAX does."""
    r = int(max_shift)
    return float(-r), float(np.float32(r - 1e-3))


def _tile(img_shape, flow_shape, max_shift, apron, row0, col0, img_h, img_w) -> tuple:
    """(img_h, img_w) of a warp call, checked: a padded image is the flow's
    shape plus ``apron`` on every side, the tile lies in the image, and
    each side's apron holds the taps' reach (``max_shift`` cells, or the
    image's cells beyond the tile where there are fewer)."""
    h, w = flow_shape
    img_h = h if img_h is None else int(img_h)
    img_w = w if img_w is None else int(img_w)
    a = int(apron)
    if tuple(img_shape) != (h + 2 * a, w + 2 * a):
        raise ValueError(f"warp: an image of {tuple(img_shape)} does not hold a ({h}, {w}) flow "
                         f"with an apron of {a}")
    if not (0 <= row0 and row0 + h <= img_h and 0 <= col0 and col0 + w <= img_w):
        raise ValueError(f"warp: a ({h}, {w}) tile at ({row0}, {col0}) is not inside the "
                         f"({img_h}, {img_w}) image")
    r = int(max_shift)
    reach = max(min(r, row0), min(r, img_h - row0 - h), min(r, col0), min(r, img_w - col0 - w))
    if reach > a:
        raise ValueError(f"warp: an apron of {a} cells does not hold the taps' reach of {reach} "
                         f"(max_shift {r}) on an interior side")
    return img_h, img_w


def displacement_warp_tent(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                           max_shift: int = 8, *, apron: int = 0, row0: int = 0, col0: int = 0,
                           img_h: int | None = None, img_w: int | None = None) -> torch.Tensor:
    """Bilinear warp of an (H, W) image by a per-pixel displacement, sampled
    at (y + dy, x + dx) with edge border; displacements beyond ``max_shift``
    sample clamped, as in the reference's tent contraction.  With
    ``apron`` > 0 or a tile origin, ``img`` is the padded tile of the
    caller-padded mode (the module docstring)."""
    if img.dim() != 2:
        raise ValueError(f"displacement_warp_tent takes an (H, W) image, got {tuple(img.shape)}")
    h, w = dy.shape
    img_h, img_w = _tile(img.shape, (h, w), max_shift, apron, row0, col0, img_h, img_w)
    lo, hi = _clip_bounds(max_shift)
    dyc = dy.clamp(lo, hi)
    dxc = dx.clamp(lo, hi)
    sy = torch.floor(dyc)
    sx = torch.floor(dxc)
    wy0 = (1.0 - (dyc - sy).abs()).clamp_min(0.0)
    wy1 = (1.0 - (dyc - (sy + 1.0)).abs()).clamp_min(0.0)
    wx0 = (1.0 - (dxc - sx).abs()).clamp_min(0.0)
    wx1 = (1.0 - (dxc - (sx + 1.0)).abs()).clamp_min(0.0)
    # global indices, clamped into the image, then read from the padded tile
    y0 = torch.arange(row0, row0 + h, device=img.device)[:, None] + sy.long()
    x0 = torch.arange(col0, col0 + w, device=img.device)[None, :] + sx.long()
    ry, rx = apron - row0, apron - col0
    iy0, iy1 = y0.clamp(0, img_h - 1) + ry, (y0 + 1).clamp(0, img_h - 1) + ry
    ix0, ix1 = x0.clamp(0, img_w - 1) + rx, (x0 + 1).clamp(0, img_w - 1) + rx
    out = torch.zeros_like(dy, dtype=img.dtype)
    out = out + (wy0 * wx0) * img[iy0, ix0]
    out = out + (wy0 * wx1) * img[iy0, ix1]
    out = out + (wy1 * wx0) * img[iy1, ix0]
    out = out + (wy1 * wx1) * img[iy1, ix1]
    return out


def warp_pair_plain(im1, im2, dy1, dx1, dy2, dx2, max_shift: int = 8, **tile):
    """``warp_pair`` as two ``displacement_warp_tent`` calls."""
    return (displacement_warp_tent(im1, dy1, dx1, max_shift, **tile),
            displacement_warp_tent(im2, dy2, dx2, max_shift, **tile))


def warp_pair(im1, im2, dy1, dx1, dy2, dx2, max_shift: int = 8, *, apron: int = 0,
              row0: int = 0, col0: int = 0, img_h: int | None = None, img_w: int | None = None):
    """Warp im1 by (dy1, dx1) and im2 by (dy2, dx2); returns (w1, w2).

    CPU tensors run ``warp_pair_plain``; CUDA tensors launch the kernel,
    both images in one launch.  ``apron``, ``row0``, ``col0``, ``img_h``
    and ``img_w`` select the caller-padded mode (the module docstring); by
    default the call is the whole-image kernel.
    """
    tile = dict(apron=apron, row0=row0, col0=col0, img_h=img_h, img_w=img_w)
    if im1.device.type == "cpu":
        return warp_pair_plain(im1, im2, dy1, dx1, dy2, dx2, max_shift, **tile)
    build.check_fields("warp_pair", dy1, dx1, dy2, dx2)
    build.check_fields("warp_pair", im1, im2)
    h, w = dy1.shape
    full_h, full_w = _tile(im1.shape, (h, w), max_shift, apron, row0, col0, img_h, img_w)
    if im1.device != dy1.device:
        raise ValueError(f"warp_pair: images on {im1.device}, flows on {dy1.device}")
    padded = (apron, row0, col0, full_h, full_w) != (0, 0, 0, h, w)
    out1 = torch.empty((h, w), dtype=torch.float32, device=im1.device)
    out2 = torch.empty((h, w), dtype=torch.float32, device=im1.device)
    lo, hi = _clip_bounds(max_shift)
    entry = _entry(padded)
    stream = torch.cuda.current_stream(im1.device).cuda_stream
    args = [im1.data_ptr(), im2.data_ptr(), dy1.data_ptr(), dx1.data_ptr(), dy2.data_ptr(),
            dx2.data_ptr(), out1.data_ptr(), out2.data_ptr(), h, w, lo, hi]
    if padded:
        args += [row0, col0, full_h, full_w, apron]
    warp_pair.launches += 1
    rc = entry(*args, im1.device.index or 0, stream)
    build.check(rc, "warp_pair")
    return out1, out2


warp_pair.launches = 0
