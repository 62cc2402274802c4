"""Farneback polynomial expansion: the Hopper kernel and its plain version.

``poly_expand`` computes the (5, H, W) expansion field of the (H, W) image
that ``srcp`` holds with n more rows above and below it: the replicate
rule's (``models/farneback.py:poly_expansion``), or a rows-sharded stripe's
halo (``parallel/sharded_kernel.py:_fb_expansion_local``).  CUDA tensors
launch one kernel a frame (``csrc/fb_poly_expand.cu``), which stages each
tile with its aprons in shared memory and keeps the nine correlations
there.  It replaces no TPU kernel: the JAX package runs the expansion as
XLA ops (``models/farneback.py:poly_expansion``, ``impl="vpu"``).

``poly_expand_plain`` is that chain in PyTorch, in its order: three vertical
1-D correlations (g, xg, xxg) over the given rows, six horizontal ones with
the replicate border, then the five combinations with the Gram-inverse
constants; every non-zero tap added in index order.  CPU tensors take it,
and the kernel equals it bit for bit.

``n`` is the basis half-width (polyN: the adapter admits 5 and 7), 2n + 1
taps, at most ``2 * MAX_N + 1`` on the card (the plain chain takes any);
``sigma`` the basis Gaussian's (below float32's epsilon: 0.3 n, as the
reference).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.stencil import correlate1d, correlate1d_padded

MAX_N = 7  # csrc/fb_poly_expand.cu: kMaxN
TILE_ROWS, TILE_COLS = 32, 64  # csrc/fb_poly_expand.cu: kTH, kTW


@lru_cache(maxsize=None)
def prepare_poly_gaussian(n: int, sigma: float):
    """g/xg/xxg bases + Gram-inverse constants
    (ref: src/Farneback_PyCL.py:124-172), host-side, cached."""
    if sigma < 1.19209289550781250000000000000000000e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-x * x / (2 * sigma * sigma))
    g = (g / g.sum()).astype(np.float32)
    xg = (x * g).astype(np.float32)
    xxg = (x * x * g).astype(np.float32)

    G = np.zeros((6, 6), np.float64)
    gd = g.astype(np.float64)
    for yy in range(-n, n + 1):
        for xx in range(-n, n + 1):
            w = gd[yy + n] * gd[xx + n]
            G[0, 0] += w
            G[1, 1] += w * xx * xx
            G[3, 3] += w * xx**4
            G[5, 5] += w * xx * xx * yy * yy
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return g, xg, xxg, (
        np.float32(inv[1, 1]), np.float32(inv[0, 3]),
        np.float32(inv[3, 3]), np.float32(inv[5, 5]),
    )


def check_args(srcp: torch.Tensor, n, max_n: int | None = None) -> int:
    """The image's rows; raises on a tap count 2n + 1 that is not odd, is
    under 3 or (where ``max_n`` is given) exceeds ``2 * max_n + 1``, and on
    a ``srcp`` of fewer than 2n + 1 rows."""
    taps = 2 * n + 1
    top = "" if max_n is None else f" to {2 * max_n + 1}"
    if (taps != int(taps) or int(taps) % 2 == 0 or taps < 3
            or (max_n is not None and taps > 2 * max_n + 1)):
        raise ValueError(f"poly_expand takes an odd tap count 2n + 1 from 3{top}, "
                         f"got {taps} (n = {n})")
    rows = srcp.shape[-2] - 2 * int(n)
    if rows < 1:
        raise ValueError(f"poly_expand: srcp must hold the image and n = {n} rows above and "
                         f"below it, at least {taps} rows, got {srcp.shape[-2]}")
    return rows


def poly_expand_plain(srcp: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """The nine correlations and five combinations of the JAX package's
    "vpu" chain, in its order; returns (5, H, W)."""
    rows = check_args(srcp, n)
    n = int(n)
    g, xg, xxg, (ig11, ig03, ig33, ig55) = prepare_poly_gaussian(n, float(sigma))
    ve = correlate1d_padded(srcp, g, -2, rows)
    vo = correlate1d_padded(srcp, xg, -2, rows)
    vx2 = correlate1d_padded(srcp, xxg, -2, rows)

    b1 = correlate1d(ve, g, axis=-1, mode="nearest")
    b2 = correlate1d(ve, xg, axis=-1, mode="nearest")
    b4 = correlate1d(ve, xxg, axis=-1, mode="nearest")
    b3 = correlate1d(vo, g, axis=-1, mode="nearest")
    b6 = correlate1d(vo, xg, axis=-1, mode="nearest")
    b5 = correlate1d(vx2, g, axis=-1, mode="nearest")

    ig11, ig03, ig33, ig55 = (float(c) for c in (ig11, ig03, ig33, ig55))
    return torch.stack([
        b3 * ig11,
        b2 * ig11,
        b1 * ig03 + b5 * ig33,
        b1 * ig03 + b4 * ig33,
        b6 * ig55,
    ])


@lru_cache(maxsize=None)
def _entry():
    entry = build.load_library().ofri_fb_poly_expand
    entry.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


@lru_cache(maxsize=None)
def _tables(n: int, sigma: float):
    """The kernel's g, xg, xxg and (ig11, ig03, ig33, ig55) as ctypes arrays."""
    g, xg, xxg, consts = prepare_poly_gaussian(n, sigma)
    return tuple((ctypes.c_float * len(t))(*np.asarray(t, np.float32).tolist())
                 for t in (g, xg, xxg, consts))


def poly_expand(srcp: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """The expansion (5, H, W) float32, contiguous, of the image that
    ``srcp`` (H + 2n, W) holds with n rows above and below it.

    CPU tensors run ``poly_expand_plain``; CUDA tensors launch the kernel,
    one 256-thread block per 32x64 tile.
    """
    if srcp.device.type == "cpu":
        return poly_expand_plain(srcp, n, sigma)
    rows = check_args(srcp, n, MAX_N)
    n = int(n)
    if srcp.dim() != 2:
        raise ValueError(f"poly_expand: srcp must be (H + 2n, W), got {tuple(srcp.shape)}")
    if srcp.device.type != "cuda":
        raise ValueError(f"poly_expand: srcp must be on a CUDA device, got {srcp.device}")
    dev = srcp.device
    build.check_tensor("poly_expand", srcp, tuple(srcp.shape), dev)
    w = srcp.shape[1]
    out = torch.empty((5, rows, w), dtype=torch.float32, device=dev)
    tables = [ctypes.cast(t, ctypes.c_void_p) for t in _tables(n, float(sigma))]
    entry = _entry()
    stream = torch.cuda.current_stream(dev).cuda_stream
    poly_expand.launches += 1
    rc = entry(srcp.data_ptr(), out.data_ptr(), rows, w, n, *tables, dev.index or 0, stream)
    build.check(rc, "poly_expand")
    return out


poly_expand.launches = 0
