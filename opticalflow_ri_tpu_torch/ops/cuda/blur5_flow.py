"""Farneback window blur + flow solve: the Hopper kernel and its plain version.

``blur5_flow`` replaces the TPU kernels ``ops/pallas/blur5_flow.py:
blur5_flow_pallas`` and ``blur5_flow_banded_pallas`` with one CUDA kernel
(``csrc/fb_blur5_flow.cu``): the separable window blur of the five M planes,
y-pass then x-pass, the optional post-scale and the regularised 2x2 solve,
writing only the flow.  ``blur5_flow_plain`` is the JAX package's stencil
path (``gaussian_blur5`` or ``box_filter5``, then ``update_flow``,
``models/farneback.py:154-164, 462-466``) in PyTorch; CPU tensors take it.

``taps`` is the 1-D window (odd length, at most ``MAX_TAPS``), ``mode`` its
border rule ("mirror": reflect-101, the Gaussian window; "nearest":
replicate, the box), ``scale`` the post-scale (1.0: none).  All return
(flowx, flowy), each (H, W) float32.

``edges`` is K12/K13's sharded mode (the JAX package's ``blur5_flow_call``
on a caller-padded M, ``parallel/sharded_pallas.py:410-416``): the bits
``TOP`` and ``BOTTOM`` say which of M's y sides are the image's border.  A
side that is not comes with ``half = len(taps) // 2`` rows of the
neighbour's M, which the y-pass reads; a border side keeps the border rule.
M is then (5, a_top + H + a_bot, W).  x is always the whole width.  The
default, both sides on the border, is the whole-image call.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.cuda.hs_iter import BOTTOM, TOP
from opticalflow_ri_tpu_torch.ops.stencil import correlate1d

MAX_TAPS = 129  # csrc/fb_common.cuh: kMaxTaps
MODES = {"mirror": 0, "nearest": 1}
OUTPUTS_PER_THREAD = 8  # csrc/fb_blur5_flow.cu: kR, the register blocking of each pass


def check_window(taps, mode: str):
    """The taps as float32 and the border rule's code; raises on a window
    the kernels do not take."""
    k = np.asarray(taps, dtype=np.float32).reshape(-1)
    if k.size % 2 == 0 or k.size > MAX_TAPS:
        raise ValueError(f"the window blur takes an odd number of taps up to {MAX_TAPS}, "
                         f"got {k.size}")
    if mode not in MODES:
        raise ValueError(f"window blur mode must be one of {tuple(MODES)}, got {mode!r}")
    return k, MODES[mode]


def y_apron(rows: int, n: int, edges: int) -> tuple:
    """(a_top, a_bot): the rows of neighbour M above and below the field for
    the ``edges`` mask and an n-tap window; raises where ``rows`` (M's) leave
    a field of fewer than 2 rows."""
    if not 0 <= int(edges) <= TOP | BOTTOM:
        raise ValueError(f"blur5_flow: edges must be a mask of TOP and BOTTOM, got {edges}")
    half = n // 2
    a_top = 0 if edges & TOP else half
    a_bot = 0 if edges & BOTTOM else half
    if rows - a_top - a_bot < 2:
        raise ValueError(f"blur5_flow: fields must be at least 2x2; M's {rows} rows less the "
                         f"apron ({a_top}, {a_bot}) leave {rows - a_top - a_bot}")
    return a_top, a_bot


@lru_cache(maxsize=None)
def _entry():
    entry = build.load_library().ofri_fb_blur5_flow
    entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def update_flow(m):
    """Regularised per-pixel 2x2 solve (ref: optical_flow_farneback.cl:408-429)."""
    g11, g12, g22, h1, h2 = m[0], m[1], m[2], m[3], m[4]
    det_inv = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * det_inv, (g22 * h1 - g12 * h2) * det_inv


def blur5_flow_plain(m, taps, mode: str, scale: float = 1.0, edges: int = TOP | BOTTOM):
    """Blur the five planes of ``m`` (y-pass, then x-pass), post-scale, solve.
    The y-pass runs over every row present, the border rule at M's first
    and last; the apron rows' outputs are dropped."""
    k, _ = check_window(taps, mode)
    a_top, a_bot = y_apron(m.shape[-2], k.size, edges)
    out = correlate1d(m, k, axis=-2, mode=mode)
    if a_top or a_bot:
        out = out[..., a_top : out.shape[-2] - a_bot, :]
    out = correlate1d(out, k, axis=-1, mode=mode)
    if scale != 1.0:
        out = out * float(np.float32(scale))
    return update_flow(out)


def blur5_flow(m, taps, mode: str, scale: float = 1.0, edges: int = TOP | BOTTOM):
    """Window-blur M and solve for the flow; returns (flowx, flowy).

    CPU tensors run ``blur5_flow_plain``; CUDA tensors launch the kernel,
    one 640-thread block per 32x64 tile, a group of 128 threads per plane.
    ``edges``: the y mask (module docstring).
    """
    if m.device.type == "cpu":
        return blur5_flow_plain(m, taps, mode, scale, edges)
    k, code = check_window(taps, mode)
    if m.dim() != 3 or m.shape[0] != 5:
        raise ValueError(f"blur5_flow: m must be (5, H, W), got {tuple(m.shape)}")
    if m.device.type != "cuda":
        raise ValueError(f"blur5_flow: m must be on a CUDA device, got {m.device}")
    build.check_tensor("blur5_flow", m, tuple(m.shape), m.device)
    a_top, a_bot = y_apron(m.shape[1], k.size, edges)
    h, w = m.shape[1] - a_top - a_bot, m.shape[2]
    if w < 2:
        raise ValueError(f"blur5_flow: fields must be at least 2x2, got {(h, w)}")
    dev = m.device
    fx = torch.empty((h, w), dtype=torch.float32, device=dev)
    fy = torch.empty_like(fx)
    table = (ctypes.c_float * k.size)(*k.tolist())
    entry = _entry()
    stream = torch.cuda.current_stream(dev).cuda_stream
    blur5_flow.launches += 1
    rc = entry(m.data_ptr(), fx.data_ptr(), fy.data_ptr(), h, w, a_top, a_bot,
               ctypes.cast(table, ctypes.c_void_p), k.size, code, float(np.float32(scale)),
               dev.index or 0, stream)
    build.check(rc, "blur5_flow")
    return fx, fy


blur5_flow.launches = 0
