"""The Farneback iteration loop in one launch: the Hopper kernel and its plain
version.

``fb_fused`` replaces the TPU kernel ``ops/pallas/fb_fused2.py:
fb_fused2_pallas`` with one persistent cooperative CUDA launch
(``csrc/fb_fused.cu``): M of the start flow, then ``n_iters`` rounds, each
one grid barrier and then, tile by tile (``TILE_ROWS`` x ``TILE_COLS``
pixels, the blocks walking the tiles), the window blur of M in shared memory
(the tile routine of the blur + solve kernel), the 2x2 solve and M of the new
flow.  M lives in two ping-pong buffers: a round reads one and writes the
other, since its tiles' halos are other blocks' pixels.  The flow is written
in the last round only.  ``fb_fused_plain`` runs the same rounds as
``update_matrices_plain`` -> ``blur5_flow_plain``; CPU tensors take it.  As in
the JAX package, ``farneback_solve`` does not call it
(``models/farneback.py:395-399`` there); it is an entry of its own.

r0, r1: (5, H, W) polynomial expansions; fx0, fy0: (H, W) initial flow.
Returns (flowx, flowy), each (H, W) float32.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.cuda.blur5_flow import blur5_flow_plain, check_window
from opticalflow_ri_tpu_torch.ops.cuda.tent_sample import shift_args, update_matrices_plain

TILE_ROWS, TILE_COLS = 32, 64  # csrc/fb_tile.cuh: kTH; csrc/fb_fused.cu: BlurTile<64>


def fb_fused_plain(r0, r1, fx0, fy0, n_iters: int, taps, mode: str, scale: float = 1.0,
                   sample_max_shift: int | None = 5):
    """``n_iters`` rounds of updateMatrices, then blur + solve."""
    fx, fy = fx0, fy0
    for _ in range(int(n_iters)):
        m = update_matrices_plain(fx, fy, r0, r1, sample_max_shift)
        fx, fy = blur5_flow_plain(m, taps, mode, scale)
    return fx, fy


@lru_cache(maxsize=None)
def _entry():
    entry = build.load_library().ofri_fb_fused
    entry.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def fb_fused(r0, r1, fx0, fy0, n_iters: int, taps, mode: str, scale: float = 1.0,
             sample_max_shift: int | None = 5):
    """Run the Farneback iteration loop; returns (flowx, flowy).

    CPU tensors run ``fb_fused_plain``; CUDA tensors launch the kernel once
    (a cooperative launch: it raises if the device cannot run one).
    """
    if fx0.device.type == "cpu":
        return fb_fused_plain(r0, r1, fx0, fy0, n_iters, taps, mode, scale, sample_max_shift)
    k, code = check_window(taps, mode)
    build.check_fields("fb_fused", fx0, fy0)
    h, w = fx0.shape
    dev = fx0.device
    for t in (r0, r1):
        build.check_tensor("fb_fused", t, (5, h, w), dev)
    if int(n_iters) < 0:
        raise ValueError(f"fb_fused: n_iters must be >= 0, got {n_iters}")
    R, hi = shift_args(sample_max_shift)
    fx = torch.empty((h, w), dtype=torch.float32, device=dev)
    fy = torch.empty_like(fx)
    m = torch.empty((2, 5, h, w), dtype=torch.float32, device=dev)  # M_a, M_b
    table = (ctypes.c_float * k.size)(*k.tolist())
    entry = _entry()
    stream = torch.cuda.current_stream(dev).cuda_stream
    fb_fused.launches += 1
    rc = entry(r0.data_ptr(), r1.data_ptr(), fx0.data_ptr(), fy0.data_ptr(), fx.data_ptr(),
               fy.data_ptr(), m[0].data_ptr(), m[1].data_ptr(), h, w, int(n_iters), R, hi,
               ctypes.cast(table, ctypes.c_void_p), k.size, code, float(np.float32(scale)),
               dev.index or 0, stream)
    build.check(rc, "fb_fused")
    return fx, fy


fb_fused.launches = 0
