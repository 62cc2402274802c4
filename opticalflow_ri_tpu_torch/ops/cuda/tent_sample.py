"""Farneback updateMatrices: the Hopper kernel and its plain version.

``update_matrices`` replaces the TPU kernels of the JAX package's
``ops/pallas/tent_sample.py`` (``update_matrices_pallas``,
``update_matrices_sparse_pallas`` and the channel-blocked
``tent_sample_channel_call`` behind ``update_matrices_channel_pallas``) with
one CUDA kernel (``csrc/fb_update_matrices.cu``): one thread per pixel
gathers the 2x2 enclosing samples of R1 and assembles M in the same pass.
``update_matrices_plain`` is the JAX package's XLA ``update_matrices``
(``models/farneback.py:167-222``) in PyTorch, the dense tent contraction over
(2R+1)^2 shifts or the exact gather; CPU tensors take it.

All take the flow (H, W) and R0, R1 (5, H, W) float32 and return M
(5, H, W) float32.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.cuda.lk_iter import clip_hi
from opticalflow_ri_tpu_torch.ops.padding import pad2d
from opticalflow_ri_tpu_torch.utils.device import device_constant

BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472, 1.0], np.float32)


@lru_cache(maxsize=None)
def _ramp_vectors(rows: int, cols: int, row0: int, img_rows: int):
    """The ramp at each column's distance to the left and right edges and
    each row's to the top and bottom (global rows row0.. of an img_rows-tall
    image), as float32 (1, cols) and (rows, 1) vectors."""
    xi = np.arange(cols)
    yi = np.arange(rows) + row0
    return (BORDER_RAMP[np.minimum(xi, 5)][None, :], BORDER_RAMP[np.minimum(yi, 5)][:, None],
            BORDER_RAMP[np.minimum(cols - xi - 1, 5)][None, :],
            BORDER_RAMP[np.minimum(img_rows - yi - 1, 5)][:, None])


def assemble_m(s, r0, flowx, flowy, inside, row0: int = 0, img_rows: int | None = None):
    """The non-sampling tail of updateMatrices (``models/farneback.py:225-267``):
    difference blend, border attenuation ramp and normal-equation products.
    ``s`` is the sample of R1 at the displaced position and ``inside`` the
    in-image mask; the tile covers global rows [row0, row0 + rows) of an
    ``img_rows``-tall image, and the ramp attenuates at global borders only."""
    rows, cols = flowx.shape
    img_rows = rows if img_rows is None else img_rows
    r2 = torch.where(inside, s[0], 0.0)
    r3 = torch.where(inside, s[1], 0.0)
    r4 = torch.where(inside, (r0[2] + s[2]) * 0.5, r0[2])
    r5 = torch.where(inside, (r0[3] + s[3]) * 0.5, r0[3])
    r6 = torch.where(inside, (r0[4] + s[4]) * 0.25, r0[4] * 0.5)

    r2 = (r0[0] - r2) * 0.5
    r3 = (r0[1] - r3) * 0.5
    r2 = r2 + r4 * flowy + r6 * flowx
    r3 = r3 + r6 * flowy + r5 * flowx

    rx, ry, rcx, rcy = device_constant(_ramp_vectors, rows, cols, int(row0), int(img_rows),
                                       device=flowx.device)
    scale = rx * ry * rcx * rcy
    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    return torch.stack([
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    ])


def update_matrices_plain(flowx, flowy, r0, r1, sample_max_shift: int | None = 5):
    """M from R0, R1 and the flow: R1 sampled at the flow-displaced position
    by the dense tent contraction over shifts [-R, R]^2 (displacement clipped
    to [-R, R - 1e-3], R1 edge-padded; sy outer, sx inner), or by the exact
    4-tap gather when ``sample_max_shift`` is None; then ``assemble_m``."""
    _, rows, cols = r0.shape
    dev = r0.device
    ys = torch.arange(rows, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(cols, dtype=torch.float32, device=dev)[None, :]
    fx = xs + flowx
    fy = ys + flowy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    inside = (x1 >= 0) & (y1 >= 0) & (x1 < cols - 1) & (y1 < rows - 1)

    if sample_max_shift is not None:
        R = int(sample_max_shift)
        dxc = flowx.clamp(float(-R), clip_hi(R))
        dyc = flowy.clamp(float(-R), clip_hi(R))
        rp = pad2d(r1, ((R, R + 1), (R, R + 1)), "nearest")
        s = torch.zeros_like(r1)
        for sy in range(-R, R + 1):
            wy = (1.0 - (dyc - sy).abs()).clamp_min(0.0)
            for sx in range(-R, R + 1):
                w = wy * (1.0 - (dxc - sx).abs()).clamp_min(0.0)
                s = s + w[None] * rp[:, R + sy : R + sy + rows, R + sx : R + sx + cols]
    else:
        fxf = fx - x1
        fyf = fy - y1
        x1c = x1.clamp(0, cols - 2).long()
        y1c = y1.clamp(0, rows - 2).long()
        a00 = (1 - fxf) * (1 - fyf)
        a01 = fxf * (1 - fyf)
        a10 = (1 - fxf) * fyf
        a11 = fxf * fyf
        flat = r1.reshape(5, rows * cols)
        i00 = (y1c * cols + x1c).reshape(-1)

        def at(idx):
            return flat[:, idx].reshape(5, rows, cols)

        s = a00 * at(i00) + a01 * at(i00 + 1) + a10 * at(i00 + cols) + a11 * at(i00 + cols + 1)

    return assemble_m(s, r0, flowx, flowy, inside)


@lru_cache(maxsize=None)
def _entry():
    entry = build.load_library().ofri_fb_update_matrices
    entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def update_matrices(flowx, flowy, r0, r1, sample_max_shift: int | None = 5):
    """Assemble M; returns (5, H, W) float32.

    CPU tensors run ``update_matrices_plain``; CUDA tensors launch the
    kernel, one thread per pixel.
    """
    if flowx.device.type == "cpu":
        return update_matrices_plain(flowx, flowy, r0, r1, sample_max_shift)
    build.check_fields("update_matrices", flowx, flowy)
    h, w = flowx.shape
    dev = flowx.device
    for t in (r0, r1):
        build.check_tensor("update_matrices", t, (5, h, w), dev)
    R, hi = shift_args(sample_max_shift)
    m = torch.empty((5, h, w), dtype=torch.float32, device=dev)
    entry = _entry()
    stream = torch.cuda.current_stream(dev).cuda_stream
    update_matrices.launches += 1
    rc = entry(r0.data_ptr(), r1.data_ptr(), flowx.data_ptr(), flowy.data_ptr(), m.data_ptr(),
               h, w, R, hi, dev.index or 0, stream)
    build.check(rc, "update_matrices")
    return m


update_matrices.launches = 0


def shift_args(sample_max_shift: int | None):
    """(R, hi) as the kernels take them: R < 0 selects the exact gather."""
    if sample_max_shift is None:
        return -1, 0.0
    R = int(sample_max_shift)
    if R < 0:
        raise ValueError(f"sample_max_shift must be None or >= 0, got {sample_max_shift}")
    return R, clip_hi(R)
