"""Liu-Shen physics-based optical flow, the continuity-equation refiner (port
of ``models/liu_shen.py``).

The fixed-point solve runs in the Hopper kernel
``ops/cuda/liu_shen_iter.py:liu_shen_iterate`` for CUDA tensors and in its
plain PyTorch version for CPU tensors; the per-iteration update
(``liu_shen_iteration``, ``ls_field_stencils``, ``ls_ring_sum``) is defined
there, beside the kernel, and re-exported here.  Parity notes carried over
from the JAX package:
  * every stencil is a correlation with the original MATLAB kernels;
  * border modes: "nearest" everywhere except the H-kernel terms and the
    neighbour-count field, which are zero-padded;
  * both frames are normalised by their own global maxima;
  * the solver's "u" axis is image rows; the adapter swaps components on the
    way in and out.

While ``parallel.context.kernel_sharded_solvers(mesh)`` is active the
adapter takes this rank's ("y", "x") tiles, gathers them along x into the
("y", None) stripes of the rows-sharded kernel solve
(``parallel/sharded_kernel.py:liu_shen_solve_sharded_kernel``) and keeps
its own x block of the result; a stripe that solve refuses raises
``ValueError`` (no single-device fallback).
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import liu_shen_iter
from opticalflow_ri_tpu_torch.ops.cuda.liu_shen_iter import (  # noqa: F401  (re-exported)
    liu_shen_iteration, ls_field_stencils, ls_ring_sum,
)
from opticalflow_ri_tpu_torch.ops.stencil import correlate3x3
from opticalflow_ri_tpu_torch.utils.timing import span

# Original (MATLAB-orientation) kernels; applied as correlations.
_K_D1 = np.array([[0, -1, 0], [0, 0, 0], [0, 1, 0]], np.float32) / 2.0   # d/drow
_K_D2 = _K_D1.T                                                          # d/dcol
_K_F1 = np.array([[0, 1, 0], [0, 0, 0], [0, 1, 0]], np.float32)          # row-neighbour sum
_K_F2 = _K_F1.T
_K_M = np.array([[1, 0, -1], [0, 0, 0], [-1, 0, 1]], np.float32) / 4.0   # mixed derivative
_K_D2ND = np.array([[0, 1, 0], [0, -2, 0], [0, 1, 0]], np.float32)       # 2nd deriv (rows)
_K_H = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]], np.float32)           # 8-neighbour sum


def _d1(x):
    return correlate3x3(x, _K_D1, "nearest")


def _d2(x):
    return correlate3x3(x, _K_D2, "nearest")


def liu_shen_precompute(im1, im2, h):
    """The 8 iteration-invariant fields (iix, iiy, ii, ixt, iyt, b11, b12,
    b22): image products, RHS constants and the per-pixel 2x2 inverse
    system (``models/liu_shen.py:52-71``)."""
    iix = im1 * _d1(im1)
    iiy = im1 * _d2(im1)
    ii = im1 * im1
    dt = im2 - im1
    ixt = im1 * _d1(dt)
    iyt = im1 * _d2(dt)

    h = float(np.float32(h))
    cmtx = correlate3x3(torch.ones_like(im1), _K_H, "constant")
    a11 = im1 * (correlate3x3(im1, _K_D2ND, "nearest") - 2.0 * im1) - h * cmtx
    a22 = im1 * (correlate3x3(im1, _K_D2ND.T, "nearest") - 2.0 * im1) - h * cmtx
    a12 = im1 * correlate3x3(im1, _K_M, "nearest")
    det = a11 * a22 - a12 * a12
    b11 = a22 / det
    b12 = -a12 / det
    b22 = a11 / det
    return (iix, iiy, ii, ixt, iyt, b11, b12, b22)


def liu_shen_solve(im1, im2, h, u0, v0, max_iter: int = 60, tol: float = 1e-8):
    """Run the Liu-Shen fixed-point solve; returns (u, v, err) with u along
    rows (see the adapter for the swap).  ``err`` is a 0-d float32 tensor on
    the flow's device, 0 when no iteration ran.  Under a profiler the fields
    are a span ``ofri.precompute`` and the solve ``ofri.iterate``."""
    im1 = im1.to(torch.float32)
    im2 = im2.to(torch.float32)
    im1 = im1 / im1.max()
    im2 = im2 / im2.max()
    with span("precompute"):
        fields = liu_shen_precompute(im1, im2, h)
    with span("iterate"):
        u, v, err, _ = liu_shen_iter.liu_shen_iterate(
            h, fields, u0.to(torch.float32).contiguous(), v0.to(torch.float32).contiguous(),
            max_iter, tol)
    return u, v, err


class LiuShenOpticalFlowAlgoAdapter:
    """Driver adapter; swaps flow components in and out like the reference."""

    def __init__(self, alpha):
        self.alpha = alpha

    def compute(self, im1, im2, U, V):
        from opticalflow_ri_tpu_torch.parallel.context import current_kernel_shard

        mesh = current_kernel_shard()
        if mesh is None:
            rv, ru, err = liu_shen_solve(im1, im2, float(self.alpha), V, U)
        else:
            from opticalflow_ri_tpu_torch.parallel import sharded_kernel as sk

            rv, ru, err = sk.on_stripes(mesh, sk.liu_shen_solve_sharded_kernel, im1, im2,
                                        float(self.alpha), V, U)
        return [ru, rv, err]

    def getAlgoName(self):
        return "Liu-Shen Physics based OF"

    def hasGenericPyramidalDefaults(self):
        return False
