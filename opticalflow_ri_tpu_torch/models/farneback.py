"""Farneback polynomial-expansion optical flow (port of ``models/farneback.py``).

The solver of the JAX package (ref: src/Farneback_PyCL.py and
src/optical_flow_farneback.cl), level by level:
  * polynomialExpansion -> nine separable g/xg/xxg correlations (replicate
    border) and the Gram-inverse combination (``poly_expansion``, the JAX
    package's "vpu" stencil chain; ``ops/cuda/poly_expand.py:poly_expand``,
    one Hopper kernel a frame on CUDA tensors);
  * updateMatrices -> R1 sampled at the flow-displaced position, blended
    with R0, border ramp, the five products of M
    (``ops/cuda/tent_sample.py:update_matrices``, the Hopper kernel on CUDA
    tensors);
  * gaussianBlur5 / boxFilter5 + updateFlow -> the window blur of M and the
    regularised 2x2 solve (``ops/cuda/blur5_flow.py:blur5_flow``, the Hopper
    kernel on CUDA tensors).
CPU tensors run the plain PyTorch versions of the three kernels.  The host-side
level plan, the PIL-bilinear flow rescaling and the bit-exact blur kernels
(``ops/kernels_bitexact.py``) are the JAX package's.

The JAX ``impl`` values ("xla", "pallas", "pallas_sparse", "pallas_dense",
"pallas_channel*", "pallas_mmblur") choose TPU kernels and VMEM layouts and
raise here.  The JAX package's stacked-Toeplitz expansion
(``ops/matmul_filter.py``, an XLA matmul route) has no counterpart: it
computes the same expansion to 6.7e-6.  The whole iteration loop in one
launch is ``ops/cuda/fb_fused.py:fb_fused``, which the solve does not call,
as in the JAX package.

The rows-sharded solve is ``parallel/sharded_kernel.py:farneback_solve_sharded``.
While ``parallel.context.kernel_sharded_solvers(mesh)`` is active the
adapter takes this rank's ("y", "x") tiles, gathers them along x into that
solve's ("y", None) stripes and keeps its own x block; a stripe or level
the solve refuses raises ``ValueError`` (no single-device fallback).
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import blur5_flow, poly_expand, tent_sample
from opticalflow_ri_tpu_torch.ops.cuda.blur5_flow import update_flow  # noqa: F401
from opticalflow_ri_tpu_torch.ops.cuda.poly_expand import prepare_poly_gaussian  # noqa: F401
from opticalflow_ri_tpu_torch.ops.cuda.tent_sample import BORDER_RAMP, assemble_m  # noqa: F401
from opticalflow_ri_tpu_torch.ops.kernels_bitexact import get_gaussian_kernel_bit_exact
from opticalflow_ri_tpu_torch.ops.padding import pad2d
from opticalflow_ri_tpu_torch.ops.resize import pil_resize
from opticalflow_ri_tpu_torch.ops.stencil import correlate1d, correlate1d_padded
from opticalflow_ri_tpu_torch.utils.timing import span


def poly_expansion(src: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(H, W) -> (5, H, W) polynomial-expansion field: the nine correlations
    and five combinations of the JAX package's "vpu" chain, in its order."""
    return poly_expansion_padded(pad2d(src, ((n, n), (0, 0)), "nearest"), n, sigma)


def poly_expansion_padded(srcp: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """``poly_expansion`` of the (H, W) image that ``srcp`` holds with n more
    rows above and below it: the replicate rule's, or a neighbour's (a
    rows-sharded stripe's halo, ``parallel/sharded_kernel.py``).  CUDA
    tensors launch the expansion kernel, CPU tensors run the plain chain
    (``ops/cuda/poly_expand.py``)."""
    return poly_expand.poly_expand(srcp, n, sigma)


def _blur_kernel(n: int, sigma: float) -> np.ndarray:
    _, k = get_gaussian_kernel_bit_exact(n, sigma)
    return np.float32(k)


def gaussian_blur(src, smooth_size: int, sigma: float):
    """Separable bit-exact Gaussian, reflect-101 border (``mode="mirror"``)."""
    half = smooth_size // 2
    return gaussian_blur_padded(pad2d(src, ((half, half), (0, 0)), "mirror"), smooth_size, sigma)


def gaussian_blur_padded(srcp, smooth_size: int, sigma: float):
    """``gaussian_blur`` of the image that ``srcp`` holds with smooth_size // 2
    more rows above and below it (the mirror rule's, or a neighbour's)."""
    k = _blur_kernel(smooth_size, float(sigma))
    out = correlate1d_padded(srcp, k, -2, srcp.shape[-2] - 2 * (smooth_size // 2))
    return correlate1d(out, k, axis=-1, mode="mirror")


def gaussian_blur5(m, smooth_size: int, sigma: float):
    """``gaussian_blur`` of each of the five planes of M."""
    return gaussian_blur(m, smooth_size, sigma)


def box_filter5(m, ksize_half: int):
    """Box sums of each plane of M, replicate border, then the 1/n^2 scale."""
    k = np.ones(2 * ksize_half + 1, np.float32)
    out = correlate1d(m, k, axis=-2, mode="nearest")
    out = correlate1d(out, k, axis=-1, mode="nearest")
    return out * float(np.float32(1.0 / (2 * ksize_half + 1) ** 2))


def _window_blur_spec(window_size: int, use_gaussian: bool):
    """(taps, border mode, post-scale) of the per-iteration window blur."""
    if use_gaussian:
        return _blur_kernel(window_size, window_size / 2 * 0.3), "mirror", 1.0
    half = window_size // 2
    return (np.ones(2 * half + 1, np.float32), "nearest",
            1.0 / (2 * half + 1) ** 2)


def _level_plan(rows, cols, pyr_scale, levels):
    """Static per-level geometry, cropped at min size 32
    (ref: src/Farneback_PyCL.py:468-487, :508-515)."""
    min_size = 32
    scale = 1.0
    final_levels = 0
    while final_levels < levels:
        scale *= pyr_scale
        if cols * scale < min_size or rows * scale < min_size:
            break
        final_levels += 1
    plan = []
    for k in range(final_levels, -1, -1):
        s = pyr_scale**k
        sigma = (1.0 / s - 1.0) * 0.5
        smooth = max(int(round(sigma * 5)) | 1, 3)
        plan.append(
            dict(scale=s, sigma=sigma, smooth=smooth,
                 width=int(round(cols * s)), height=int(round(rows * s)))
        )
    return plan


def farneback_solve(im1, im2, u0, v0, window_size=33, n_iters=5, poly_n=7,
                    poly_sigma=1.5, use_gaussian=True, pyr_scale=0.5,
                    pyr_levels=1, impl: str = "auto"):
    """The whole Farneback pipeline (``models/farneback.py:497-546``); returns
    (flowx, flowy).  ``impl="auto"`` is the only value: the three kernels on
    CUDA tensors, their plain versions on CPU tensors.  Under a profiler each
    frame's expansion is a span ``ofri.expand`` and the rounds ``ofri.iterate``."""
    if impl != "auto":
        raise ValueError(
            f"impl={impl!r}: the port offers impl='auto' (the expansion, updateMatrices "
            f"and blur + solve kernels); the JAX package's other values select TPU kernels")
    im1 = im1.to(torch.float32)
    im2 = im2.to(torch.float32)
    u0 = u0.to(torch.float32)
    v0 = v0.to(torch.float32)
    rows, cols = im1.shape
    plan = _level_plan(rows, cols, pyr_scale, pyr_levels - 1)
    taps, mode, scale = _window_blur_spec(window_size, use_gaussian)

    prev = None
    for lvl in plan:
        h, w = lvl["height"], lvl["width"]
        if prev is None:
            f = float(np.float32(lvl["scale"]))
            fx = pil_resize(u0, (h, w), "bilinear") * f
            fy = pil_resize(v0, (h, w), "bilinear") * f
        else:
            f = float(np.float32(1.0 / pyr_scale))
            fx = pil_resize(prev[0], (h, w), "bilinear") * f
            fy = pil_resize(prev[1], (h, w), "bilinear") * f
        fx, fy = fx.contiguous(), fy.contiguous()

        def expand(im):
            src = pil_resize(gaussian_blur(im, lvl["smooth"], lvl["sigma"]), (h, w), "bilinear")
            with span("expand"):
                return poly_expansion(src, poly_n, poly_sigma).contiguous()

        ra, rb = expand(im1), expand(im2)

        with span("iterate"):
            m = tent_sample.update_matrices(fx, fy, ra, rb)
            for i in range(n_iters):
                fx, fy = blur5_flow.blur5_flow(m, taps, mode, scale)
                if i < n_iters - 1:
                    m = tent_sample.update_matrices(fx, fy, ra, rb)
        prev = (fx, fy)

    return prev


class FarnebackAdapter:
    """Driver adapter with the reference constructor surface
    (ref: src/Farneback_PyCL.py:65-122)."""

    def __init__(self, windowSize: int = 33, Niters: int = 5, polyN: int = 7,
                 polySigma: float = 1.5, useGaussian: bool = True,
                 pyrScale: float = 0.5, pyramidalLevels: int = 1,
                 provideGenericPyramidalDefaults: bool = True):
        assert pyramidalLevels >= 1, "Pyramidal levels must be >= 1"
        if windowSize % 2 == 0:
            raise ValueError("windowSize must be an odd value")
        assert polyN in (5, 7)
        self.windowSize = windowSize
        self.numIters = Niters
        self.polyN = int(polyN)
        self.polySigma = polySigma
        self.useGaussianFilter = useGaussian
        self.pyrScale = pyrScale
        self.pyramidalLevels = pyramidalLevels
        self.provideGenericPyramidalDefaults = provideGenericPyramidalDefaults

    def compute(self, im1, im2, U, V):
        from opticalflow_ri_tpu_torch.parallel.context import current_kernel_shard

        mesh = current_kernel_shard()
        kw = dict(window_size=self.windowSize, n_iters=self.numIters, poly_n=self.polyN,
                  poly_sigma=float(self.polySigma), use_gaussian=self.useGaussianFilter,
                  pyr_scale=float(self.pyrScale), pyr_levels=self.pyramidalLevels)
        if mesh is None:
            fx, fy = farneback_solve(im1, im2, U, V, **kw)
        else:
            from opticalflow_ri_tpu_torch.parallel import sharded_kernel as sk

            fx, fy = sk.on_stripes(mesh, sk.farneback_solve_sharded, im1, im2, U, V, **kw)
        # the reference reports no numeric error from this solver (:602)
        return fx, fy, "Unknown"

    def getAlgoName(self):
        return "TPU Farneback"

    def hasGenericPyramidalDefaults(self):
        return self.provideGenericPyramidalDefaults

    def getGenericPyramidalDefaults(self):
        return {"warping": False, "scaling": True}
