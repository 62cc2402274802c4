"""Farneback polynomial-expansion optical flow (port of ``models/farneback.py``).

The solver of the JAX package (ref: src/Farneback_PyCL.py and
src/optical_flow_farneback.cl), level by level:
  * polynomialExpansion -> nine separable g/xg/xxg correlations (replicate
    border) and the Gram-inverse combination (``poly_expansion``, the JAX
    package's "vpu" stencil chain);
  * updateMatrices -> R1 sampled at the flow-displaced position, blended
    with R0, border ramp, the five products of M
    (``ops/cuda/tent_sample.py:update_matrices``, the Hopper kernel on CUDA
    tensors);
  * gaussianBlur5 / boxFilter5 + updateFlow -> the window blur of M and the
    regularised 2x2 solve (``ops/cuda/blur5_flow.py:blur5_flow``, the Hopper
    kernel on CUDA tensors).
CPU tensors run the plain PyTorch versions of both kernels.  The host-side
level plan, the PIL-bilinear flow rescaling and the bit-exact blur kernels
(``ops/kernels_bitexact.py``) are the JAX package's.

The JAX ``impl`` values ("xla", "pallas", "pallas_sparse", "pallas_dense",
"pallas_channel*", "pallas_mmblur") choose TPU kernels and VMEM layouts and
raise here.  The JAX package's stacked-Toeplitz expansion
(``ops/matmul_filter.py``, an XLA matmul route) has no counterpart: it
computes the same expansion to 6.7e-6.  The whole iteration loop in one
launch is ``ops/cuda/fb_fused.py:fb_fused``, which the solve does not call,
as in the JAX package.

Not ported yet: the kernel-sharded branch of the adapter
(``models/farneback.py:575-600``, ``parallel/context.py``); it comes with
a later multi-GPU slice (ROADMAP.md Queue 1, item 4.2).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import blur5_flow, tent_sample
from opticalflow_ri_tpu_torch.ops.cuda.blur5_flow import update_flow  # noqa: F401
from opticalflow_ri_tpu_torch.ops.cuda.tent_sample import BORDER_RAMP, assemble_m  # noqa: F401
from opticalflow_ri_tpu_torch.ops.kernels_bitexact import get_gaussian_kernel_bit_exact
from opticalflow_ri_tpu_torch.ops.resize import pil_resize
from opticalflow_ri_tpu_torch.ops.stencil import correlate1d


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


def poly_expansion(src: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(H, W) -> (5, H, W) polynomial-expansion field: the nine correlations
    and five combinations of the JAX package's "vpu" chain, in its order."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = prepare_poly_gaussian(n, float(sigma))
    ve = correlate1d(src, g, axis=-2, mode="nearest")
    vo = correlate1d(src, xg, axis=-2, mode="nearest")
    vx2 = correlate1d(src, xxg, axis=-2, mode="nearest")

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


def _blur_kernel(n: int, sigma: float) -> np.ndarray:
    _, k = get_gaussian_kernel_bit_exact(n, sigma)
    return np.float32(k)


def gaussian_blur(src, smooth_size: int, sigma: float):
    """Separable bit-exact Gaussian, reflect-101 border (``mode="mirror"``)."""
    k = _blur_kernel(smooth_size, float(sigma))
    out = correlate1d(src, k, axis=-2, mode="mirror")
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
    (flowx, flowy).  ``impl="auto"`` is the only value: the two kernels on
    CUDA tensors, their plain versions on CPU tensors."""
    if impl != "auto":
        raise ValueError(
            f"impl={impl!r}: the port offers impl='auto' (the updateMatrices and blur + "
            f"solve kernels); the JAX package's other values select TPU kernels")
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

        ra, rb = (poly_expansion(
            pil_resize(gaussian_blur(im, lvl["smooth"], lvl["sigma"]), (h, w), "bilinear"),
            poly_n, poly_sigma).contiguous() for im in (im1, im2))

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
        fx, fy = farneback_solve(
            im1, im2, U, V, window_size=self.windowSize, n_iters=self.numIters,
            poly_n=self.polyN, poly_sigma=float(self.polySigma),
            use_gaussian=self.useGaussianFilter, pyr_scale=float(self.pyrScale),
            pyr_levels=self.pyramidalLevels,
        )
        # the reference reports no numeric error from this solver (:602)
        return fx, fy, "Unknown"

    def getAlgoName(self):
        return "TPU Farneback"

    def hasGenericPyramidalDefaults(self):
        return self.provideGenericPyramidalDefaults

    def getGenericPyramidalDefaults(self):
        return {"warping": False, "scaling": True}
