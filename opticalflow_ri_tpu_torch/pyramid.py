"""Generic coarse-to-fine pyramidal optical-flow driver (port of ``pyramid.py``).

Control flow, level ordering, scaling flags, FILTER/FILTER_OPT semantics
(3-px vs 5-px kernels) and the adapter-defaults override are those of the JAX
package; the image math runs as PyTorch ops on the images' device:

  * image downsizing       -> PIL-BICUBIC-equivalent matmul resize (ops.resize)
  * flow upsampling        -> RectBivariateSpline-equivalent matmuls
  * symmetric warping      -> ops.warp (the Hopper warp kernel on CUDA)
  * pre-filtering          -> calibrated separable Gaussian (ops.gaussian)

Adapters follow the reference protocol: ``compute(im1, im2, U, V) ->
(U, V, error)``, ``getAlgoName()``, ``hasGenericPyramidalDefaults()``,
``getGenericPyramidalDefaults()``.

While ``parallel.context.kernel_sharded_solvers(mesh)`` is active (route 2
of ``parallel.auto.auto_sharded_pipeline``) the images are this rank's
("y", "x") tiles: the driver picks the tile glue once a run
(``parallel/sharded_glue.py:TileGlue``, on the global level shapes worked
out from the tile and the mesh), and the adapters run their kernel-sharded
solves.
Outside the context every call is the single-device one.

Tensor inputs stay on their device; numpy inputs go to ``device`` (default
"cuda").  Nothing moves to the CPU behind the caller's back, and nothing on
the path waits for the device, so a run can be captured in a CUDA graph
(``compile.compiled_pipeline``): the adapters' errors stay device tensors and
are logged only outside a capture.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.gaussian import gaussian_filter_px
from opticalflow_ri_tpu_torch.ops.resize import pil_resize, spline_upsample
from opticalflow_ri_tpu_torch.ops.warp import symmetric_warp_pair, liu_shen_warp
from opticalflow_ri_tpu_torch.utils.device import capturing

log = logging.getLogger("opticalflow_ri_tpu_torch")


def _as_image(x, device="cuda") -> torch.Tensor:
    """A float32 tensor of ``x``: tensors keep their device, anything else
    (numpy arrays) is placed on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _log_error(adapter, error) -> None:
    """Log an adapter's error at INFO.  The error is a device tensor, and
    formatting it waits for the device, which a CUDA graph capture forbids:
    while the stream is capturing nothing is logged."""
    if log.isEnabledFor(logging.INFO) and not capturing():
        log.info("%s estimated error for image registration: %s", adapter.getAlgoName(), error)


class _DeviceGlue:
    """The single-device glue: the ops of ``ops/resize.py``, ``ops/warp.py``
    and ``ops/gaussian.py`` on whole images.  ``parallel.sharded_glue.
    TileGlue`` has the same interface on this rank's tiles."""

    @staticmethod
    def shape(shape) -> tuple:
        return int(shape[-2]), int(shape[-1])

    @staticmethod
    def check_splits(shape, what: str) -> None:
        pass

    resize = staticmethod(pil_resize)
    upsample = staticmethod(spline_upsample)
    warp_pair = staticmethod(symmetric_warp_pair)
    warp = staticmethod(liu_shen_warp)
    prefilter = staticmethod(gaussian_filter_px)


DEVICE_GLUE = _DeviceGlue()


def _pick_glue():
    """The glue of this run: the tile glue bound to the mesh of an active
    ``kernel_sharded_solvers`` context, else ``DEVICE_GLUE``.  ``parallel``
    is imported at call time: it imports the models, which the importers of
    this module import first."""
    from opticalflow_ri_tpu_torch.parallel.context import current_kernel_shard

    mesh = current_kernel_shard()
    if mesh is None:
        return DEVICE_GLUE
    from opticalflow_ri_tpu_torch.parallel.sharded_glue import TileGlue

    return TileGlue(mesh)


def _imresize_bicubic(im, scale, glue=DEVICE_GLUE):
    """PIL-convention size rounding (``pyramid.py:34-38``)."""
    in_h, in_w = glue.shape(im.shape)
    out_w = int(np.round(in_w * scale))
    out_h = int(np.round(in_h * scale))
    return glue.resize(im, (out_h, out_w), "bicubic")


def update_next_pyramidal_level(
    im1_next, prev_shape, im2_next, u_accum, v_accum, u, v,
    warping=True, bi_linear=True, scale=False, glue=DEVICE_GLUE,
):
    """Carry accumulated flow (and optionally warp the image pair) into a new
    pyramid level.  Returns (im1, im2, u_accum, v_accum, u_init, v_init).
    With the tile glue (the module docstring) the arrays are tiles and
    ``prev_shape`` the previous level's tile shape."""
    y_dim, x_dim = glue.shape(im1_next.shape)
    y_prev, x_prev = glue.shape(prev_shape)

    if (x_prev, y_prev) != (x_dim, y_dim):
        us_new = glue.upsample(u_accum, (y_dim, x_dim))
        vs_new = glue.upsample(v_accum, (y_dim, x_dim))
    else:
        us_new = u_accum
        vs_new = v_accum

    if scale:
        us_new = us_new * float(np.float32(x_dim) / np.float32(x_prev))
        vs_new = vs_new * float(np.float32(y_dim) / np.float32(y_prev))

    zeros = torch.zeros(im1_next.shape[-2:], dtype=torch.float32, device=im1_next.device)
    if warping:
        if bi_linear:
            im1_next, im2_next = glue.warp_pair(im1_next, im2_next, us_new, vs_new)
        else:
            im1_next = glue.warp(im1_next, us_new, vs_new)
        return im1_next, im2_next, us_new, vs_new, zeros, zeros
    return im1_next, im2_next, zeros, zeros, us_new, vs_new


def generic_pyramidal_optical_flow(
    im1, im2, FILTER, mainOFlowAlgoAdapter, pyramidalLevels=1, kLevels=1,
    FILTER_OPT=None, optionalOFlowAlgoAdapter=None, warping=True, biLinear=True,
    pyramidalIntermediateScaling=True, pyramidalScaling=False, device="cuda",
):
    """Coarse-to-fine pyramidal processing of a main (and optional refinement)
    optical-flow adapter; returns (U, V) as float32 tensors on the images'
    device."""
    im1 = _as_image(im1, device)
    im2 = _as_image(im2, device)
    if im1.device != im2.device:
        raise ValueError(f"images on different devices: {im1.device} and {im2.device}")
    glue = _pick_glue()
    h, w = glue.shape(im1.shape)
    for level in range(1, pyramidalLevels + 1):   # on tiles: every level splits, or raise
        scale = 1.0 / (2.0 ** (pyramidalLevels - level))
        shape = (int(np.round(h * scale)), int(np.round(w * scale))) if scale < 1.0 else (h, w)
        glue.check_splits(shape, f"pyramid level {level} of {pyramidalLevels}")

    if mainOFlowAlgoAdapter.hasGenericPyramidalDefaults():
        defaults = mainOFlowAlgoAdapter.getGenericPyramidalDefaults()
        if defaults is not None:
            for key in ("warping", "biLinear", "intermediateScaling", "scaling"):
                val = defaults.get(key)
                if val is None:
                    continue
                log.info("Using algorithm %s default for %s: %s",
                         mainOFlowAlgoAdapter.getAlgoName(), key, val)
                if key == "warping":
                    warping = val
                elif key == "biLinear":
                    biLinear = val
                elif key == "intermediateScaling":
                    pyramidalIntermediateScaling = val
                else:
                    pyramidalScaling = val

    scale = 1.0 / (2.0 ** (pyramidalLevels - 1))
    u = v = u_accum = v_accum = None
    prev_shape = None

    for level in range(1, pyramidalLevels + 1):
        local_scaling = pyramidalIntermediateScaling
        if level == pyramidalLevels:
            local_scaling = pyramidalScaling

        if scale < 1.0 and level != pyramidalLevels:
            im1_new = _imresize_bicubic(im1, scale, glue)
            im2_new = _imresize_bicubic(im2, scale, glue)
        elif scale > 1.0:
            raise ValueError(f"Invalid scale level: {scale}")
        else:
            im1_new = im1
            im2_new = im2

        if level > 1:
            im1_warp, im2_warp, u_accum, v_accum, u, v = update_next_pyramidal_level(
                im1_new, prev_shape, im2_new, u_accum, v_accum, u, v,
                warping, biLinear, local_scaling, glue,
            )
        else:
            im1_warp, im2_warp = im1_new, im2_new
            zeros = torch.zeros(im1_new.shape, dtype=torch.float32, device=im1_new.device)
            u = v = u_accum = v_accum = zeros

        if FILTER > 1e-3:
            im1_work = glue.prefilter(im1_warp, FILTER, 3)
            im2_work = glue.prefilter(im2_warp, FILTER, 3)
        else:
            im1_work, im2_work = im1_warp, im2_warp

        if optionalOFlowAlgoAdapter is not None and FILTER_OPT > 1e-3:
            im1_opt = glue.prefilter(im1_new, FILTER_OPT, 5)
            im2_opt = glue.prefilter(im2_new, FILTER_OPT, 5)
        elif optionalOFlowAlgoAdapter is not None:
            im1_opt, im2_opt = im1_new, im2_new

        for k in range(kLevels):
            log.info("Level=%d kIter=%d", level, k)
            if k > 0:
                if warping:
                    im1_warp, im2_warp, u_accum, v_accum, u, v = update_next_pyramidal_level(
                        im1_new, im1_new.shape[-2:], im2_new, u_accum, v_accum, u, v,
                        warping, biLinear, False, glue,
                    )
                    if FILTER > 1:
                        im1_work = glue.prefilter(im1_warp, FILTER, 3)
                        im2_work = glue.prefilter(im2_warp, FILTER, 3)
                    else:
                        im1_work, im2_work = im1_warp, im2_warp
                else:
                    im1_work, im2_work, u_accum, v_accum, u, v = update_next_pyramidal_level(
                        im1_work, im1_work.shape[-2:], im2_work, u_accum, v_accum, u, v,
                        warping, biLinear, False, glue,
                    )

            u, v, error = mainOFlowAlgoAdapter.compute(im1_work, im2_work, u, v)
            _log_error(mainOFlowAlgoAdapter, error)

            if optionalOFlowAlgoAdapter is not None:
                u, v, error_opt = optionalOFlowAlgoAdapter.compute(im1_opt, im2_opt, u, v)
                _log_error(optionalOFlowAlgoAdapter, error_opt)

            u_accum = u_accum + _as_image(u, im1.device)
            v_accum = v_accum + _as_image(v, im1.device)

        prev_shape = im1_work.shape[-2:]
        scale *= 2

    return u_accum, v_accum


class GenericPyramidalOpticalFlowWrapper:
    """OO wrapper holding driver parameters (``pyramid.py:191-220``)."""

    def __init__(
        self, algo_adapter, filter_sigma=0.0, pyr_levels=1, k_levels=1,
        filter_opt=None, optional_algo_adapter=None, warping=True, bi_linear=True,
        pyramidal_intermediate_scaling=True, pyramidal_scaling=False, device="cuda",
    ):
        self.algo_adapter = algo_adapter
        self.filter_sigma = filter_sigma
        self.pyr_levels = pyr_levels
        self.k_levels = k_levels
        self.filter_opt = filter_opt
        self.optional_algo_adapter = optional_algo_adapter
        self.warping = warping
        self.bi_linear = bi_linear
        self.pyramidal_intermediate_scaling = pyramidal_intermediate_scaling
        self.pyramidal_scaling = pyramidal_scaling
        self.device = device

    def calculateFlow(self, im1, im2):
        return generic_pyramidal_optical_flow(
            im1, im2, self.filter_sigma, self.algo_adapter,
            pyramidalLevels=self.pyr_levels, kLevels=self.k_levels,
            FILTER_OPT=self.filter_opt,
            optionalOFlowAlgoAdapter=self.optional_algo_adapter,
            warping=self.warping, biLinear=self.bi_linear,
            pyramidalIntermediateScaling=self.pyramidal_intermediate_scaling,
            pyramidalScaling=self.pyramidal_scaling, device=self.device,
        )
