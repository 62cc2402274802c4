"""Horn-Schunck Jacobi iterations: the Hopper kernel and its plain version.

``hs_iterate`` replaces both TPU kernels of the JAX package,
``ops/pallas/hs_iter.py:hs_iterate_pallas`` and
``ops/pallas/hs_tiled.py:hs_iterate_pallas_tiled``, with one CUDA kernel
(``csrc/hs_jacobi.cu``) for any H, W >= 2.  ``hs_iterate_plain`` is the same
iteration in PyTorch, in the XLA loop's operation order
(``models/horn_schunck.py:100-112``); CPU tensors take it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.stencil import hs_avg3x3

_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
)


def hs_iterate_plain(fx, fy, ft, u0, v0, alpha, niter: int):
    """``niter`` Jacobi iterations with the reciprocal 1/(α²+fx²+fy²) hoisted."""
    a = np.float32(alpha)
    rdenom = 1.0 / (float(a * a) + fx * fx + fy * fy)
    u, v = u0, v0
    for _ in range(int(niter)):
        u_avg = hs_avg3x3(u, "mirror")
        v_avg = hs_avg3x3(v, "mirror")
        der = (fx * u_avg + fy * v_avg + ft) * rdenom
        u, v = u_avg - fx * der, v_avg - fy * der
    return u, v


def hs_iterate(fx, fy, ft, u0, v0, alpha, niter: int):
    """Run ``niter`` HS Jacobi iterations; returns (u, v).

    Same (fx, fy, ft, u0, v0, alpha, niter) -> (u, v) contract as the TPU
    kernels.  CPU tensors run ``hs_iterate_plain``; CUDA tensors launch the
    kernel (one C call: the reciprocal pass, then ``niter`` step launches).
    """
    if fx.device.type == "cpu":
        return hs_iterate_plain(fx, fy, ft, u0, v0, alpha, niter)
    build.check_fields("hs_iterate", fx, fy, ft, u0, v0)
    h, w = fx.shape
    u_out, v_out, rd, u_tmp, v_tmp = (torch.empty((h, w), dtype=torch.float32, device=fx.device)
                                      for _ in range(5))
    entry = build.load_library().ofri_hs_iterate
    entry.argtypes = _ARGTYPES
    entry.restype = ctypes.c_int
    stream = torch.cuda.current_stream(fx.device).cuda_stream
    hs_iterate.launches += 1
    rc = entry(fx.data_ptr(), fy.data_ptr(), ft.data_ptr(), u0.data_ptr(), v0.data_ptr(),
               float(np.float32(alpha)), int(niter), h, w, rd.data_ptr(), u_out.data_ptr(),
               v_out.data_ptr(), u_tmp.data_ptr(), v_tmp.data_ptr(), fx.device.index or 0,
               stream)
    build.check(rc, "hs_iterate")
    return u_out, v_out


hs_iterate.launches = 0
