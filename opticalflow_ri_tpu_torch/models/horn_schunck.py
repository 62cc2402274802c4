"""Horn-Schunck global-smoothness optical flow (port of ``models/horn_schunck.py``).

The Jacobi relaxation runs in the Hopper kernel ``ops/cuda/hs_iter.py:
hs_iterate`` for CUDA tensors and in its plain PyTorch version for CPU
tensors.  Parity notes carried over from the JAX package:
  * the derivative stencils and the reference's frame-role swap are folded
    into ``ops.stencil.hs_derivatives``;
  * the denominator alpha^2 + fx^2 + fy^2 is hoisted as a reciprocal;
  * the returned error is the normalised Frobenius delta between the final
    flow and the *input* flow;
  * the adapter keeps the reference's stateful alpha-list pop — one alpha per
    compute() call, last entry first, so the coarsest pyramid level receives
    the final list entry.

While ``parallel.context.kernel_sharded_solvers(mesh)`` is active the
adapter takes this rank's ("y", "x") tiles and solves on the kernel-sharded
path (``parallel/sharded_kernel.py:hs_solve_sharded_kernel``); a tile that
path refuses raises ``ValueError`` (no single-device fallback).
"""

from __future__ import annotations

import torch

from opticalflow_ri_tpu_torch.ops.cuda import hs_iter
from opticalflow_ri_tpu_torch.ops.stencil import hs_derivatives


def hs_solve(im1, im2, alpha, niter: int, u0, v0):
    """Run ``niter`` Jacobi iterations; returns (U, V, error).

    ``im1``/``im2`` are the frames at t=0/t=1 (driver order).  ``error`` is a
    0-d tensor on the flow's device: reading it on the host would wait for
    the device, so the driver only logs it.
    """
    im1 = im1.to(torch.float32)
    im2 = im2.to(torch.float32)
    u0 = u0.to(torch.float32).contiguous()
    v0 = v0.to(torch.float32).contiguous()

    fx, fy, ft = hs_derivatives(im1, im2)
    u, v = hs_iter.hs_iterate(fx, fy, ft, u0, v0, alpha, niter)

    npix = im1.shape[-2] * im1.shape[-1]
    err = (torch.linalg.norm(u - u0) + torch.linalg.norm(v - v0)) / float(npix)
    return u, v, err


class HSOpticalFlowAlgoAdapter:
    """Driver adapter with the reference's protocol and alpha-list state."""

    def __init__(self, alphas, Niter: int, provideGenericPyramidalDefaults: bool = True):
        self.provideGenericPyramidalDefaults = provideGenericPyramidalDefaults
        self.alphas = list(alphas)
        self.Niter = int(Niter)

    def compute(self, im1, im2, U, V):
        alpha = self.alphas.pop()
        from opticalflow_ri_tpu_torch.parallel.context import current_kernel_shard

        mesh = current_kernel_shard()
        if mesh is None:
            return hs_solve(im1, im2, float(alpha), self.Niter, U, V)
        from opticalflow_ri_tpu_torch.parallel import sharded_kernel as sk

        return sk.hs_solve_sharded_kernel(mesh, im1, im2, float(alpha), self.Niter, U, V)

    def getAlgoName(self):
        return "Horn-Schunck"

    def hasGenericPyramidalDefaults(self):
        return self.provideGenericPyramidalDefaults

    def getGenericPyramidalDefaults(self):
        return {"warping": True, "biLinear": True, "scaling": True}
