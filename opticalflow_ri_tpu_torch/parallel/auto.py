"""Sharded execution of whole configurations over a mesh (port of route 1 of
``parallel/auto.py``).

Route 1, kernel-sharded: the single-level Horn-Schunck configurations run
the calibrated pre-filter and the HS solve on each rank's tile, the solve on
the Hopper kernel with one T-deep halo exchange per launch
(``sharded_kernel.py``).

    mesh = make_mesh(4)
    fn = auto_sharded_pipeline("PyHSchunck_Fs3_4", mesh)
    u, v = fn(im1_tile, im2_tile)      # this rank's ("y", "x") tiles

Route 2 of the JAX package traces any other configuration with GSPMD, which
partitions the pyramid's resize, warp and pre-filter ops across the mesh.
PyTorch has no counterpart of that partitioner, so on a mesh of more than
one rank those configurations raise ``NotImplementedError`` (ROADMAP.md,
Queue 1, item 4); nothing else runs in their place.
"""

from __future__ import annotations

import torch

from opticalflow_ri_tpu_torch.parallel.mesh import axis_size

# single-level Horn-Schunck configs: pipeline == calibrated prefilter + one
# HS solve, exactly what the kernel-sharded step implements
_HS_SINGLE_LEVEL = {"PyHSchunck_Fs3_4", "HS_Fs3_4", "HS_Fs0_0"}


def hs_kernel_sharded_eligible(name: str, mesh, shape):
    """T-block when ``auto_sharded_pipeline`` takes route 1 for ``name`` at
    the global ``shape``; None otherwise."""
    if name not in _HS_SINGLE_LEVEL:
        return None
    from opticalflow_ri_tpu_torch.parallel.sharded_kernel import pick_hs_shard_t

    return pick_hs_shard_t(mesh, shape)


def _hs_config_kernel_sharded(name: str, mesh):
    """(im1, im2) -> (U, V) on this rank's ("y", "x") tiles for a
    single-level HS config: the local calibrated prefilter, then the
    kernel-sharded HS solve from zero flow (the reference pipeline at
    pyramidalLevels=1)."""
    from opticalflow_ri_tpu_torch.configs import build_config
    from opticalflow_ri_tpu_torch.parallel.sharded import _prefilter_local
    from opticalflow_ri_tpu_torch.parallel.sharded_kernel import _hs_body_shardkernel

    cfg = build_config(name)
    adapter = cfg.main()
    alpha = float(adapter.alphas[-1])
    niter = adapter.Niter
    sigma = cfg.filter_sigma

    def sharded(im1, im2):
        a, b = im1.to(torch.float32), im2.to(torch.float32)
        shape = (a.shape[-2] * axis_size(mesh, "y"), a.shape[-1] * axis_size(mesh, "x"))
        t = hs_kernel_sharded_eligible(name, mesh, shape)
        if t is None:
            raise ValueError(f"{name}: tiles {tuple(a.shape)} of {shape} are too small for the "
                             f"kernel-sharded solve")
        if sigma > 1e-3:
            a = _prefilter_local(a, sigma, 3, mesh)
            b = _prefilter_local(b, sigma, 3, mesh)
        z = torch.zeros_like(a)
        u, v, _ = _hs_body_shardkernel(a, b, z, z, mesh, alpha=alpha, niter=niter, t_block=t)
        return u, v

    return sharded


def auto_sharded_pipeline(name: str, mesh, batch: bool = False, _force_sharded: bool = False):
    """(im1, im2) -> (U, V) running SPMD over ``mesh`` on this rank's tiles.

    A one-rank mesh returns the plain ``compile.compiled_pipeline(name)``
    (``scan_pipeline`` with ``batch=True``): there is nothing to decompose
    (``_force_sharded=True`` takes route 1 anyway, for measurement).
    Otherwise the single-level HS configs take route 1; any other config,
    and ``batch=True`` (JAX's vmapped GSPMD route; ``batch_sharded_scan``
    is the campaign construct), raise ``NotImplementedError``."""
    if mesh.size() == 1 and not _force_sharded:
        from opticalflow_ri_tpu_torch.compile import compiled_pipeline, scan_pipeline

        return scan_pipeline(name) if batch else compiled_pipeline(name)
    if batch or name not in _HS_SINGLE_LEVEL:
        raise NotImplementedError(
            f"auto_sharded_pipeline({name!r}, batch={batch}) needs the JAX package's GSPMD route "
            f"(route 2), which the port has not got: see ROADMAP.md, Queue 1, item 4 (for "
            f"campaigns of pairs use parallel.batch_sharded_scan)")
    return _hs_config_kernel_sharded(name, mesh)
