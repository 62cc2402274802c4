"""Sharded execution of whole configurations over a mesh (port of
``parallel/auto.py``).

    mesh = make_mesh(4)
    fn = auto_sharded_pipeline("PyHSchunck_Fs3_4_PyrLvls2", mesh)
    u, v = fn(im1_tile, im2_tile)      # this rank's ("y", "x") tiles

``auto_sharded_pipeline`` is the counterpart of the JAX package's
``jax.jit`` of the sharded pipeline (``parallel/auto.py:186`` there): on
CUDA tiles over NCCL it captures the rank's run in one CUDA graph per
(tile shape, device, mesh) and replays it (``compile.CompiledPipeline``),
so a pair is one graph launch a rank, with no host step between kernels.
CPU tiles run the eager function.  CUDA tiles on a gloo group raise
``ValueError``: gloo stages the slabs through host memory, which a capture
cannot hold; ``sharded_pipeline_fn``, the eager function, runs them.

Route 1, kernel-sharded: the single-level Horn-Schunck configurations run
the calibrated pre-filter and the HS solve on each rank's tile, the solve on
the Hopper kernel with one T-deep halo exchange per launch
(``sharded_kernel.py``).

Route 2, the sharded pyramid: every other configuration runs
``build_config(name).run`` on the rank's tiles inside
``context.kernel_sharded_solvers(mesh)``.  There the pyramid runs its glue
in tile form (``sharded_glue.py``: banded PIL resizes with an exchanged
apron, the dense spline upsample on gathers, K3's caller-padded warp, the
pre-filters with halos), and the four adapters run their kernel-sharded
solves (HS on the tiles; Liu-Shen, LK and Farneback on stripes gathered
along x).  The JAX package traces the same pyramid for GSPMD, which
partitions the glue and falls back to XLA per solve where a tile is
refused; the port has no partitioner, so a level or tile that does not
split or that a solve refuses raises ``ValueError``.  Nothing gathers the
image onto one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from opticalflow_ri_tpu_torch.compile import CompiledPipeline, _device_of
from opticalflow_ri_tpu_torch.configs import base_name
from opticalflow_ri_tpu_torch.parallel.mesh import axis_group, axis_size

# single-level Horn-Schunck configs: pipeline == calibrated prefilter + one
# HS solve, exactly what the kernel-sharded step implements; a calibrated
# name (``configs.build_config``) routes as its base config
HS_SINGLE_LEVEL = {"PyHSchunck_Fs3_4", "HS_Fs3_4", "HS_Fs0_0"}


def hs_kernel_sharded_eligible(name: str, mesh, shape):
    """T-block when ``auto_sharded_pipeline`` takes route 1 for ``name`` at
    the global ``shape``; None otherwise."""
    if base_name(name) not in HS_SINGLE_LEVEL:
        return None
    from opticalflow_ri_tpu_torch.parallel.sharded_kernel import pick_hs_shard_t

    return pick_hs_shard_t(mesh, shape)


def _hs_config_kernel_sharded(name: str, mesh):
    """(im1, im2) -> (U, V) on this rank's ("y", "x") tiles for a
    single-level HS config: the local calibrated prefilter, then the
    kernel-sharded HS solve from zero flow (the reference pipeline at
    pyramidalLevels=1)."""
    from opticalflow_ri_tpu_torch.configs import build_config
    from opticalflow_ri_tpu_torch.parallel.sharded_glue import prefilter_sharded
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
            a = prefilter_sharded(a, sigma, 3, mesh)
            b = prefilter_sharded(b, sigma, 3, mesh)
        z = torch.zeros_like(a)
        u, v, _ = _hs_body_shardkernel(a, b, z, z, mesh, alpha=alpha, niter=niter, t_block=t)
        return u, v

    return sharded


def _pyramid_sharded(name: str, mesh):
    """Route 2: (im1, im2) -> (U, V) on this rank's ("y", "x") tiles, the
    whole configuration run inside ``kernel_sharded_solvers(mesh)``."""
    from opticalflow_ri_tpu_torch.configs import build_config
    from opticalflow_ri_tpu_torch.parallel.context import kernel_sharded_solvers

    cfg = build_config(name)

    def sharded(im1, im2):
        with kernel_sharded_solvers(mesh):
            return cfg.run(im1.to(torch.float32), im2.to(torch.float32))

    return sharded


def sharded_pipeline_fn(name: str, mesh):
    """(im1, im2) -> (U, V) on this rank's ("y", "x") tiles, run eagerly:
    route 1 for the single-level HS configs, route 2 for every other (the
    module docstring).  The counterpart of ``compile.pipeline_fn``, and the
    one sharded entry that runs CUDA tiles on a gloo group."""
    if base_name(name) in HS_SINGLE_LEVEL:
        return _hs_config_kernel_sharded(name, mesh)
    return _pyramid_sharded(name, mesh)


class ShardedPipeline(CompiledPipeline):
    """``auto_sharded_pipeline(name, mesh)`` on more than one rank (or
    forced): ``fn(im1, im2) -> (U, V)`` on this rank's tiles, a replay of
    the graph of their shape on CUDA tiles over NCCL, the eager function on
    CPU tiles.  Every rank of the mesh calls it with tiles of one shape.
    ``release()`` frees the graphs."""

    def __init__(self, name: str, mesh):
        fn = sharded_pipeline_fn(name, mesh)

        def run(im1, im2, device):
            return fn(torch.as_tensor(im1, device=device), torch.as_tensor(im2, device=device))

        super().__init__(name, run)
        self.mesh = mesh

    def _check(self, im1, device):
        if _device_of(im1, device).type == "cuda" and any(
                dist.get_backend(axis_group(self.mesh, a)) == "gloo" for a in ("y", "x")):
            raise ValueError(
                f"auto_sharded_pipeline({self.name!r}) captures CUDA graphs, which cannot hold "
                f"gloo's staging of CUDA tiles through host memory: on a gloo group run the "
                f"eager parallel.auto.sharded_pipeline_fn({self.name!r}, mesh)")

    def replay(self, im1, im2, device="cuda"):
        self._check(im1, device)
        return super().replay(im1, im2, device)

    def warm_up(self, im1, im2, device="cuda") -> None:
        self._check(im1, device)
        super().warm_up(im1, im2, device)


def auto_sharded_pipeline(name: str, mesh, batch: bool = False, _force_sharded: bool = False):
    """(im1, im2) -> (U, V) running SPMD over ``mesh`` on this rank's tiles.

    A one-rank mesh returns the plain ``compile.compiled_pipeline(name)``
    (``scan_pipeline`` with ``batch=True``): there is nothing to decompose
    (``_force_sharded=True`` takes the sharded route anyway, for
    measurement).  Otherwise a ``ShardedPipeline``: the single-level HS
    configs take route 1 and every other config route 2 (the module
    docstring), one CUDA graph per tile shape on NCCL, eager on CPU tiles;
    CUDA tiles on gloo raise (``sharded_pipeline_fn`` runs them).  Keep
    the returned object: its graphs live in it.  ``batch=True`` (JAX's
    vmapped GSPMD route) raises ``NotImplementedError`` on more than one
    rank: ``batch_sharded_scan`` is the campaign construct."""
    if mesh.size() == 1 and not _force_sharded:
        from opticalflow_ri_tpu_torch.compile import compiled_pipeline, scan_pipeline

        return scan_pipeline(name) if batch else compiled_pipeline(name)
    if batch:
        raise NotImplementedError(
            f"auto_sharded_pipeline({name!r}, batch=True) on a mesh: the JAX package vmaps its "
            f"GSPMD route, which has no counterpart here; for campaigns of pairs use "
            f"parallel.batch_sharded_scan")
    return ShardedPipeline(name, mesh)
