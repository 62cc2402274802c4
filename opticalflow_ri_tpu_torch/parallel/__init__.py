"""Multi-GPU execution: process-group meshes, halo exchange, sharded solvers
(port of ``parallel/``).

The JAX package runs one controller over a ``Mesh`` of devices; the port
runs one process per GPU in a ``torch.distributed`` process group (NCCL on
the card, gloo on the CPU), and every function here takes and returns the
rank's LOCAL tiles:

  * spatial decomposition: a 2-D (y, x) mesh over image tiles with
    neighbour halo exchange (``exchange_halo``), one per iteration in the
    plain bodies and one per kernel launch on the Hopper kernels;
  * batch data parallelism over image pairs (the ``batch`` mesh axis);
  * global reductions (error norms, image maxima) as all-reduces;
  * entry points: ``distributed.initialize`` (torchrun's environment) and
    ``make_mesh``.

  * rows-sharded dense LK and Farneback on their kernels' sharded modes
    (``lk_solve_sharded_kernel``, ``farneback_solve_sharded``, every level
    of the Farneback pyramid);
  * the sharded pyramid: ``kernel_sharded_solvers(mesh)`` (``context.py``)
    makes the pyramid run its glue on tiles (``sharded_glue.py``) and the
    four adapters their kernel-sharded solves; ``sharded_pipeline_fn``
    runs every configuration that way eagerly (route 2), the single-level
    HS ones on route 1, and ``auto_sharded_pipeline`` replays it as one
    CUDA graph per tile shape on NCCL (``auto.py``).  The pyramid's
    ``biLinear=False`` warp has a tile form too
    (``sharded_glue.liu_shen_warp_sharded``): ``generic_pyramidal_optical_flow
    (..., biLinear=False)`` under the context runs on tiles, eagerly or
    through ``compile.CompiledPipeline`` as one CUDA graph a tile shape.
"""

from opticalflow_ri_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from opticalflow_ri_tpu_torch.parallel.context import (
    current_kernel_shard,
    kernel_sharded_solvers,
)
from opticalflow_ri_tpu_torch.parallel.halo import exchange_halo, gather_axis
from opticalflow_ri_tpu_torch.parallel.sharded import (
    batched_hs_pipeline,
    hs_solve_sharded,
    liu_shen_solve_sharded,
)
from opticalflow_ri_tpu_torch.parallel.sharded_kernel import (
    farneback_iterate_sharded,
    farneback_solve_sharded,
    fb_shard_supported,
    lk_solve_sharded_kernel,
    pick_lk_shard_stripe,
)
from opticalflow_ri_tpu_torch.parallel.batch_stream import (
    batch_sharded_scan,
    batch_sharding,
)
from opticalflow_ri_tpu_torch.parallel.auto import auto_sharded_pipeline, sharded_pipeline_fn

__all__ = [
    "make_mesh", "mesh_shape_for", "exchange_halo", "gather_axis",
    "kernel_sharded_solvers", "current_kernel_shard",
    "hs_solve_sharded", "liu_shen_solve_sharded", "batched_hs_pipeline",
    "lk_solve_sharded_kernel", "pick_lk_shard_stripe",
    "farneback_solve_sharded", "farneback_iterate_sharded", "fb_shard_supported",
    "batch_sharded_scan", "batch_sharding",
    "auto_sharded_pipeline", "sharded_pipeline_fn",
]
