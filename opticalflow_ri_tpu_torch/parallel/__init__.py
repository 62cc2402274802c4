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

Not ported yet (ROADMAP.md, Queue 1, item 4): the LK and Farneback sharded
solves, ``context.py`` and the adapters' sharded branches, and
``auto_sharded_pipeline``'s GSPMD route.
"""

from opticalflow_ri_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from opticalflow_ri_tpu_torch.parallel.halo import exchange_halo
from opticalflow_ri_tpu_torch.parallel.sharded import (
    batched_hs_pipeline,
    hs_solve_sharded,
    liu_shen_solve_sharded,
)
from opticalflow_ri_tpu_torch.parallel.batch_stream import (
    batch_sharded_scan,
    batch_sharding,
)

__all__ = [
    "make_mesh", "mesh_shape_for", "exchange_halo",
    "hs_solve_sharded", "liu_shen_solve_sharded", "batched_hs_pipeline",
    "batch_sharded_scan", "batch_sharding",
]
