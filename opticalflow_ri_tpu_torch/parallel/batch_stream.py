"""Multi-rank campaign streaming: each rank runs ``compile.scan_pipeline`` on
its slice of the pairs (port of ``parallel/batch_stream.py``).

The real workload is sequences of image pairs.  Each rank runs the
single-device streaming construct -- ``compile.scan_pipeline``, one CUDA
graph replay a pair -- on its own (K/N, H, W) slice of the campaign, with
zero collectives: the batch axis is embarrassingly parallel, so there is no
halo to exchange and each rank's numerics are the single-device stream's,
bit for bit.

    mesh = make_mesh(4, batch=4)                  # ("batch", "y", "x") = (4, 1, 1)
    take = batch_sharding(mesh)
    fn = batch_sharded_scan("PyHSchunck_Fs3_4", mesh)
    us, vs = fn(take(im1_stack), take(im2_stack))  # this rank's (K/4, H, W)

``FlowBatchRunner(..., mesh=mesh)`` drives whole campaigns through this
construct (harness/batch_runner.py).
"""

from __future__ import annotations

from opticalflow_ri_tpu_torch.parallel.distributed import local_slices


def batch_spec() -> tuple:
    """Partition spec of a (K, H, W) campaign stack: the leading axis over
    the mesh 'batch' axis, images whole on each rank."""
    return ("batch", None, None)


def batch_sharding(mesh):
    """``take(stack) -> stack[rows]``: this rank's slice of a (K, H, W)
    stack (K a multiple of the batch axis; a view, no copy)."""
    def take(stack):
        return stack[local_slices(mesh, tuple(stack.shape), batch_spec())]

    return take


def batch_sharded_scan(name: str, mesh):
    """(im1s, im2s) -> (us, vs) over this rank's (K/N, H, W) slices
    (``batch_sharding(mesh)``): ``compile.scan_pipeline(name)`` itself, on
    any mesh.  In JAX the function takes the global stack and a shard_map
    over ``mesh`` splits it; here each rank holds its own slice and the
    batch axis needs no collective, so the single-device scan is the whole
    per-rank program (JAX's 1-way shortcut, on every batch axis)."""
    from opticalflow_ri_tpu_torch.compile import scan_pipeline

    return scan_pipeline(name)
