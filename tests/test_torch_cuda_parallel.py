"""The port's multi-GPU layer on the card: a one-rank NCCL process group in
this process.

Marked ``cuda``; skips without a CUDA device.  Run on the machine with the
card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_parallel.py -q

On one rank every side of the tile is the image's border, so the kernel
paths run the single-device kernels on the whole image in T-iteration
launches: their u, v equal the single-device port's bit for bit, and err
agrees to 1e-6 relative.  (Four ranks on one card, over gloo with the halos
staged through host memory, are driven by ``chip_smoke.py``'s parallel
phase.)
"""

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.configs import run_config
from opticalflow_ri_tpu_torch.models.horn_schunck import hs_solve
from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
from opticalflow_ri_tpu_torch.ops.cuda import hs_iter, liu_shen_iter
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from opticalflow_ri_tpu_torch.parallel import distributed, make_mesh

    rdv = tmp_path_factory.mktemp("nccl") / "rendezvous"
    distributed.initialize(f"file://{rdv}", 1, 0)
    assert dist.get_backend() == "nccl"
    distributed.initialize()  # a no-op
    yield make_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def pair():
    return [torch.as_tensor(im, device="cuda")
            for im in particle_image_pair(shape=(333, 517), seed=0)[:2]]


def test_hs_solve_sharded_kernel_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.parallel import hs_solve_sharded

    z = torch.zeros_like(pair[0])
    before = hs_iter.hs_iterate.launches
    u, v, err = hs_solve_sharded(nccl_mesh, *pair, 21.0, 45, z, z)
    assert hs_iter.hs_iterate.launches - before == -(-45 // hs_iter.STEPS_PER_LAUNCH)
    ur, vr, er = hs_solve(*pair, 21.0, 45, z, z)
    assert torch.equal(u, ur) and torch.equal(v, vr)
    np.testing.assert_allclose(float(err), float(er), rtol=1e-6)


def test_liu_shen_solve_sharded_kernel_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.parallel import liu_shen_solve_sharded

    z = torch.zeros_like(pair[0])
    u, v, err = liu_shen_solve_sharded(nccl_mesh, *pair, 10.0, z, z, max_iter=60, tol=0.0)
    a, b = pair
    fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
    ur, vr, er, k = liu_shen_iter.liu_shen_iterate(10.0, fields, z, z, 60, 0.0)
    assert int(k) == 60
    assert torch.equal(u, ur) and torch.equal(v, vr)
    np.testing.assert_allclose(float(err), float(er), rtol=1e-6)


def test_auto_route1_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.compile import compiled_pipeline
    from opticalflow_ri_tpu_torch.parallel.auto import auto_sharded_pipeline

    assert auto_sharded_pipeline("HS_Fs3_4", nccl_mesh) is compiled_pipeline("HS_Fs3_4")
    u, v = auto_sharded_pipeline("HS_Fs3_4", nccl_mesh, _force_sharded=True)(*pair)
    ur, vr = run_config("HS_Fs3_4", *pair)
    assert torch.equal(u, ur) and torch.equal(v, vr)


def test_batched_pipeline_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.ops.gaussian import gaussian_filter_px
    from opticalflow_ri_tpu_torch.parallel import batched_hs_pipeline

    s1, s2 = (torch.stack([x, 0.5 * x]) for x in pair)
    u, v, err = batched_hs_pipeline(nccl_mesh, s1, s2, niter=20)
    for k in range(2):
        f = [gaussian_filter_px(s[k], 3.4, 3) for s in (s1, s2)]
        z = torch.zeros_like(f[0])
        ur, vr, er = hs_solve(*f, 21.0, 20, z, z)
        assert torch.equal(u[k], ur) and torch.equal(v[k], vr)
        np.testing.assert_allclose(float(err[k]), float(er), rtol=1e-6)


def test_gather_global_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.parallel import distributed

    g = distributed.gather_global(nccl_mesh, pair[0], ("y", "x"))
    assert torch.equal(g, pair[0])
