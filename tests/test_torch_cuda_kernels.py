"""The port's Hopper kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import).  The machine with the card needs no JAX, so the
file does not use tests/conftest.py (which imports jax); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Built with -fmad=false, both kernels equal their plain versions bit for bit.
"""

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.configs import run_config
from opticalflow_ri_tpu_torch.ops.cuda import hs_iter, warp_tent
from opticalflow_ri_tpu_torch.ops.stencil import hs_derivatives
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

pytestmark = pytest.mark.cuda


def aee(u, v, u_ref, v_ref):
    return float(np.mean(np.hypot(u - u_ref, v - v_ref)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for sm_90a)")
    return torch.device("cuda")


def _rand(rng, shape, lo, hi, dev):
    return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=dev)


@pytest.mark.parametrize("shape", [(2, 2), (47, 61), (333, 517), (512, 512)])
@pytest.mark.parametrize("niter", [0, 1, 2, 45])
def test_hs_kernel_equals_plain(dev, shape, niter):
    rng = np.random.default_rng(0)
    fx, fy, ft = hs_derivatives(_rand(rng, shape, 0, 255, dev), _rand(rng, shape, 0, 255, dev))
    u0, v0 = _rand(rng, shape, -2, 2, dev), _rand(rng, shape, -2, 2, dev)
    before = hs_iter.hs_iterate.launches
    got = hs_iter.hs_iterate(fx, fy, ft, u0, v0, 21.0, niter)
    want = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, niter)
    torch.cuda.synchronize()
    assert hs_iter.hs_iterate.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(2, 3), (47, 61), (333, 517)])
@pytest.mark.parametrize("dmax", [4.0, 20.0])
def test_warp_kernel_equals_plain(dev, shape, dmax):
    rng = np.random.default_rng(1)
    args = [_rand(rng, shape, 0, 255, dev) for _ in range(2)]
    args += [_rand(rng, shape, -dmax, dmax, dev) for _ in range(4)]
    before = warp_tent.warp_pair.launches
    got = warp_tent.warp_pair(*args)
    want = warp_tent.warp_pair_plain(*args)
    torch.cuda.synchronize()
    assert warp_tent.warp_pair.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrappers_reject_bad_tensors(dev):
    z = torch.zeros((16, 16), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        hs_iter.hs_iterate(z, z, z, z.t(), z, 1.0, 1)
    with pytest.raises(TypeError, match="float32"):
        warp_tent.warp_pair(z, z, z, z, z, z.double())
    with pytest.raises(ValueError, match="at least 2x2"):
        one = torch.zeros((1, 16), device=dev)
        hs_iter.hs_iterate(one, one, one, one, one, 1.0, 1)


@pytest.mark.parametrize("name", ["HS_Fs3_4", "HS_Fs3_4_PyrLvls2", "PyHSchunck_Fs3_4_PyrLvls2"])
def test_pipeline_on_card_matches_cpu(dev, name):
    im1, im2, _, _ = particle_image_pair(shape=(96, 96), seed=3, max_disp=2.5)
    hs_before, warp_before = hs_iter.hs_iterate.launches, warp_tent.warp_pair.launches
    gu, gv = run_config(name, im1, im2, device=dev)
    cu, cv = run_config(name, im1, im2, device="cpu")
    assert hs_iter.hs_iterate.launches > hs_before
    assert (warp_tent.warp_pair.launches > warp_before) == name.endswith("PyrLvls2")
    assert aee(gu.cpu().numpy(), gv.cpu().numpy(), cu.numpy(), cv.numpy()) <= 5e-6
