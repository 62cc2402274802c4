"""The PyTorch port's Horn-Schunck solve against the JAX package: the plain
version of the Hopper HS kernel against both TPU kernels run in Pallas
interpret mode, and ``hs_solve`` against the XLA loop (atol 1e-5, the bar of
tests/test_pallas_kernels.py)."""

from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

from opticalflow_ri_tpu.models import horn_schunck as jhs
from opticalflow_ri_tpu.ops.pallas import hs_iter as jk
from opticalflow_ri_tpu.ops.pallas.hs_tiled import hs_iterate_pallas_tiled
from opticalflow_ri_tpu.ops.stencil import hs_derivatives as j_hs_derivatives

from opticalflow_ri_tpu_torch.models import horn_schunck as ths
from opticalflow_ri_tpu_torch.ops.cuda import hs_iter as tk

ATOL = 1e-5


def _fields(shape, seed, nonzero_init):
    rng = np.random.default_rng(seed)
    d1 = rng.uniform(0, 255, shape).astype(np.float32)
    d2 = rng.uniform(0, 255, shape).astype(np.float32)
    if nonzero_init:
        u0 = rng.uniform(-2, 2, shape).astype(np.float32)
        v0 = rng.uniform(-2, 2, shape).astype(np.float32)
    else:
        u0 = v0 = np.zeros(shape, np.float32)
    return d1, d2, u0, v0


def _plain(d1, d2, u0, v0, alpha, niter):
    from opticalflow_ri_tpu_torch.ops.stencil import hs_derivatives

    fx, fy, ft = hs_derivatives(torch.from_numpy(d1), torch.from_numpy(d2))
    u, v = tk.hs_iterate(fx, fy, ft, torch.from_numpy(u0), torch.from_numpy(v0), alpha, niter)
    return u.numpy(), v.numpy()


@pytest.mark.parametrize("nonzero_init", [False, True])
def test_plain_matches_whole_state_kernel_interpret(nonzero_init):
    d1, d2, u0, v0 = _fields((64, 128), 0, nonzero_init)
    fx, fy, ft = j_hs_derivatives(jnp.asarray(d1), jnp.asarray(d2))
    uk, vk = pl.pallas_call(
        partial(jk._hs_kernel, niter=10),
        out_shape=(jax.ShapeDtypeStruct((64, 128), jnp.float32),) * 2,
        interpret=True,
    )(jnp.float32(21.0).reshape(1, 1), fx, fy, ft, jnp.asarray(u0), jnp.asarray(v0))
    up, vp = _plain(d1, d2, u0, v0, 21.0, 10)
    np.testing.assert_allclose(up, np.asarray(uk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(vp, np.asarray(vk), rtol=0, atol=ATOL)


def test_plain_matches_tiled_kernel_interpret():
    """45 iterations = two full T=20 blocks plus a remainder block of 5."""
    d1, d2, u0, v0 = _fields((128, 256), 1, True)
    fx, fy, ft = j_hs_derivatives(jnp.asarray(d1), jnp.asarray(d2))
    uk, vk = hs_iterate_pallas_tiled(fx, fy, ft, jnp.asarray(u0), jnp.asarray(v0), 21.0, 45,
                                     interpret=True)
    up, vp = _plain(d1, d2, u0, v0, 21.0, 45)
    np.testing.assert_allclose(up, np.asarray(uk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(vp, np.asarray(vk), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,alpha,niter", [((47, 61), 21.0, 100), ((47, 61), 1.0, 7),
                                               ((2, 2), 3.0, 5), ((96, 96), 45.0, 0)])
def test_hs_solve_matches_xla(shape, alpha, niter):
    d1, d2, u0, v0 = _fields(shape, 2, True)
    uj, vj, ej = jhs.hs_solve(jnp.asarray(d1), jnp.asarray(d2), alpha, niter,
                              jnp.asarray(u0), jnp.asarray(v0), impl="xla")
    ut, vt, et = ths.hs_solve(torch.from_numpy(d1), torch.from_numpy(d2), alpha, niter,
                              torch.from_numpy(u0), torch.from_numpy(v0))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=ATOL)
    assert et.dim() == 0
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-5, atol=1e-9)


def test_adapter_pops_alphas_last_first():
    d1, d2, u0, v0 = _fields((47, 61), 3, False)
    t_ad = ths.HSOpticalFlowAlgoAdapter([21.0, 45.0], 20)
    j_ad = jhs.HSOpticalFlowAlgoAdapter([21.0, 45.0], 20, impl="xla")
    for expected_left in ([21.0], []):
        ut, vt, _ = t_ad.compute(torch.from_numpy(d1), torch.from_numpy(d2),
                                 torch.from_numpy(u0), torch.from_numpy(v0))
        uj, vj, _ = j_ad.compute(d1, d2, u0, v0)
        assert t_ad.alphas == j_ad.alphas == expected_left
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=ATOL)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=ATOL)
    with pytest.raises(IndexError):
        t_ad.compute(torch.from_numpy(d1), torch.from_numpy(d2),
                     torch.from_numpy(u0), torch.from_numpy(v0))
    assert t_ad.getAlgoName() == "Horn-Schunck"
    assert t_ad.hasGenericPyramidalDefaults()
    assert t_ad.getGenericPyramidalDefaults() == {"warping": True, "biLinear": True,
                                                  "scaling": True}


def test_cpu_tensors_take_the_plain_version_without_counting():
    d1, d2, u0, v0 = _fields((8, 9), 4, True)
    before = tk.hs_iterate.launches
    fx, fy, ft = (torch.from_numpy(a) for a in (d1, d2, u0))
    got = tk.hs_iterate(fx, fy, ft, torch.from_numpy(u0), torch.from_numpy(v0), 2.0, 3)
    want = tk.hs_iterate_plain(fx, fy, ft, torch.from_numpy(u0), torch.from_numpy(v0), 2.0, 3)
    assert tk.hs_iterate.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_non_cpu_non_cuda_tensor_raises():
    z = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.hs_iterate(z, z, z, z, z, 1.0, 1)
